"""The arithmetic of kernels 4 (csrc/stgcn_train_bwd.cu) and 5
(csrc/stgcn_sparse.cu), emulated on the CPU in each kernel's own order.

Both form their products on the tensor cores in 3xTF32 with the rules of
csrc/tconv_mma.cuh, which tests/test_torch_tconv_3xtf32.py emulates
(``split``, ``kstep_accumulate``: three products per k-step of 8 in a fresh
fragment, folded into the f32 accumulator).  Here:

* kernel 4: dt1 is that file's conv core on dy2 with the transposed taps in
  reverse order; the tap gradient is a GEMM with K over the rows of each
  128-row tile, one k-step per 8 rows, summed per block of the persistent
  grid over the tiles the block walks, then the blocks' partials in order.
  Held against ``tconv_bwd_ref`` within 2e-7 of sum |a*b|, and one fused
  train layer's backward with it against the JAX train layer;
* kernel 5: each output column tile's list of nonzero tiles in k-steps of
  8, cut into chunks (split-K) whose partials are summed in chunk order,
  then BN1 and ReLU.  Held against ``sparse_graph_matmul_bn_relu_ref``, and
  the SMALL sparse ``generate`` with it against the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose2room_tpu.models import P2RNet as JaxP2RNet
from pose2room_tpu.ops import stgcn_train as jax_train
from pose2room_tpu_torch.models import stgcn as port_stgcn
from pose2room_tpu_torch.models.graph import SPARSE_JOINT_ORDER, build_spatial_graph
from pose2room_tpu_torch.ops import stgcn_fused, stgcn_sparse, stgcn_train
from test_torch_tconv_3xtf32 import emulated_kernel_tconv, kstep_accumulate
from test_torch_train_layer import NAMES, _layer_args
from torch_port_util import SMALL, assert_generate_close, flax_payload, jax_model, port_model, to_numpy, walking_clip

ROWS = 128  # rows of a tile (tconv_mma.cuh: kRows)
C = 64


# ---------------------------------------------------------------------------
# kernel 4
# ---------------------------------------------------------------------------

def bwd_grid(B, T, Wp, slots):
    """tconv_mma.cuh:grid_size."""
    items = (Wp // C // 2) * B * -(-T // ROWS)
    return 2 * min(items, max(slots // 2, 1))


def block_tiles(block, blocks, B, T, Wp):
    """(col0, clip, t0) of each tile a block walks, in order (tconv_mma.cuh:tile_at)."""
    n_tiles = -(-T // ROWS)
    per_column = B * n_tiles
    for item in range(block >> 1, (Wp // C // 2) * per_column, blocks // 2):
        f = item % per_column
        yield (2 * (item // per_column) + (block & 1)) * C, f // n_tiles, (f % n_tiles) * ROWS


def emulated_kernel4(dy2, y, vecs, KBT, T, slots):
    """(dpre, parts (B, 2, Wp), dtaps (3, C, C)) of kernel 4 on a card with
    ``slots`` resident blocks, numpy f32 operands."""
    N, Wp = y.shape
    B = N // T
    t1 = np.maximum(y * vecs[0] + vecs[1], np.float32(0))  # f32 product, then sum
    dt1 = np.concatenate([emulated_kernel_tconv(dy2[b * T:(b + 1) * T], KBT[::-1]) for b in range(B)])
    dpre = np.where(t1 > 0, dt1, np.float32(0))
    parts = np.stack([dpre.reshape(B, T, Wp).sum(1), (dpre * y).reshape(B, T, Wp).sum(1)], axis=1)
    blocks = bwd_grid(B, T, Wp, slots)
    dtaps = None
    for block in range(blocks):
        acc = np.zeros((3, C, C), np.float32)
        for col0, b, t0 in block_tiles(block, blocks, B, T, Wp):
            clip = slice(b * T, (b + 1) * T)
            # tc[t + 1] = t1[t]: the t-1 / t+1 halo and the rows past the clip are 0
            tc = np.zeros((T + 2 + ROWS, C), np.float32)
            tc[1:T + 1] = t1[clip, col0:col0 + C]
            dc = np.zeros((T + ROWS, C), np.float32)
            dc[:T] = dy2[clip, col0:col0 + C]
            for r in range(t0, t0 + min(ROWS, -(-(T - t0) // 8) * 8), 8):
                a = np.stack([tc[r + s:r + s + 8].T for s in range(3)])  # t1[t + s - 1]^T, (3, C, 8)
                acc = kstep_accumulate(acc, a, dc[r:r + 8])
        dtaps = acc if dtaps is None else (dtaps + acc).astype(np.float32)
    return dpre, parts.astype(np.float32), dtaps


def _bwd_operands(rng, B, T, W0):
    Wp = stgcn_fused.pad_merged(W0)
    y = np.zeros((B * T, Wp), np.float32)
    y[:, :W0] = rng.randn(B * T, W0) * 0.7
    dy2 = np.zeros((B * T, Wp), np.float32)
    dy2[:, :W0] = rng.randn(B * T, W0) * 0.5
    vecs = np.zeros((4, Wp), np.float32)
    vecs[0, :W0] = 0.5 + rng.rand(W0)
    vecs[1, :W0] = rng.randn(W0) * 0.3
    taps = torch.from_numpy((rng.randn(3, C, C) * 0.15).astype(np.float32))
    KBT = stgcn_fused.block_diag_taps(taps).transpose(1, 2).contiguous().numpy()
    return dy2, y, vecs, KBT


@pytest.mark.parametrize("slots", [4, 132])
def test_emulated_kernel4_within_2e7_of_plain(rng, slots):
    """T = 200: a full and a partial 128-row tile per clip.  slots = 4:
    each block walks six tiles; 132: one tile each."""
    B, T, W0 = 2, 200, 320
    dy2, y, vecs, KBT = _bwd_operands(rng, B, T, W0)
    dpre, parts, dtaps = emulated_kernel4(dy2, y, vecs, KBT, T, slots)
    ref = stgcn_train.tconv_bwd(*(torch.from_numpy(a) for a in (dy2, y, vecs, KBT)), T=T, C=C)
    dpre_ref, parts_ref, dtaps_ref = (r.numpy() for r in ref)

    # dt1's sum |a*b|: the conv of |dy2| with |KBT| (tap s reads row t + 1 - s)
    d3 = torch.from_numpy(np.abs(dy2)).double().reshape(B, T, -1)
    Ka = torch.from_numpy(np.abs(KBT)).double()
    mag = (stgcn_fused.tconv_group(stgcn_fused.shift_next(d3), Ka[0]) + stgcn_fused.tconv_group(d3, Ka[1])
           + stgcn_fused.tconv_group(stgcn_fused.shift_prev(d3), Ka[2])).reshape(B * T, -1).numpy()
    live = dpre_ref != 0
    assert np.array_equal(dpre != 0, live)  # the same ReLU mask
    assert np.max(np.abs(dpre - dpre_ref)[live] / mag[live]) <= 2e-7
    assert np.all(dpre[:, W0:] == 0) and np.all(parts[..., W0:] == 0)
    np.testing.assert_allclose(parts, parts_ref, atol=1e-4, rtol=1e-5)

    # the tap gradient's sum |a*b|, folded over clips and joints
    t1 = np.abs(np.maximum(y * vecs[0] + vecs[1], 0)).astype(np.float64).reshape(B, T, -1)
    t1 = t1[..., :W0].reshape(B, T, -1, C)
    dg = np.abs(dy2).astype(np.float64)[:, :W0].reshape(B, T, -1, C)
    zero = np.zeros_like(t1[:, :1])
    shifted = [np.concatenate([zero, t1[:, :-1]], 1), t1, np.concatenate([t1[:, 1:], zero], 1)]
    gmag = np.stack([np.einsum("btji,btjo->io", h, dg) for h in shifted])
    assert np.max(np.abs(dtaps - dtaps_ref) / gmag) <= 2e-7


def test_train_layer_backward_with_emulated_kernel4_matches_jax(monkeypatch):
    """One fused train layer (residual) whose backward runs kernel 4's
    emulated arithmetic, against jax.grad of the JAX train layer, in the
    bands of tests/test_torch_train_layer.py."""
    V, T, B, Wp = 5, 16, 2, 384
    args = _layer_args(11, True)
    w = np.random.RandomState(20).randn(B, T, Wp).astype(np.float32)
    layer = jax_train.make_train_layer(True, V, C, T, dtype="float32")
    jargs = [jnp.asarray(a) for a in args]
    outs_j = [np.asarray(o) for o in layer(*jargs)]
    grads_j = jax.grad(lambda *a: (layer(*a)[0] * w).sum(), argnums=tuple(range(9)))(*jargs)
    calls = []

    def emulated(dy2, y, vecs, KBT, *, T, C):
        calls.append(y.shape)
        out = emulated_kernel4(*(t.detach().numpy() for t in (dy2, y, vecs, KBT)), T=T, slots=4)
        return tuple(torch.from_numpy(o) for o in out)

    monkeypatch.setattr(stgcn_train, "tconv_bwd", emulated)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    outs = stgcn_train.FusedTrainLayer.apply(*leaves, True, V, C, T)
    (outs[0] * torch.from_numpy(w)).sum().backward()
    assert calls == [(B * T, Wp)]
    for a, b in zip(outs, outs_j):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=1e-5, rtol=1e-5)
    for name, leaf, g in zip(NAMES, leaves, grads_j):
        g = np.asarray(g)
        if name == "cb":
            assert np.all(leaf.grad.numpy() == 0)
            continue
        np.testing.assert_allclose(leaf.grad.numpy(), g, atol=1e-4 * np.abs(g).max(), rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# kernel 5
# ---------------------------------------------------------------------------

def sparse_chunks(col_off, cap):
    """(w, j0, j1) of each chunk of the CSR lists, in (column, chunk) order:
    a list of L tiles cut into max(1, ceil(L / cap)) near-equal chunks
    (csrc/stgcn_sparse.cu)."""
    chunks = []
    for w in range(len(col_off) - 1):
        lo, L = int(col_off[w]), int(col_off[w + 1] - col_off[w])
        n = max(1, -(-L // cap))
        chunks += [(w, lo + q * L // n, lo + (q + 1) * L // n) for q in range(n)]
    return chunks


def emulated_kernel5_acc(x, tiles, col_off, vlist, cap):
    """x @ M (N, Wp) as kernel 5 sums it: per chunk, its tiles in list order
    in k-steps of 8 from a zero accumulator; per column, the chunks'
    partials in chunk order.  numpy f32 operands, x (N, Wp)."""
    N, Wp = x.shape
    chunks = sparse_chunks(col_off, cap)
    longest = max(j1 - j0 for _, j0, j1 in chunks)
    acc = np.zeros((len(chunks), N, 128), np.float32)
    for p in range(longest):  # zero operands past a chunk's end add exactly 0
        a = np.zeros((len(chunks), N, 128), np.float32)
        b = np.zeros((len(chunks), 128, 128), np.float32)
        for i, (_, j0, j1) in enumerate(chunks):
            if j0 + p < j1:
                v = int(vlist[j0 + p])
                a[i], b[i] = x[:, v * 128:(v + 1) * 128], tiles[j0 + p]
        for k0 in range(0, 128, 8):
            acc = kstep_accumulate(acc, a[..., k0:k0 + 8], b[:, k0:k0 + 8])
    out = np.zeros((N, Wp), np.float32)
    first = set()
    for (w, _, _), part in zip(chunks, acc):
        cols = slice(w * 128, (w + 1) * 128)
        out[:, cols] = part if w not in first else (out[:, cols] + part).astype(np.float32)
        first.add(w)
    return out


def emulated_kernel5(x, tiles, vecs, col_off, vlist, cap):
    acc = emulated_kernel5_acc(x, tiles, col_off, vlist, cap)
    return np.maximum(acc * vecs[0] + vecs[1], np.float32(0))  # f32 product, then sum


def _sparse_operands(rng, N, order):
    support = np.zeros((54, 54), bool)
    support[:53, :53] = (build_spatial_graph() != 0).any(0)
    col_off, vlist = stgcn_sparse.sparse_tile_lists(support[:53, :53], order)
    M = rng.randn(54, C, 54, C).astype(np.float32) * 0.05 * support[:, None, :, None]
    Mp = M[order][:, :, order].reshape(3456, 3456)
    pad = int(np.where(order == 53)[0][0])
    x = (rng.randn(N, 3456) * 0.5).astype(np.float32)
    vecs = np.zeros((8, 3456), np.float32)
    vecs[0] = 0.5 + rng.rand(3456)
    vecs[1] = rng.randn(3456) * 0.3
    x[:, pad * C:(pad + 1) * C] = 0
    vecs[:, pad * C:(pad + 1) * C] = 0
    tiles = stgcn_sparse.gather_m_tiles(torch.from_numpy(Mp), col_off, vlist).contiguous().numpy()
    return x, tiles, vecs, col_off, vlist, Mp, pad


@pytest.mark.parametrize("cap", [3, 1000])
@pytest.mark.parametrize("natural", [False, True])
def test_emulated_kernel5_matches_plain(rng, natural, cap):
    """Full width, 48 rows; cap 3 splits every list of more than 3 tiles."""
    order = np.arange(54, dtype=np.int32) if natural else SPARSE_JOINT_ORDER
    x, tiles, vecs, col_off, vlist, Mp, pad = _sparse_operands(rng, 48, order)
    acc = emulated_kernel5_acc(x, tiles, col_off, vlist, cap)
    exact = x.astype(np.float64) @ Mp.astype(np.float64)
    mag = np.abs(x).astype(np.float64) @ np.abs(Mp).astype(np.float64)
    live = mag > 0
    assert np.max(np.abs(acc - exact)[live] / mag[live]) <= 5e-7
    assert np.all(acc[~live] == 0)
    out = emulated_kernel5(x, tiles, vecs, col_off, vlist, cap)
    ref = stgcn_sparse.sparse_graph_matmul_bn_relu_ref(
        torch.from_numpy(x), torch.from_numpy(tiles), torch.from_numpy(vecs), col_off, vlist).numpy()
    # BN1 and the ReLU move a difference by at most |s1| times itself plus the output's rounding
    bound = 1e-6 * np.abs(vecs[0]) * mag + 2.0 ** -23 * np.abs(ref)
    assert np.all(np.abs(out - ref) <= bound)
    assert np.all(out[:, pad * C:(pad + 1) * C] == 0)


def test_sparse_generate_small_with_emulated_kernel5_matches_jax(monkeypatch):
    """The SMALL sparse chain with kernel 5's emulated arithmetic in every
    block (cap 4: the longer lists split): indices equal to the JAX
    package's, floats in its bands."""
    payload = flax_payload(SMALL["num_gaussian"], seed=3)
    x = walking_clip(np.random.RandomState(0), 2, SMALL["num_frames"])
    jvars = {"params": payload["params"], "batch_stats": payload["batch_stats"]}
    ref = jax.tree_util.tree_map(
        np.asarray, jax_model(SMALL, sparse_eval=True).apply(jvars, x, method=JaxP2RNet.generate))
    calls = []

    def emulated(h, m_tiles, vecs, col_off, vlist):
        calls.append(h.shape)
        B, T, Wp = h.shape
        out = emulated_kernel5(h.reshape(B * T, Wp).numpy(), m_tiles.numpy(), vecs.numpy(),
                               col_off.numpy(), vlist.numpy(), cap=4)
        return torch.from_numpy(out.reshape(B, T, Wp))

    monkeypatch.setattr(port_stgcn, "sparse_graph_matmul_bn_relu", emulated)
    model = port_model(SMALL, payload, sparse_eval=True)
    got = to_numpy(model.generate(torch.from_numpy(x), folded=model.fold_eval()))
    assert len(calls) == 6
    assert_generate_close(got, ref)
