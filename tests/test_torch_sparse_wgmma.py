"""The arithmetic of kernel 5's bf16 leg (csrc/stgcn_sparse.cu,
``p2r_stgcn_sparse_bf16``, on wgmma), emulated on the CPU in its own order.

Each unit (a 128-row block of one output column tile over a chunk of its
CSR list) sums its tiles in k16 steps: every ``fold`` k16 steps go into a
fresh tensor-core accumulator, whose adds truncate (ROADMAP "the tensor
cores' f32 adds truncate"), and that accumulator is folded into the running
f32 sum by an IEEE add.  A list cut into chunks (split-K, at small batch)
leaves one f32 partial per chunk, summed in chunk order; then
relu(acc * s1 + b1), a product and then a sum in f32, rounded to bf16 once.
The kernel ships fold 4 (``kFold``: one fold a 64-deep stage); 1 and 2
are the variants of scripts/torch_bf16_variants.py.

Held at full width, B=1 (the card's split-K cut), against the plain
version ``sparse_graph_matmul_bn_relu_ref`` and the JAX package's Pallas
kernel in interpret mode on the same bf16 operands (within 1 bf16 ulp where
the output is above 1e-3 of its max), and its f32 accumulator against
float64 (the tensor-core kernels' rule: within 5e-7 of sum |a*b|, bias
within 5e-8); and the SMALL sparse bf16 ``generate`` with it in every block
against the JAX package's bf16 ``generate``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose2room_tpu.models import P2RNet as JaxP2RNet
from pose2room_tpu.ops import stgcn_sparse as jax_sparse
from pose2room_tpu_torch.models import stgcn as port_stgcn
from pose2room_tpu_torch.models.graph import SPARSE_JOINT_ORDER, build_spatial_graph
from pose2room_tpu_torch.ops import stgcn_sparse
from test_torch_bwd_sparse_3xtf32 import sparse_chunks
from torch_port_util import SMALL, f32, flax_payload, jax_model, port_model, ulps, walking_clip

BF16 = torch.bfloat16
SHIPPED_FOLD = 4  # csrc/stgcn_sparse.cu: kFold
H100_SMS = 132


def split_cap(N, nnz, G=27, slots=H100_SMS, waves=1):
    """The longest chunk the bf16 leg cuts a list into (csrc/stgcn_sparse.cu:
    make_plan with kSplitWavesBf16, one block an SM): the chunks fill the
    card about once, at least 4 tiles, at most a whole list."""
    n_rb = -(-N // 128)
    per_unit = -(-(nnz * n_rb) // (waves * slots))
    return min(max(per_unit, 4), G)


def to_bf16(a):
    """f32 values rounded to the nearest bf16 (ties to even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16).float().numpy()


def truncate_f32(a):
    """float64 -> the f32 next to it toward zero (the tensor cores' adds)."""
    f = a.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(a), np.nextafter(f, np.float32(0)), f)


def truncate_f32_torch(a):
    """``truncate_f32`` of a float64 tensor."""
    f = a.float()
    return torch.where(f.double().abs() > a.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def emulated_acc(x, tiles, col_off, vlist, cap, fold):
    """x @ M (N, Wp) as the kernel's bf16 leg sums it.  x, tiles: f32
    arrays holding bf16 values (their products are exact).  Every chunk
    steps through its tiles at once (torch float64 on the host's threads);
    a chunk past its end is left out, as its zero operands add exactly 0."""
    N, Wp = x.shape
    chunks = sparse_chunks(col_off, cap)
    j0 = torch.tensor([c[1] for c in chunks])
    j1 = torch.tensor([c[2] for c in chunks])
    xg = torch.from_numpy(x).double().reshape(N, Wp // 128, 128).transpose(0, 1)  # (column tile, N, 128)
    tt = torch.from_numpy(tiles).double()
    vl = torch.from_numpy(np.asarray(vlist, np.int64))
    acc = torch.zeros((len(chunks), N, 128), dtype=torch.float32)
    for p in range(int((j1 - j0).max())):
        live = torch.nonzero(j0 + p < j1).flatten()
        a, b = xg[vl[j0[live] + p]], tt[j0[live] + p]
        for k0 in range(0, 128, 16 * fold):
            part = torch.zeros((len(live), N, 128), dtype=torch.float64)
            for f in range(fold):  # one fresh accumulator, the tensor cores' adds
                k = slice(k0 + 16 * f, k0 + 16 * (f + 1))
                part = truncate_f32_torch(part + torch.matmul(a[..., k], b[:, k])).double()
            acc[live] = acc[live] + part.float()  # the IEEE fold
    out = np.zeros((N, Wp), np.float32)
    seen = set()
    for (w, _, _), part in zip(chunks, acc.numpy()):  # each column's chunks in chunk order
        cols = slice(w * 128, (w + 1) * 128)
        out[:, cols] = part if w not in seen else (out[:, cols] + part).astype(np.float32)
        seen.add(w)
    return out


def emulated_kernel5_bf16(x, tiles, vecs, col_off, vlist, cap, fold=SHIPPED_FOLD):
    acc = emulated_acc(x, tiles, col_off, vlist, cap, fold)
    return to_bf16(np.maximum((acc * vecs[0]).astype(np.float32) + vecs[1], np.float32(0)))


def _operands(rng, N):
    order = SPARSE_JOINT_ORDER
    support = np.zeros((54, 54), bool)
    support[:53, :53] = (build_spatial_graph() != 0).any(0)
    col_off, vlist = stgcn_sparse.sparse_tile_lists(support[:53, :53], order)
    M = rng.randn(54, 64, 54, 64).astype(np.float32) * 0.02 * support[:, None, :, None]
    Mp = to_bf16(M[order][:, :, order].reshape(3456, 3456))
    pad = int(np.where(order == 53)[0][0])
    x = to_bf16(np.maximum(rng.randn(N, 3456), 0))
    vecs = np.zeros((8, 3456), np.float32)
    vecs[0] = 0.5 + rng.rand(3456)
    vecs[1] = rng.randn(3456) * 0.3
    x[:, pad * 64:(pad + 1) * 64] = 0
    vecs[:, pad * 64:(pad + 1) * 64] = 0
    tiles = stgcn_sparse.gather_m_tiles(torch.from_numpy(Mp), col_off, vlist).contiguous().numpy()
    return x, tiles, vecs, col_off, vlist, Mp, pad


@pytest.fixture(scope="module")
def full_b1():
    """Full width at B=1 (T=768), and the plain version's and the JAX
    Pallas kernel's (interpret mode) bf16 outputs on the same operands."""
    x, tiles, vecs, col_off, vlist, Mp, pad = _operands(np.random.RandomState(7), 768)
    tb = torch.from_numpy(tiles).to(BF16)
    ref = f32(stgcn_sparse.sparse_graph_matmul_bn_relu_ref(
        torch.from_numpy(x).to(BF16)[None], tb, torch.from_numpy(vecs), col_off, vlist)[0])
    jx = jax_sparse.sparse_graph_matmul_bn_relu(
        jnp.asarray(x[None], jnp.bfloat16), jnp.asarray(tiles, jnp.bfloat16), jnp.asarray(vecs),
        jnp.asarray(col_off), jnp.asarray(vlist), interpret=True)
    return x, tiles, vecs, col_off, vlist, Mp, pad, ref, np.asarray(jx[0], np.float32)


def test_split_cap_at_b1_cuts_the_lists(full_b1):
    """At B=1 the card's plan cuts the lists longer than 13 tiles (of 5-20)
    into two chunks; at B=8 it cuts none."""
    col_off, vlist = full_b1[3], full_b1[4]
    assert len(vlist) == 279
    assert split_cap(768, len(vlist)) == 13
    assert np.diff(col_off).max() > 13
    assert split_cap(8 * 768, len(vlist)) == 27


@pytest.mark.parametrize("fold,cap", [(SHIPPED_FOLD, 13), (SHIPPED_FOLD, 27), (SHIPPED_FOLD, 5), (1, 13), (2, 13)])
def test_emulated_bf16_leg_within_one_ulp(full_b1, fold, cap):
    """The kernel's order (the shipped fold with the B=1 split, without it,
    and cut finer as the f32 leg cuts; and the fold variants) against the
    plain version and the JAX Pallas
    kernel: within 1 bf16 ulp where the output is above 1e-3 of its max,
    and within 2^-7 of the max everywhere; the pad slot exactly 0."""
    x, tiles, vecs, col_off, vlist, _, pad, ref, jx = full_b1
    got = emulated_kernel5_bf16(x, tiles, vecs, col_off, vlist, cap, fold)
    for want in (ref, jx):
        scale = np.abs(want).max()
        live = np.abs(want) > 1e-3 * scale
        assert ulps(got[live], want[live]) <= 1
        assert np.abs(got - want).max() <= scale * 2 ** -7
    assert np.all(got[:, pad * 64:(pad + 1) * 64] == 0)


def test_emulated_bf16_accumulator_against_float64(full_b1):
    """The shipped fold's f32 accumulator, with the B=1 split, against
    float64 on the same bf16 operands: within 5e-7 of sum |a*b|, bias within
    5e-8 (the rule of the port's tensor-core kernels)."""
    x, tiles, _, col_off, vlist, Mp, _, _, _ = full_b1
    acc = emulated_acc(x, tiles, col_off, vlist, split_cap(768, len(vlist)), SHIPPED_FOLD)
    xd, Md = x.astype(np.float64), Mp.astype(np.float64)
    exact, mag = xd @ Md, np.abs(xd) @ np.abs(Md)
    live = mag > 0
    d = acc[live] - exact[live]
    assert np.max(np.abs(d) / mag[live]) <= 5e-7
    assert abs(np.sum(d * np.sign(exact[live])) / np.sum(mag[live])) <= 5e-8
    assert np.all(acc[~live] == 0)


def test_sparse_bf16_generate_small_with_emulated_kernel_matches_jax(monkeypatch):
    """The SMALL sparse bf16 chain with the bf16 leg's emulated order in
    every block (cap 4: the longer lists split): seed and proposal indices
    equal to the JAX package's bf16 generate, seed features within 1e-2 of
    their max and the other outputs within 0.05 of theirs (the bands of
    tests/test_torch_bf16.py::test_generate_matches_jax)."""
    payload = flax_payload(SMALL["num_gaussian"], seed=3)
    clip = walking_clip(np.random.RandomState(2), 2, SMALL["num_frames"])
    jvars = {"params": payload["params"], "batch_stats": payload["batch_stats"]}
    jm = jax_model(SMALL, compute_dtype="bfloat16", sparse_eval=True)
    ref = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda v, x: jm.apply(v, x, method=JaxP2RNet.generate))(jvars, clip))
    calls = []

    def emulated(h, m_tiles, vecs, col_off, vlist):
        assert h.dtype == m_tiles.dtype == BF16
        calls.append(h.shape)
        B, T, Wp = h.shape
        out = emulated_kernel5_bf16(f32(h).reshape(B * T, Wp), f32(m_tiles), vecs.numpy(), col_off.numpy(),
                                    vlist.numpy(), cap=4)
        return torch.from_numpy(out.reshape(B, T, Wp)).to(BF16)

    monkeypatch.setattr(port_stgcn, "sparse_graph_matmul_bn_relu", emulated)
    model = port_model(SMALL, payload, compute_dtype="bfloat16", sparse_eval=True)
    got = model.generate(torch.from_numpy(clip), folded=model.fold_eval())
    assert len(calls) == 6
    np.testing.assert_array_equal(got["seed_inds"].numpy(), ref["seed_inds"])
    np.testing.assert_array_equal(got["aggregated_vote_inds"].numpy(), ref["aggregated_vote_inds"])
    pairs = {k: (got[k], ref[k]) for k in ("seed_features", "vote_xyz", "vote_features", "aggregated_vote_xyz",
                                           "center", "size", "heading", "objectness_scores", "sem_cls_scores")}
    pairs.update({f"pi/{k}": (got["pi"][k], ref["pi"][k]) for k in ("center", "size", "heading")})
    for key, (g, r) in pairs.items():
        g, r = f32(g), np.asarray(r, np.float32)
        band = 1e-2 if key == "seed_features" else 0.05
        assert np.abs(g - r).max() <= band * np.abs(r).max(), key
