"""The arithmetic of the bf16 legs of kernels 3 and 4 (csrc/stgcn_train_fwd.cu
``p2r_stgcn_train_fwd_bf16``, csrc/stgcn_train_bwd.cu
``p2r_stgcn_train_bwd_bf16``), emulated on the CPU in the kernels' own
order.

Both walk items of 128 rows x 64 columns (one joint) on a persistent
grid whose even blocks take the even joints and odd blocks the odd ones
(block ``blk``: items blk // 2, blk // 2 + grid / 2, ... of its parity),
two blocks an SM.  The temporal conv
(kernel 3's y2, kernel 4's dt1) sums, per element, tap s then 16-deep
k-steps, each product a fresh tensor-core fragment (its adds truncate,
ROADMAP "the tensor cores' f32 adds truncate") folded into the f32 sum by
an IEEE add.  The column moments: each thread sums its rows g, g+8, g+16,
g+24 of a 32-row warp in order, a butterfly of shuffles sums the warp's 8
row groups, and the two warps of a 64-row part are added in order; the
wrapper sums the parts of a clip.  Kernel 4's tap gradient: each warp sums
``fold`` k16 steps of item rows into a fresh fragment, then folds it into
its running f32 sum by an IEEE add, over every item its block walks (the
joints of one parity: their diagonal tap blocks are one tap); each block
leaves one partial, and the wrapper sums the partials.

Held at small shapes (T = 136: a ragged second item) against the plain
versions and the JAX package's kernels in interpret mode on the same bf16
operands (outputs within 1 bf16 ulp above 1e-3 of their max), the f32
sums against float64 (within 5e-7 of sum |a*b| or of sum |terms|, bias
within 5e-8, the rule of the port's tensor-core kernels), over two grids;
and with both emulated legs patched in, the bf16 train layer against the
JAX package's within the bands of tests/test_torch_bf16_train.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose2room_tpu.ops import stgcn_train as jax_train
from pose2room_tpu_torch.ops import stgcn_train
from torch_golden import goldens, jax_layer_bf16  # noqa: F401  (fixtures)
from torch_kernel_cases import (
    NAMES,
    C,
    T as T_LAYER,
    V,
    W0,
    Wp,
    assert_ulp_close,
    bf16_port_leaves,
    bf16_round,
    truncate_f32,
)
from torch_port_util import f32

BF16 = torch.bfloat16
ROWS = 128  # rows of an item
SHIPPED_FOLD = 1  # csrc/stgcn_train_bwd.cu: k16 steps a fresh fragment of the tap gradient sums
H100_SMS = 132


def items_of(B_, T_, Wp_):
    """The items in the kernels' order, each as its 128-column group (its
    joint at col0 + 64 * parity): (col0, clip, t0)."""
    n_tiles = -(-T_ // ROWS)
    return [(i // (B_ * n_tiles) * 128, i % (B_ * n_tiles) // n_tiles, i % n_tiles * ROWS)
            for i in range(Wp_ // 128 * B_ * n_tiles)]


def diag_taps(K):
    """(3, 128, 128) block-diagonal taps -> per parity the 64x64 diagonal
    block: (2, 3, 64, 64) float64."""
    return np.stack([K[:, p * 64:(p + 1) * 64, p * 64:(p + 1) * 64] for p in (0, 1)]).astype(np.float64)


def emulated_conv(h, K):
    """sum_s shift_s(h) @ K[s] (tap s reads row t+s-1, zero outside the
    clip) in f32 as the kernels sum it.  h: (B, T, Wp) f32 of bf16 values;
    K: (3, 128, 128) f32 of bf16 values."""
    B_, T_, Wp_ = h.shape
    J = Wp_ // 64
    Kd = diag_taps(K)[np.arange(J) % 2]  # (J, 3, 64, 64): each joint's block
    hp = np.zeros((B_, T_ + 2, J, 64))
    hp[:, 1:-1] = h.reshape(B_, T_, J, 64)
    acc = np.zeros((B_, T_, J, 64), np.float32)
    for s in range(3):
        hs = hp[:, s:s + T_]
        for k0 in range(0, 64, 16):
            part = truncate_f32(np.einsum("btjk,jkn->btjn", hs[..., k0:k0 + 16], Kd[:, s, k0:k0 + 16]))
            acc = (acc + part).astype(np.float32)
    return acc.reshape(B_, T_, Wp_)


def emulated_moments(a, b, T_):
    """Per-(clip, 64-row part, column) [sum(a), sum(a * b)] in the kernels'
    order (a * b and the add in one rounding, as the contracted FMA),
    summed over the parts of a clip as the wrapper sums them: (B, 2, Wp)."""
    B_, _, Wp_ = a.shape
    n_tiles = -(-T_ // ROWS)
    rows = n_tiles * ROWS
    pa, pb = (np.zeros((B_, rows, Wp_), np.float32) for _ in range(2))
    pa[:, :T_], pb[:, :T_] = a, b
    # [clip, 32-row warp, g, (mt, half), column]: row 32 w + 16 mt + 8 half + g
    wa = pa.reshape(B_, rows // 32, 2, 2, 8, Wp_).transpose(0, 1, 4, 2, 3, 5).reshape(B_, rows // 32, 8, 4, Wp_)
    wb = pb.reshape(B_, rows // 32, 2, 2, 8, Wp_).transpose(0, 1, 4, 2, 3, 5).reshape(B_, rows // 32, 8, 4, Wp_)
    out = []
    for prod in (False, True):
        s = np.zeros((B_, rows // 32, 8, Wp_), np.float32)
        for i in range(4):  # rows past the clip are zero and add exactly 0
            term = wa[..., i, :].astype(np.float64) * (wb[..., i, :] if prod else 1.0)
            s = (s + term).astype(np.float32)
        for off in (1, 2, 4):  # the butterfly over the warp's row groups
            s = (s + s[:, :, np.arange(8) ^ off]).astype(np.float32)
        warps = s[:, :, 0].reshape(B_, rows // 64, 2, Wp_)
        out.append((warps[:, :, 0] + warps[:, :, 1]).astype(np.float32)[:, :-(-T_ // 64)])
    tile_parts = torch.from_numpy(np.stack(out, axis=2))  # (B, n_parts, 2, Wp)
    return tile_parts.sum(dim=1).numpy()


def emulated_fwd(y, vecs, KB, T_):
    """Kernel 3's bf16 leg: (y2 (N, Wp) f32 of bf16 values, parts (B, 2, Wp))."""
    N, Wp_ = y.shape
    B_ = N // T_
    pre = ((y * vecs[0]).astype(np.float32) + vecs[1]).astype(np.float32)
    t1 = bf16_round(np.maximum(pre, 0)).reshape(B_, T_, Wp_)
    y2 = bf16_round((emulated_conv(t1, KB) + vecs[2]).astype(np.float32))
    return y2.reshape(N, Wp_), emulated_moments(y2, y2, T_)


def grid_of(items, slots):
    """The bf16 legs' grid (tconv_mma.cuh:grid_size): the blocks of each
    parity (even blocks the even joints) take half the slots."""
    return 2 * min(items, max(slots // 2, 1))


def emulated_tap_parts(t1, dy2, T_, slots, fold):
    """Kernel 4's tap partials: (grid, 3, 64, 64) f32, one a block, over the
    joints of every item it walks (their diagonal blocks are one tap): block
    blk takes the joint of parity blk % 2 of items blk // 2, blk // 2 +
    grid / 2, ...  t1, dy2: (B, T, Wp) f32 of bf16 values."""
    B_, _, Wp_ = t1.shape
    items = items_of(B_, T_, Wp_)
    blocks = grid_of(len(items), slots)
    pad = lambda a: np.concatenate([np.zeros((B_, 1, Wp_)), a, np.zeros((B_, ROWS + 1, Wp_))], 1)  # noqa: E731
    tp, dp = pad(t1), pad(dy2)
    parts = np.zeros((blocks, 3, 64, 64), np.float32)
    for blk in range(blocks):
        parity = blk % 2
        for col0, b, t0 in items[blk // 2::blocks // 2]:
            k_end = min(ROWS, -(-(T_ - t0) // 16) * 16)
            cols = slice(col0 + 64 * parity, col0 + 64 * (parity + 1))
            ts, ds = tp[b, t0:t0 + ROWS + 2, cols], dp[b, t0:t0 + ROWS + 2, cols]  # slab rows 0..129
            gacc = parts[blk]
            for kg in range(0, k_end, 16 * fold):
                part = np.zeros((3, 64, 64))
                for k0 in range(kg, min(kg + 16 * fold, k_end), 16):
                    prod = np.stack([ts[k0 + s:k0 + s + 16].T @ ds[k0 + 1:k0 + 17] for s in range(3)])
                    part = truncate_f32(part + prod).astype(np.float64)
                gacc[:] = (gacc + part.astype(np.float32)).astype(np.float32)
    return parts


def emulated_bwd(dy2, y, vecs, KBT, T_, grid=2 * H100_SMS, fold=SHIPPED_FOLD):
    """Kernel 4's bf16 leg: (dpre (N, Wp) f32 of bf16 values, parts (B, 2,
    Wp), dtaps (3, 64, 64) f32, the tap partials)."""
    N, Wp_ = y.shape
    B_ = N // T_
    pre = ((y * vecs[0]).astype(np.float32) + vecs[1]).astype(np.float32).reshape(B_, T_, Wp_)
    dt1 = emulated_conv(dy2.reshape(B_, T_, Wp_), KBT[::-1])
    d = np.where(pre > 0, dt1, np.float32(0))
    parts = emulated_moments(d, y.reshape(B_, T_, Wp_), T_)
    t1 = bf16_round(np.maximum(pre, 0))
    tap_parts = emulated_tap_parts(t1, dy2.reshape(B_, T_, Wp_), T_, grid, fold)
    dtaps = torch.from_numpy(tap_parts).sum(dim=0).numpy()
    return bf16_round(d).reshape(N, Wp_), parts, dtaps, tap_parts


def _operands(seed, B_, T_, Wp_=Wp, W0_=W0):
    rng = np.random.RandomState(seed)
    y = np.zeros((B_ * T_, Wp_), np.float32)
    y[:, :W0_] = rng.randn(B_ * T_, W0_) * 0.7
    vecs = np.zeros((4, Wp_), np.float32)
    vecs[0, :W0_] = 0.5 + rng.rand(W0_)
    vecs[1, :W0_] = rng.randn(W0_) * 0.3
    vecs[2, :W0_] = rng.randn(W0_) * 0.1
    taps = bf16_round(rng.randn(3, C, C) * 0.15)
    KB = np.zeros((3, 128, 128), np.float32)
    KB[:, :64, :64] = KB[:, 64:, 64:] = taps
    dy2 = np.zeros((B_ * T_, Wp_), np.float32)
    dy2[:, :W0_] = rng.randn(B_ * T_, W0_) * 0.5
    return bf16_round(y), vecs, KB, bf16_round(dy2)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF16)


def _float64_gap(got, exact, mag):
    d = got.astype(np.float64) - exact
    live = mag > 0
    return np.max(np.abs(d[live]) / mag[live]), np.sum(d * np.sign(exact)) / np.sum(mag)


def _float64_moments(a, b, T_):
    B_ = a.shape[0] // T_
    a, b = a.reshape(B_, T_, -1).astype(np.float64), b.reshape(B_, T_, -1).astype(np.float64)
    return (np.stack([a.sum(1), (a * b).sum(1)], 1), np.stack([np.abs(a).sum(1), np.abs(a * b).sum(1)], 1))


def _assert_parts_within(got, exact, mag):
    """Moments against float64: within 5e-7 of each column's sum |terms|,
    bias within 5e-8; exactly 0 where every term is 0."""
    g_max, g_bias = _float64_gap(got, exact, mag)
    assert g_max <= 5e-7 and abs(g_bias) <= 5e-8, (g_max, g_bias)
    assert np.all(got[mag == 0] == 0)


def test_item_walk_covers_every_item_once():
    """The persistent grid's walk: every (joint, clip, 128-row tile) once,
    in the kernels' order, and one tap partial a block."""
    items = items_of(2, 130, 384)
    assert len(items) == len(set(items)) == 3 * 2 * 2
    assert items[:3] == [(0, 0, 0), (0, 0, 128), (0, 1, 0)]
    for slots in (4, 264):
        blocks = grid_of(len(items), slots)
        walked = [(col0 + 64 * (blk % 2), b, t0) for blk in range(blocks)
                  for col0, b, t0 in items[blk // 2::blocks // 2]]
        assert sorted(walked) == sorted((col0 + 64 * j, b, t0) for col0, b, t0 in items for j in (0, 1))
    t = np.zeros((2, 130, 384), np.float32)
    assert emulated_tap_parts(t, t, 130, 4, SHIPPED_FOLD).shape == (4, 3, 64, 64)


@pytest.fixture(scope="module")
def fwd_case():
    """Kernel 3 at B=2, T=136 (an 8-row second item): the emulated leg, the
    plain version and the JAX Pallas kernel in interpret mode."""
    Tc = 136
    y, vecs, KB, _ = _operands(0, 2, Tc)
    y2, parts = emulated_fwd(y, vecs, KB, Tc)
    ref = stgcn_train.tconv_stats_fwd_ref(_bf16(y), torch.from_numpy(vecs), _bf16(KB), T=Tc)
    jy2, jparts = jax_train._tconv_stats_fwd(jnp.asarray(y, jnp.bfloat16), jnp.asarray(vecs),
                                             jnp.asarray(KB, jnp.bfloat16), T=Tc, interpret=True)
    return Tc, y2, parts, (f32(ref[0]), ref[1].numpy()), (np.asarray(jy2, np.float32), np.asarray(jparts))


@pytest.mark.parametrize("against", ["plain", "jax_interpret"])
def test_emulated_fwd_bf16_matches(fwd_case, against):
    """y2 within 1 bf16 ulp of the plain version's and the JAX kernel's
    above 1e-3 of the max (<= 1e-3 of elements differing), the moments
    within 1e-3 of each column's scale, pad columns exactly 0."""
    Tc, y2, parts, ref, jx = fwd_case
    want_y2, want_parts = ref if against == "plain" else jx
    assert_ulp_close(y2, want_y2, f"y2 vs {against}")
    y3 = np.abs(want_y2.reshape(2, Tc, Wp))
    scale = np.maximum(np.stack([y3.sum(1), (y3 * y3).sum(1)], axis=1), 1e-6)
    assert np.max(np.abs(parts - want_parts) / scale) <= 1e-3
    assert np.all(y2[:, W0:] == 0) and np.all(parts[..., W0:] == 0)


def test_emulated_fwd_bf16_sums_against_float64(fwd_case):
    """The conv's f32 sum (before the one rounding) within 5e-7 of sum |a*b|
    of float64 on the same bf16 t1 and taps, bias within 5e-8; the moments
    of the rounded y2 within 5e-7 of sum |terms|."""
    Tc, y2, parts, _, _ = fwd_case
    y, vecs, KB, _ = _operands(0, 2, Tc)
    t1 = bf16_round(np.maximum(((y * vecs[0]).astype(np.float32) + vecs[1]).astype(np.float32), 0))
    t1 = t1.reshape(2, Tc, Wp).astype(np.float64)
    got = emulated_conv(t1.astype(np.float32), KB)
    Kd = diag_taps(KB)[np.arange(Wp // 64) % 2]
    hp = np.zeros((2, Tc + 2, Wp // 64, 64))
    hp[:, 1:-1] = t1.reshape(2, Tc, -1, 64)
    exact = sum(np.einsum("btjk,jkn->btjn", hp[:, s:s + Tc], Kd[:, s]) for s in range(3)).reshape(2, Tc, Wp)
    mag = sum(np.einsum("btjk,jkn->btjn", np.abs(hp[:, s:s + Tc]), np.abs(Kd[:, s])) for s in range(3))
    g_max, g_bias = _float64_gap(got, exact, mag.reshape(2, Tc, Wp))
    assert g_max <= 5e-7 and abs(g_bias) <= 5e-8, (g_max, g_bias)
    _assert_parts_within(parts, *_float64_moments(y2, y2, Tc))


@pytest.fixture(scope="module")
def bwd_refs():
    """Kernel 4's operands at B=2, T=136, and the plain version's and the
    JAX Pallas kernel's (interpret mode) outputs."""
    Tc = 136
    y, vecs, KB, dy2 = _operands(1, 2, Tc)
    vecs[2] = 0.0
    KBT = np.ascontiguousarray(np.transpose(KB, (0, 2, 1)))
    dpre, parts, dkb = stgcn_train.tconv_bwd_ref(_bf16(dy2), _bf16(y), torch.from_numpy(vecs), _bf16(KBT), T=Tc)
    ref = (f32(dpre), parts.numpy(), stgcn_train._fold_diag_blocks(dkb, C).numpy())
    jx = jax_train._tconv_bwd(jnp.asarray(dy2, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16), jnp.asarray(vecs),
                              jnp.asarray(KBT, jnp.bfloat16), T=Tc, interpret=True)
    jdkb = torch.from_numpy(np.array(jx[2], np.float32))
    jx = (np.asarray(jx[0], np.float32), np.asarray(jx[1]), stgcn_train._fold_diag_blocks(jdkb, C).numpy())
    return Tc, (dy2, y, vecs, KBT), ref, jx


@pytest.mark.parametrize("slots", [4, 2 * H100_SMS])
@pytest.mark.parametrize("against", ["plain", "jax_interpret"])
def test_emulated_bwd_bf16_matches(bwd_refs, slots, against):
    """dpre within 1 bf16 ulp of the plain version's and the JAX kernel's
    (<= 1e-3 of elements differing), its moments (of the unrounded dpre)
    within 1e-3 of each column's scale, the tap gradient within 1e-4 of its
    max, on a grid of 4 blocks (6 joint-items each) and of one block a
    joint-item (two blocks an SM on 132 SMs); pad columns exactly 0."""
    Tc, ops, ref, jx = bwd_refs
    dpre, parts, dtaps, tap_parts = emulated_bwd(*ops, Tc, grid=slots)
    assert tap_parts.shape[0] == min(slots, 24)
    want = ref if against == "plain" else jx
    assert_ulp_close(dpre, want[0], f"dpre vs {against}")
    d3, y3 = np.abs(want[0].reshape(2, Tc, Wp)), np.abs(ops[1].reshape(2, Tc, Wp))
    scale = np.maximum(np.stack([d3.sum(1), (d3 * y3).sum(1)], axis=1), 1e-6)
    assert np.max(np.abs(parts - want[1]) / scale) <= 1e-3
    assert np.abs(dtaps - want[2]).max() <= 1e-4 * np.abs(want[2]).max()
    assert np.all(dpre[:, W0:] == 0) and np.all(parts[..., W0:] == 0)


def test_emulated_bwd_bf16_moments_against_float64(bwd_refs):
    """The moments of the unrounded dpre against float64 of the masked dt1
    on the same bf16 operands: within 5e-7 of sum |terms|, bias within 5e-8."""
    Tc, (dy2, y, vecs, KBT), _, _ = bwd_refs
    _, parts, _, _ = emulated_bwd(dy2, y, vecs, KBT, Tc)
    pre = ((y * vecs[0]).astype(np.float32) + vecs[1]).astype(np.float32)
    d = torch.from_numpy(dy2).double().reshape(2, Tc, Wp)
    K = torch.from_numpy(KBT).double()
    from pose2room_tpu_torch.ops.stgcn_fused import shift_next, shift_prev, tconv_group
    dt1 = (tconv_group(shift_next(d), K[0]) + tconv_group(d, K[1]) + tconv_group(shift_prev(d), K[2])).numpy()
    exact = np.where(pre.reshape(2, Tc, Wp) > 0, dt1, 0.0)
    m_exact, m_mag = _float64_moments(exact.reshape(-1, Wp), y, Tc)
    _assert_parts_within(parts, m_exact, m_mag)


@pytest.mark.parametrize("fold", [SHIPPED_FOLD, 2, 4])
def test_emulated_tap_gradient_against_float64(fold):
    """The tap gradient summed over a long walk (B=1, T=768: 36 joint-items
    on 4 blocks, 72 k16 steps a partial) at fold 1 (shipped), 2 and 4, against
    float64 on the same bf16 t1 and dy2: within 5e-7 of sum |a*b|, bias
    within 5e-8."""
    Tc = 768
    y, vecs, _, dy2 = _operands(2, 1, Tc)
    t1 = bf16_round(np.maximum(((y * vecs[0]).astype(np.float32) + vecs[1]).astype(np.float32), 0))
    t1, d = t1.reshape(1, Tc, Wp), dy2.reshape(1, Tc, Wp)
    tap_parts = emulated_tap_parts(t1, d, Tc, slots=4, fold=fold)
    dtaps = torch.from_numpy(tap_parts).sum(dim=0).numpy()
    tp = np.concatenate([np.zeros((1, 1, Wp)), t1, np.zeros((1, 1, Wp))], 1).astype(np.float64)
    dd = d[..., :W0].reshape(-1, 64).astype(np.float64)
    exact = np.stack([tp[:, s:s + Tc, :W0].reshape(-1, 64).T @ dd for s in range(3)])
    mag = np.stack([np.abs(tp[:, s:s + Tc, :W0].reshape(-1, 64)).T @ np.abs(dd) for s in range(3)])
    g_max, g_bias = _float64_gap(dtaps, exact, mag)
    assert g_max <= 5e-7 and abs(g_bias) <= 5e-8, (fold, g_max, g_bias)


def _emulated_fwd_wrapper(y, vecs, KB, *, T):
    y2, parts = emulated_fwd(f32(y), vecs.numpy(), f32(KB), T)
    return _bf16(y2), torch.from_numpy(parts)


def _emulated_bwd_wrapper(dy2, y, vecs, KBT, *, T, C):
    dpre, parts, dtaps, _ = emulated_bwd(f32(dy2), f32(y), vecs.numpy(), f32(KBT), T)
    return _bf16(dpre), torch.from_numpy(parts), torch.from_numpy(dtaps)


@pytest.mark.parametrize("residual", [False, True])
def test_layer_bf16_with_emulated_legs_matches_jax(jax_layer_bf16, monkeypatch, residual):
    """FusedTrainLayer in bf16 with both emulated legs in place of the
    wrappers against the JAX package's make_train_layer (bf16): the output
    within 1 ulp (<= 1e-3 of elements differing), the batch statistics
    within 1e-4 relative, each gradient within 1e-2 of its max|g| (the
    bands of tests/test_torch_bf16_train.py::test_layer_bf16_matches_jax)."""
    calls = []
    monkeypatch.setattr(stgcn_train, "tconv_stats_fwd",
                        lambda *a, **k: calls.append("fwd") or _emulated_fwd_wrapper(*a, **k))
    monkeypatch.setattr(stgcn_train, "tconv_bwd", lambda *a, **k: calls.append("bwd") or _emulated_bwd_wrapper(*a, **k))
    args, outs_j, grads_j, w = jax_layer_bf16[residual]
    leaves = bf16_port_leaves(args)
    outs = stgcn_train.FusedTrainLayer.apply(*leaves, residual, V, C, T_LAYER)
    (outs[0].float() * torch.from_numpy(w)).sum().backward()
    assert calls == ["fwd", "bwd"]
    assert outs[0].dtype == BF16
    assert_ulp_close(outs[0], outs_j[0], "out")
    for name, a, b in zip(("mean1", "var1", "mean2", "var2"), outs[1:], outs_j[1:]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max(), err_msg=name)
    for name, leaf, g in zip(NAMES, leaves, grads_j):
        got = f32(leaf.grad)
        if name == "cb":
            assert np.all(got == 0) and np.all(g == 0)
            continue
        assert np.abs(got - g).max() <= 1e-2 * np.abs(g).max(), name
