"""Operands and emulated arithmetic that several of the port's kernel test
files share.

* the train layer's operands at the small shape of
  tests/test_stgcn_train.py (V=5, W0=320 -> Wp=384, T=16, B=2): f32
  (tests/test_torch_train_layer.py, tests/test_torch_bwd_sparse_3xtf32.py)
  and with x and M rounded to bf16 (tests/test_torch_bf16_train.py,
  tests/test_torch_train_bf16_redesign.py), and the bf16 ulp rule;
* 3xTF32 on the tensor cores (csrc/tconv_mma.cuh): every operand a splits
  into big = rna_tf32(a) and small = rna_tf32(a - big), and each k-step of
  8 sums small*big, big*small and big*big into a fresh fragment that an f32
  add folds into the accumulator; the kernels' temporal conv in that
  arithmetic (tests/test_torch_tconv_3xtf32.py,
  tests/test_torch_bwd_sparse_3xtf32.py);
* kernel 5's split-K chunks (csrc/stgcn_sparse.cu) and the tensor cores'
  truncating f32 adds (tests/test_torch_bwd_sparse_3xtf32.py,
  tests/test_torch_sparse_wgmma.py, tests/test_torch_train_bf16_redesign.py).
"""

import numpy as np
import torch

from torch_port_util import f32, ordinal, ulps

BF16 = torch.bfloat16
V, C, T, B = 5, 64, 16, 2
W0, Wp = V * C, 384
NAMES = ["x", "M", "bias_col", "g1", "b1", "taps", "cb", "g2", "b2"]


# ---------------------------------------------------------------------------
# the train layer's operands
# ---------------------------------------------------------------------------

def layer_args(seed, residual):
    """The f32 operands of one fused train layer, in ``NAMES`` order."""
    rng = np.random.RandomState(seed)
    x = np.zeros((B, T, Wp), np.float32)
    x[..., :W0] = rng.randn(B, T, W0) * 0.6
    if not residual:
        x = x[..., :W0].copy()  # block 0: the unpadded merged input
    M = np.zeros((Wp, Wp), np.float32)
    M[:W0, :W0] = rng.randn(W0, W0) * 0.04
    bias_col = np.zeros(Wp, np.float32)
    bias_col[:W0] = rng.randn(W0) * 0.1
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return [x, M, bias_col, 0.7 + rng.rand(C).astype(np.float32), f(C) * 0.2,
            f(3, C, C) * 0.15, f(C) * 0.1, 0.7 + rng.rand(C).astype(np.float32), f(C) * 0.2]


def bf16_round(a):
    """numpy f32 -> the same values rounded to bf16 (round to nearest even)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def bf16_layer_args(seed, residual):
    """``layer_args`` with x and M rounded to bf16 (the chain dtype), the
    rest f32."""
    args = layer_args(seed, residual)
    return [bf16_round(args[0]), bf16_round(args[1])] + args[2:]


def bf16_port_leaves(arrays):
    """x and M in bf16, the rest f32, each a leaf that takes a gradient."""
    return [torch.from_numpy(a.copy()).to(BF16 if i < 2 else torch.float32).requires_grad_()
            for i, a in enumerate(arrays)]


def assert_ulp_close(got, ref, what, share=1e-3):
    """Two bf16 arrays (as f32): within 1 bf16 ulp wherever |ref| is above
    1e-3 of its max, and at most ``share`` of the elements not bit-equal."""
    got, ref = f32(got), f32(ref)
    live = np.abs(ref) > 1e-3 * np.abs(ref).max()
    assert ulps(got[live], ref[live]) <= 1, what
    assert np.mean(ordinal(got) != ordinal(ref)) <= share, what


# ---------------------------------------------------------------------------
# 3xTF32 and the tensor cores' adds
# ---------------------------------------------------------------------------

KSTEP = 8  # depth of one m16n8k8 product


def rna_tf32(a):
    """f32 -> the nearest value with 10 explicit mantissa bits, ties away
    from zero (cvt.rna.tf32.f32), as f32."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a):
    a = np.asarray(a, dtype=np.float32)
    big = rna_tf32(a)
    return big, rna_tf32(a - big)


def kstep_accumulate(acc, a, b):
    """acc (f32) += one k-step as the kernel sums it: a (..., 8) @ b (..., 8, n)."""
    (ab, as_), (bb, bs) = split(a), split(b)

    def prod(x, y):
        return np.matmul(x.astype(np.float64), y.astype(np.float64))

    part = prod(as_, bb).astype(np.float32)
    part = (part + prod(ab, bs)).astype(np.float32)
    part = (part + prod(ab, bb)).astype(np.float32)
    return (acc + part).astype(np.float32)


def emulated_kernel_tconv(t1, KB, C=64):
    """The kernels' temporal conv of t1 (T, Wp): per joint, the three taps'
    diagonal C x C blocks at (col0 % 128), all 3 x C/8 k-steps into one
    accumulator, rows outside the clip zero."""
    T, Wp = t1.shape
    J = Wp // C
    zero = np.zeros((1, Wp), np.float32)
    shifted = [np.concatenate([zero, t1[:-1]]), t1, np.concatenate([t1[1:], zero])]
    acc = np.zeros((J, T, C), np.float32)
    for s in range(3):
        a = shifted[s].reshape(T, J, C).transpose(1, 0, 2)  # (J, T, C)
        taps = np.stack([KB[s, (j * C) % 128:(j * C) % 128 + C, (j * C) % 128:(j * C) % 128 + C]
                         for j in range(J)])  # (J, C, C)
        for k0 in range(0, C, KSTEP):
            acc = kstep_accumulate(acc, a[..., k0:k0 + KSTEP], taps[:, k0:k0 + KSTEP])
    return acc.transpose(1, 0, 2).reshape(T, Wp)


def truncate_f32(a):
    """float64 -> the f32 next to it toward zero (the tensor cores' adds)."""
    f = a.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(a), np.nextafter(f, np.float32(0)), f)


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
