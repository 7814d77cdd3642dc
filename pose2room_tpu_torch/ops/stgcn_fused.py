"""Fused ST-GCN block for the eval chain, on merged (B, T, V*C) activations.

Port of pose2room_tpu/ops/stgcn_fused.py.  One block at inference is, in the
folded form of models/layers.py:

    y1 = x @ M                      # graph conv, A folded into the weights
    t1 = relu(y1 * s1 + b1')        # eval BN1 (+ gcn bias folded into b1')
    y2 = temporal_conv3(t1)         # (3,1) conv over T, per joint C -> C
    out = relu(y2 * s2 + b2' [+ x]) # eval BN2 (+ conv bias) and residual

The JAX package leaves the graph matmul to XLA's dot.  Here, in f32 on a
card, the graph matmul with BN1 and the ReLU is the hand-written graph GEMM
(csrc/stgcn_graph_gemm.cu: 3xTF32 on ``wgmma``, its B operand Mᵀ split
into TF32 halves once at fold time by ``gemm_b_operand``); in bf16 it is
``torch.matmul`` on widened operands, and on the CPU the plain version
``graph_matmul_bn_relu``.  Everything after it is the hand-written CUDA
epilogue kernel (csrc/stgcn_epilogue.cu) on a card, and
``epilogue_merged_ref`` on the CPU.  The temporal conv is column-local in the
merged layout: a 128-column group is 128/C joints' channels, so it is three
block-diagonal 128x128 taps over row-shifted activations.

The chain runs in f32 or bf16 (``model.compute_dtype``).  In bf16, x, M,
t1, KB and out are bf16 and vecs f32; every product takes bf16 operands and
accumulates in f32 (bf16 x bf16 is exact in f32), BN and ReLU run in f32 and
each activation is rounded to bf16 once, as the JAX package's bf16 path
computes.  ``fused_epilogue`` launches each dtype's leg of the kernel.

Padding contract: the merged width 3392 = 53*64 pads to 3456 = 27*128.  Pad
rows/columns of M and pad entries of the per-column vectors are zero, so pad
columns stay exactly zero through the whole six-block chain.
"""

import ctypes

import torch

from pose2room_tpu_torch import kernels

LANE = 128
# rows of the per-column vector operand: [s1, b1', s2, b2', 0, 0, 0, 0]
N_VEC_ROWS = 8


def pad_merged(width):
    """Merged width rounded up to a lane multiple (3392 -> 3456)."""
    return ((width + LANE - 1) // LANE) * LANE


def block_diag_taps(taps):
    """(3, C, C) temporal taps (tap s applies to row t+s-1) -> (3, 128, 128)
    block-diagonal matrices: a 128-wide column group holds 128/C joints'
    channels, each mixed by the same (C, C) tap."""
    C = taps.shape[-1]
    eye = torch.eye(LANE // C, dtype=taps.dtype, device=taps.device)
    return torch.einsum("sio,pq->spiqo", taps, eye).reshape(3, LANE, LANE)


def shift_prev(h):
    """Row t holds row t-1 of h (B, T, W); zero at the first row (tap 0)."""
    return torch.cat([h.new_zeros(h.shape[0], 1, h.shape[2]), h[:, :-1]], dim=1)


def shift_next(h):
    """Row t holds row t+1 of h (B, T, W); zero at the last row (tap 2)."""
    return torch.cat([h[:, 1:], h.new_zeros(h.shape[0], 1, h.shape[2])], dim=1)


def widen(t):
    """bf16 -> f32 (value-exact, so products of bf16 operands are exact and
    accumulate in f32); any other dtype as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def tconv_group(h, tap):
    """Product of each 128-column group of h (B, T, Wp) with one (128, 128)
    tap; bf16 operands accumulate in f32."""
    B, T, Wp = h.shape
    return torch.matmul(widen(h).reshape(B, T, Wp // LANE, LANE), widen(tap)).reshape(B, T, Wp)


def graph_matmul_bn_relu(x, M, s1, b1):
    """relu((x @ M) * s1 + b1) in x's dtype: the graph matmul with an f32
    accumulator, then BN1 and ReLU in f32 and one cast (JAX
    stgcn_fused.py:59-80).  bf16 operands are widened to f32, where their
    products are exact: ``torch.matmul`` on bf16 would round the
    accumulator to bf16 before BN1.  x: (B, T, W); M: (W, Wp)."""
    return torch.relu(torch.matmul(widen(x), widen(M)) * s1 + b1).to(x.dtype)


def rna_tf32(t):
    """f32 -> the nearest TF32 value (10 explicit mantissa bits), ties away
    from zero, as f32: the integer add and mask of csrc/tconv_mma.cuh's
    ``rna_tf32`` on the bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def gemm_b_operand(M):
    """The graph GEMM's B operand from M (K, Ncols) f32: (2, Ncols, K), Mᵀ
    (K-major: row j holds column j of M along k) split into big =
    rna_tf32(m) and small = rna_tf32(m - big), the kernel's 3xTF32 split,
    big half first.  A function of the weights alone, so the fold builds it
    once; 2 x 47.8 MB a block at full width."""
    if M.dtype != torch.float32:
        raise TypeError(f"gemm_b_operand: M is {M.dtype}; the graph GEMM takes float32")
    mt = M.t().contiguous()
    big = rna_tf32(mt)
    return torch.stack([big, rna_tf32(mt - big)])


GEMM_COLS = 192  # output columns of a graph GEMM tile (csrc/stgcn_graph_gemm.cu: kBN): 3456 = 18 x 192
GEMM_K_STAGE = 32  # k of one stage (kBK): K must be a multiple


def check_graph_gemm_operands(x, b_split, s1, b1):
    """Before a launch of the graph GEMM: x (B, T, K) f32 with K a multiple
    of 32; b_split (2, Ncols, Kb) f32 with K <= Kb, Kb a multiple of 4 and
    Ncols of 192 (the kernel's tile: the merged width 3456 is 18 of them);
    s1, b1 (Ncols,) f32; each contiguous, on x's device and 16-byte aligned
    (TMA and float2 loads).  Raises ValueError / TypeError."""
    name = "stgcn_graph_gemm"
    if x.dim() != 3 or b_split.dim() != 3 or b_split.shape[0] != 2:
        raise ValueError(f"{name}: x {tuple(x.shape)} and b_split {tuple(b_split.shape)}: "
                         "expected (B, T, K) and (2, Ncols, Kb)")
    K, (_, Ncols, Kb) = x.shape[-1], b_split.shape
    if K % GEMM_K_STAGE or K > Kb or Kb % 4:
        raise ValueError(f"{name}: K = {K} with Kb = {Kb}: K must be a multiple of {GEMM_K_STAGE} "
                         "and at most Kb, Kb a multiple of 4")
    if Ncols % GEMM_COLS:
        raise ValueError(f"{name}: {Ncols} output columns is not a multiple of {GEMM_COLS}")
    kernels.check_operands(name, {"x": (x, tuple(x.shape)), "b_split": (b_split, (2, Ncols, Kb)),
                                  "s1": (s1, (Ncols,)), "b1": (b1, (Ncols,))}, x.device, align=16)


def graph_gemm_bn_relu(x, M, s1, b1, b_split=None):
    """relu((x @ M) * s1 + b1): the plain version on the CPU and for bf16
    (``graph_matmul_bn_relu``), the graph GEMM kernel for CUDA f32, which it
    launches or raises.  x: (B, T, K); M: (K, Ncols); s1, b1: (Ncols,).
    b_split: ``gemm_b_operand`` of M or of a matrix whose first K rows are
    M (the fold's, built once); None builds it from M here.  Returns
    (B, T, Ncols) in x's dtype."""
    if x.device.type == "cpu" or (x.device.type == "cuda" and x.dtype == torch.bfloat16):
        return graph_matmul_bn_relu(x, M, s1, b1)
    if x.device.type != "cuda":
        raise ValueError(f"no graph GEMM kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"stgcn_graph_gemm: x is {x.dtype}; the kernel takes float32 (bfloat16 takes torch.matmul)")
    if b_split is None:
        b_split = gemm_b_operand(M)
    check_graph_gemm_operands(x, b_split, s1, b1)
    B, T, K = x.shape
    Ncols, Kb = b_split.shape[1:]
    out = torch.empty(B, T, Ncols, dtype=x.dtype, device=x.device)
    fn = kernels.load("stgcn_graph_gemm").p2r_graph_gemm_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), b_split.data_ptr(), s1.data_ptr(), b1.data_ptr(), out.data_ptr(), B * T, K, Kb, Ncols,
             torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "stgcn_graph_gemm")
    kernels.LAUNCHES["stgcn_graph_gemm"] += 1
    return out


def epilogue_merged_ref(t1, x, vecs, KB, *, residual):
    """Plain PyTorch version of the epilogue kernel (same operands).

    t1: (B, T, Wp) f32 or bf16; x: block input of the same shape and dtype,
    read only when ``residual`` (pass None otherwise); vecs: (8, Wp) f32 rows
    [s1, b1', s2, b2', 0...]; KB: (3, 128, 128) temporal taps in t1's dtype,
    tap s applied to row t+s-1 with zero rows outside the clip.  The taps
    accumulate in f32, BN2, the residual (widened to f32) and ReLU run in
    f32, and the result is cast to t1's dtype once.
    """
    y2 = tconv_group(shift_prev(t1), KB[0]) + tconv_group(t1, KB[1]) + tconv_group(shift_next(t1), KB[2])
    out = y2 * vecs[2] + vecs[3]
    if residual:
        out = out + widen(x)
    return torch.relu(out).to(t1.dtype)


# each dtype's leg of the epilogue kernel: (launch-count name, C entry point)
EPILOGUE_LEGS = {
    torch.float32: ("stgcn_epilogue", "p2r_stgcn_epilogue_f32"),
    torch.bfloat16: ("stgcn_epilogue_bf16", "p2r_stgcn_epilogue_bf16"),
}


def fused_epilogue(t1, x, vecs, KB, *, residual):
    """tconv + BN2 + residual + ReLU: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Shapes as in ``epilogue_merged_ref``.

    The kernel reads only the 64x64 diagonal blocks of KB (one joint's
    channels); ``fold_eval_arrays`` builds KB block-diagonal, so both
    versions compute the same function.  t1's dtype (f32 or bf16) picks the
    kernel's leg; x and KB share it, vecs are f32.
    """
    if t1.device.type == "cpu":
        return epilogue_merged_ref(t1, x, vecs, KB, residual=residual)
    if t1.device.type != "cuda":
        raise ValueError(f"no epilogue kernel for device {t1.device}")
    if t1.dtype not in EPILOGUE_LEGS:
        raise TypeError(f"stgcn_epilogue: t1 is {t1.dtype}; the kernel takes float32 or bfloat16")
    name, entry = EPILOGUE_LEGS[t1.dtype]
    B, T, Wp = t1.shape
    if Wp % LANE:
        raise ValueError(f"merged width {Wp} is not a multiple of {LANE}")
    expect = {"t1": (t1, (B, T, Wp)), "KB": (KB, (3, LANE, LANE))}
    if residual:
        expect["x"] = (x, (B, T, Wp))
    kernels.check_operands(name, expect, t1.device, dtype=t1.dtype, align=16)
    kernels.check_operands(name, {"vecs": (vecs, (N_VEC_ROWS, Wp))}, t1.device, align=16)
    out = torch.empty_like(t1)
    fn = getattr(kernels.load("stgcn_epilogue"), entry)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        t1.data_ptr(), x.data_ptr() if residual else None, vecs.data_ptr(),
        KB.data_ptr(), out.data_ptr(), B, T, Wp, int(bool(residual)),
        torch.cuda.current_stream(t1.device).cuda_stream,
    )
    kernels.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out


def fused_stgcn_layer(x, M, vecs, KB, *, residual, b_split=None):
    """One ST-GCN block over merged activations: the graph matmul (f32
    accumulator; the graph GEMM kernel for CUDA f32, on ``b_split``, the
    fold's ``gemm_b_operand(M)``, or one built here when None) + the fused
    epilogue.

    x: (B, T, W) in the chain dtype (f32 or bf16; M and KB the same).  With ``residual`` W must equal Wp = M.shape[1] (pad
    columns zero); without, W may be the UNPADDED merged width: the matmul
    contracts against M's first W rows and never touches x again, so the
    first block needs no entry pad or copy.  Returns (B, T, Wp).
    """
    W = x.shape[-1]
    Wp = M.shape[1]
    if Wp % LANE or M.shape[0] != Wp:
        raise ValueError(f"M has shape {tuple(M.shape)}; expected square, lane-padded")
    if not (W == Wp or (not residual and W <= Wp)):
        raise ValueError(f"input width {W} does not fit M {tuple(M.shape)} (residual={residual})")
    t1 = graph_gemm_bn_relu(x, M[:W], vecs[0], vecs[1], b_split)
    return fused_epilogue(t1, x if residual else None, vecs, KB, residual=residual)


def stgcn_layer_merged_ref(x, M, vecs, KB, *, residual):
    """Plain version of ``fused_stgcn_layer`` (same operands, same math)."""
    W = x.shape[-1]
    t1 = graph_matmul_bn_relu(x, M[:W], vecs[0], vecs[1])
    return epilogue_merged_ref(t1, x if residual else None, vecs, KB, residual=residual)
