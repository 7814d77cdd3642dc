"""Fused ST-GCN block for the TRAIN path: hand-written backward through live
BatchNorm statistics, on merged (B, T, V*C) activations.

Port of pose2room_tpu/ops/stgcn_train.py.  One block, in the folded merged
form of models/layers.py:STGCNBlock:

    y   = x @ M + bias_col                  # folded graph conv (torch.matmul, f32)
    n1  = (y - mean1) * rsqrt(var1 + eps)   # LIVE batch stats over (B, T, V)
    t1  = relu(g1 * n1 + b1)
    y2  = tconv3(t1) + cb                   # (3,1) conv == block-diagonal taps
    n2  = (y2 - mean2) * rsqrt(var2 + eps)  # live stats again
    out = relu(g2 * n2 + b2 [+ x])          # identity residual

Division of labour, as in the JAX package: the large matmuls (forward x@M,
backward dy@M^T and x^T@dy) go to ``torch.matmul`` with TF32 off; the
temporal conv with its BN affine and column statistics, and its transpose
with the ReLU mask and the tap gradient, are the hand-written CUDA kernels
``csrc/stgcn_train_fwd.cu`` and ``csrc/stgcn_train_bwd.cu``.  Their plain
PyTorch versions, ``tconv_stats_fwd_ref`` and ``tconv_bwd_ref``, sit beside
them: the wrappers take them for CPU tensors, the tests compare against them.

BN statistics are per channel, from per-COLUMN moments: the merged layout is
joint-major (v*C + c), so a (Wp/C, C) reshape folds columns into channels.
Variance is the biased E[x^2] - E[x]^2, clamped at 0, as flax computes it.

The chain runs in f32 or bf16 (``model.compute_dtype``), rounding where
the JAX package's bf16 path rounds and nowhere else (JAX stgcn_train.py
fwd_impl / bwd_impl): x, M, y, t1, y2, out, dy2, dpre and the taps of the
kernels are in the chain dtype; every product takes operands of that dtype
into an f32 accumulator (bf16 x bf16 is exact in f32, so bf16 operands are
widened for ``torch.matmul``), BN statistics and their backward run in f32
from the rounded activations, and parameters, statistics and the per-column
vectors stay f32.  On f32 every rounding cast is a no-op.  The wrappers
launch each dtype's leg of the kernels.

Data parallel: inside a process group the statistics are those of the
global batch, as in the JAX package's sharded step.  Before each set of
statistics is formed its column (or channel) sums are summed over the ranks,
one all-reduce of the two packed vectors a set: BN1's [sum y, sum y^2],
kernel 3's summed parts, the BN2 backward's [sum dz, sum dz*y2] and kernel
4's summed parts, four a block; the count is every rank's rows (each holds
a batch of one size).  The activation gradients dy2 and dyf use the global
sums; the parameter gradients of g1, b1, g2, b2 are formed from this rank's
own sums, since DDP sums them over the ranks afterwards (SyncBatchNorm's
split).  The kernels take the same operands as in one process.

Padding contract (as the eval chain): the merged width 3392 pads to 3456;
pad rows/columns of M and pad entries of every per-column vector are zero,
so pad columns stay exactly zero forward and backward.
"""

import ctypes

import torch
import torch.nn.functional as F

from pose2room_tpu_torch import kernels
from pose2room_tpu_torch.parallel.collectives import all_reduce_sum_, data_count, in_group
from pose2room_tpu_torch.ops.stgcn_fused import (
    LANE,
    block_diag_taps,
    shift_next,
    shift_prev,
    tconv_group,
    widen,
)

BN_EPS = 1e-5
# csrc/stgcn_train_{fwd,bwd}.cu: one 64-wide column group (one joint's
# channels) per tile; column partials per 64-row part (both kernels compute
# 128-row tiles and write two rows of partials each)
KERNEL_C = 64
ROW_TILE = 64
# the plain versions also take float64 on the CPU (the float64 referees)
PLAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def _tile_cols(vec_c, V, C, Wp):
    """(C,) per-channel -> (Wp,) per-column, zero on padded groups."""
    return F.pad(vec_c.repeat(V), (0, Wp - V * C))


def _chan_sum(col_vec, C):
    """(Wp,) per-column sums -> (C,) per-channel (pad groups are zero)."""
    return col_vec.reshape(-1, C).sum(0)


def _global(*vecs):
    """The vectors summed over the ranks that hold other rows (the data
    group), in one all-reduce (themselves outside a process group)."""
    if not in_group():
        return vecs
    return all_reduce_sum_(torch.stack(vecs)).unbind(0)


def _stats_from_cols(colsum, colsumsq, count, C):
    mean = _chan_sum(colsum, C) / count
    var = torch.clamp(_chan_sum(colsumsq, C) / count - mean * mean, min=0.0)
    return mean, var


def _fold_diag_blocks(m, C):
    """(3, 128, 128) dense tap gradient -> (3, C, C) sum of its diagonal blocks."""
    out = 0.0
    for p in range(LANE // C):
        out = out + m[:, p * C : (p + 1) * C, p * C : (p + 1) * C]
    return out


# ---------------------------------------------------------------------------
# kernel 3: BN1 affine + ReLU + tconv (+cb) + column partial moments
# ---------------------------------------------------------------------------

def tconv_stats_fwd_ref(y, vecs, KB, *, T):
    """Plain PyTorch version of the forward kernel.

    y: (N, Wp) graph-conv output (+bias) in the chain dtype, N = B*T; vecs:
    (4, Wp) f32 rows [s1col, sh1col, cbcol, 0] (BN1 as an affine of the live
    stats); KB: (3, 128, 128) block-diagonal taps in y's dtype, tap s applied
    to row t+s-1 with zero rows outside the clip.  t1 = relu(y * s1 + sh1) in
    f32, rounded to y's dtype; y2 = the taps' f32 sum + cb, rounded to y's
    dtype.  Returns (y2 (N, Wp), parts (B, 2, Wp) f32) with parts[b] =
    per-column [sum(y2), sum(y2^2)] over clip b of the ROUNDED y2.
    """
    N, Wp = y.shape
    B = N // T
    t1 = torch.relu(widen(y).reshape(B, T, Wp) * vecs[0] + vecs[1]).to(y.dtype)
    y2 = (tconv_group(shift_prev(t1), KB[0]) + tconv_group(t1, KB[1])
          + tconv_group(shift_next(t1), KB[2]) + vecs[2]).to(y.dtype)
    y2f = widen(y2)
    parts = torch.stack([y2f.sum(1), (y2f * y2f).sum(1)], dim=1)
    return y2.reshape(N, Wp), parts


def _check_layout(N, Wp, T):
    if Wp % LANE:
        raise ValueError(f"merged width {Wp} is not a multiple of {LANE}")
    if T <= 0 or N % T:
        raise ValueError(f"{N} rows are not whole clips of T={T}")


def _check_dtype(name, t, legs):
    """The leg of kernel ``name`` for t's dtype: (launch-count name, C entry
    point[, blocks entry point]), or None on the CPU (the plain version)."""
    if t.dtype not in PLAIN_DTYPES:
        raise TypeError(f"{name}: operands are {t.dtype}; the kernel takes float32 or bfloat16")
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {t.device}")
    if t.dtype not in legs:
        raise TypeError(f"{name}: operands are {t.dtype}; the kernel takes float32 or bfloat16")
    return legs[t.dtype]


# each dtype's leg of kernel 3: (launch-count name, C entry point)
TRAIN_FWD_LEGS = {
    torch.float32: ("stgcn_train_fwd", "p2r_stgcn_train_fwd_f32"),
    torch.bfloat16: ("stgcn_train_fwd_bf16", "p2r_stgcn_train_fwd_bf16"),
}


def tconv_stats_fwd(y, vecs, KB, *, T):
    """Kernel 3 for CUDA tensors, ``tconv_stats_fwd_ref`` for CPU tensors.

    y's dtype (f32 or bf16) picks the kernel's leg; KB shares it, vecs are
    f32.  The kernel reads only the 64x64 diagonal blocks of KB (one joint's
    channels), which ``block_diag_taps`` makes the only nonzero ones; it
    writes per-(clip, 64-row tile) column partials in f32, reduced here over
    the tiles in a fixed order.
    """
    leg = _check_dtype("stgcn_train_fwd", y, TRAIN_FWD_LEGS)
    if leg is None:
        return tconv_stats_fwd_ref(y, vecs, KB, T=T)
    name, entry = leg
    N, Wp = y.shape
    _check_layout(N, Wp, T)
    kernels.check_operands(name, {"y": (y, (N, Wp)), "KB": (KB, (3, LANE, LANE))},
                           y.device, dtype=y.dtype, align=16)
    kernels.check_operands(name, {"vecs": (vecs, (4, Wp))}, y.device, align=16)
    B = N // T
    n_tiles = -(-T // ROW_TILE)
    y2 = torch.empty_like(y)
    tile_parts = torch.empty((B, n_tiles, 2, Wp), dtype=torch.float32, device=y.device)
    fn = getattr(kernels.load("stgcn_train_fwd"), entry)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(y.data_ptr(), vecs.data_ptr(), KB.data_ptr(), y2.data_ptr(), tile_parts.data_ptr(),
             B, T, Wp, torch.cuda.current_stream(y.device).cuda_stream)
    kernels.check(err, name)
    kernels.LAUNCHES[name] += 1
    return y2, tile_parts.sum(dim=1)


# ---------------------------------------------------------------------------
# kernel 4: tconv transpose + ReLU mask + BN1 partials + tap gradient
# ---------------------------------------------------------------------------

def tconv_bwd_ref(dy2, y, vecs, KBT, *, T):
    """Plain PyTorch version of the backward kernel.

    dy2: (N, Wp) cotangent of the conv output; y: (N, Wp) saved graph-conv
    output (t1 and the ReLU mask are recomputed from it), both in the chain
    dtype; vecs: (4, Wp) f32 rows [s1col, sh1col, 0, 0]; KBT: (3, 128, 128)
    TRANSPOSED block-diagonal taps in the chain dtype.  dt1 = tconv^T(dy2)
    and the tap gradient accumulate in f32 from chain-dtype operands (t1 is
    rounded to the chain dtype for the tap gradient; the mask is pre > 0 in
    f32).  Returns (dpre (N, Wp) = mask * dt1 rounded to the chain dtype,
    parts (B, 2, Wp) f32 per-column [sum(dpre), sum(dpre * y)] per clip of
    the UNROUNDED dpre, dkb (3, 128, 128) f32 with dkb[s] = shift_s(t1)^T @
    dy2 summed over every clip and column group).
    """
    N, Wp = y.shape
    B = N // T
    G = Wp // LANE
    y3 = widen(y).reshape(B, T, Wp)
    t1 = torch.relu(y3 * vecs[0] + vecs[1])
    d3 = dy2.reshape(B, T, Wp)
    dt1 = (tconv_group(shift_next(d3), KBT[0]) + tconv_group(d3, KBT[1])
           + tconv_group(shift_prev(d3), KBT[2]))
    dpre = torch.where(t1 > 0.0, dt1, torch.zeros_like(dt1))
    parts = torch.stack([dpre.sum(1), (dpre * y3).sum(1)], dim=1)
    dg = widen(d3).reshape(B, T, G, LANE)
    t1 = t1.to(y.dtype)

    def dkb_of(th):
        return torch.einsum("btgk,btgo->bgko", widen(th).reshape(B, T, G, LANE), dg).sum((0, 1))

    dkb = torch.stack([dkb_of(shift_prev(t1)), dkb_of(t1), dkb_of(shift_next(t1))])
    return dpre.reshape(N, Wp).to(y.dtype), parts, dkb


# each dtype's leg of kernel 4: (launch-count name, C entry point, its grid's entry point)
TRAIN_BWD_LEGS = {
    torch.float32: ("stgcn_train_bwd", "p2r_stgcn_train_bwd_f32", "p2r_stgcn_train_bwd_blocks"),
    torch.bfloat16: ("stgcn_train_bwd_bf16", "p2r_stgcn_train_bwd_bf16", "p2r_stgcn_train_bwd_bf16_blocks"),
}


def tconv_bwd(dy2, y, vecs, KBT, *, T, C):
    """Kernel 4 for CUDA tensors, ``tconv_bwd_ref`` for CPU tensors.

    y's dtype (f32 or bf16) picks the kernel's leg; dy2 and KBT share it,
    vecs are f32.  Returns (dpre (N, Wp) in y's dtype, parts (B, 2, Wp) f32,
    dtaps (3, C, C) f32), dtaps being ``_fold_diag_blocks`` of the dense tap
    gradient.  The kernel computes the diagonal blocks only: each block of
    its persistent grid writes one partial of the (3, 64, 64) tap gradient
    over the tiles it walked, and this wrapper reduces them, and the
    per-(clip, 64-row part) column partials, with a fixed-order
    ``torch.sum`` (no float atomics, so repeated runs agree bit for bit).
    """
    leg = _check_dtype("stgcn_train_bwd", y, TRAIN_BWD_LEGS)
    if leg is None:
        dpre, parts, dkb = tconv_bwd_ref(dy2, y, vecs, KBT, T=T)
        return dpre, parts, _fold_diag_blocks(dkb, C)
    name, entry, blocks_entry = leg
    if C != KERNEL_C:
        raise ValueError(f"the train backward kernel takes {KERNEL_C} channels per joint, not {C}")
    N, Wp = y.shape
    _check_layout(N, Wp, T)
    kernels.check_operands(name, {
        "dy2": (dy2, (N, Wp)), "y": (y, (N, Wp)), "KBT": (KBT, (3, LANE, LANE)),
    }, y.device, dtype=y.dtype, align=16)
    kernels.check_operands(name, {"vecs": (vecs, (4, Wp))}, y.device, align=16)
    B = N // T
    lib = kernels.load("stgcn_train_bwd")
    blocks_fn = getattr(lib, blocks_entry)
    blocks_fn.argtypes = [ctypes.c_int] * 3
    blocks_fn.restype = ctypes.c_int
    blocks = blocks_fn(B, T, Wp)
    kernels.check(-min(blocks, 0), name)  # a negative count is -cudaError
    dpre = torch.empty_like(y)
    tile_parts = torch.empty((B, -(-T // ROW_TILE), 2, Wp), dtype=torch.float32, device=y.device)
    tap_parts = torch.empty((blocks, 3, KERNEL_C, KERNEL_C), dtype=torch.float32, device=y.device)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(dy2.data_ptr(), y.data_ptr(), vecs.data_ptr(), KBT.data_ptr(), dpre.data_ptr(),
             tile_parts.data_ptr(), tap_parts.data_ptr(), B, T, Wp, blocks,
             torch.cuda.current_stream(y.device).cuda_stream)
    kernels.check(err, name)
    kernels.LAUNCHES[name] += 1
    return dpre, tile_parts.sum(dim=1), tap_parts.sum(dim=0)


# ---------------------------------------------------------------------------
# the block: forward, hand-written backward, and its autograd-able reference
# ---------------------------------------------------------------------------

def _layer_forward(x, M, bias_col, g1, b1, taps, cb, g2, b2, *, residual, V, C, T, tconv_fwd):
    """Forward of one fused train block (the JAX ``fwd_impl``).

    Returns ((out, mean1, var1, mean2, var2), (y, y2)), with y and y2 as
    (N, Wp) for the backward.  ``tconv_fwd`` is the kernel wrapper or its
    plain version.  x and M are in the chain dtype: y = x @ M + bias_col
    with an f32 accumulator is rounded to it once, and BN1's statistics come
    from the rounded y; z = BN2(y2) [+ x] runs in f32 and out = relu(z) is
    rounded once.
    """
    B, Tx, W = x.shape
    Wp = M.shape[1]
    N = B * Tx
    cnt = N * V * data_count()
    y = (torch.matmul(widen(x), widen(M[:W])) + bias_col).to(x.dtype)  # (B, T, Wp)
    yf = widen(y)
    mean1, var1 = _stats_from_cols(*_global(yf.sum((0, 1)), (yf * yf).sum((0, 1))), cnt, C)
    s1 = g1 * torch.rsqrt(var1 + BN_EPS)
    s1col = _tile_cols(s1, V, C, Wp)
    vecs = torch.stack([s1col, _tile_cols(b1 - mean1 * s1, V, C, Wp),
                        _tile_cols(cb, V, C, Wp), torch.zeros_like(s1col)])
    y = y.reshape(N, Wp)
    y2, parts = tconv_fwd(y, vecs, block_diag_taps(taps.to(x.dtype)).contiguous(), T=T)
    mean2, var2 = _stats_from_cols(*_global(parts[:, 0].sum(0), parts[:, 1].sum(0)), cnt, C)
    s2 = g2 * torch.rsqrt(var2 + BN_EPS)
    z = widen(y2).reshape(B, Tx, Wp) * _tile_cols(s2, V, C, Wp) + _tile_cols(b2 - mean2 * s2, V, C, Wp)
    if residual:
        z = z + widen(x)
    return (torch.relu(z).to(x.dtype), mean1, var1, mean2, var2), (y, y2)


class FusedTrainLayer(torch.autograd.Function):
    """One ST-GCN block in train mode: the JAX ``make_train_layer``.

    ``FusedTrainLayer.apply(x, M, bias_col, g1, b1, taps, cb, g2, b2,
    residual, V, C, T)`` -> (out (B, T, Wp), mean1, var1, mean2, var2).

    x: (B, T, W) in the chain dtype (f32 or bf16); W may be the UNPADDED
    merged width when there is no residual (block 0): the matmul contracts
    against M's first W rows.  M: (Wp, Wp) padded folded graph matrix in the
    chain dtype; bias_col: (Wp,); g1, b1, cb, g2, b2: (C,); taps: (3, C, C)
    as (tap, in, out), all f32.  out is in the chain dtype, the statistics
    f32.  The batch statistics are outputs for the running-average update
    only and take no gradient.  The conv bias gets the analytic zero: BN2
    absorbs any per-channel shift.  The backward runs in f32 and rounds
    where the JAX ``bwd_impl`` rounds: dy2 and the BN1 input gradient to the
    chain dtype before the kernel and the matmuls, dx and dM to x's and M's
    dtype at the end.
    """

    @staticmethod
    def forward(ctx, x, M, bias_col, g1, b1, taps, cb, g2, b2, residual, V, C, T):
        outs, (y, y2) = _layer_forward(
            x, M, bias_col, g1, b1, taps, cb, g2, b2,
            residual=residual, V=V, C=C, T=T, tconv_fwd=tconv_stats_fwd,
        )
        out, mean1, var1, mean2, var2 = outs
        ctx.save_for_backward(x, y, y2, mean1, var1, mean2, var2, M, taps, g1, b1, g2, b2)
        ctx.residual, ctx.V, ctx.C, ctx.T = residual, V, C, T
        ctx.mark_non_differentiable(mean1, var1, mean2, var2)
        return outs

    @staticmethod
    def backward(ctx, dout, *stat_grads):
        x, y, y2, mean1, var1, mean2, var2, M, taps, g1, b1, g2, b2 = ctx.saved_tensors
        V, C, T = ctx.V, ctx.C, ctx.T
        B, Tx, W = x.shape
        Wp = M.shape[1]
        N = B * Tx
        cnt = N * V * data_count()
        dt = x.dtype
        dout = widen(dout)

        def cols(v):
            return _tile_cols(v, V, C, Wp)

        inv1 = torch.rsqrt(var1 + BN_EPS)
        inv2 = torch.rsqrt(var2 + BN_EPS)
        s1col = cols(g1 * inv1)
        sh1col = cols(b1 - mean1 * g1 * inv1)
        s2col = cols(g2 * inv2)

        # BN2 backward through the ReLU (and the residual branch)
        y2f = widen(y2).reshape(B, Tx, Wp)
        z = y2f * s2col + cols(b2 - mean2 * g2 * inv2)
        if ctx.residual:
            z = z + widen(x)
        dz = torch.where(z > 0.0, dout, torch.zeros_like(dout))
        sum_dz_c = _chan_sum(dz.sum((0, 1)), C)
        sum_dzy2_c = _chan_sum((dz * y2f).sum((0, 1)), C)
        # the parameter gradients from this rank's sums (DDP sums them), the
        # activation gradient from the global ones
        dg2 = inv2 * (sum_dzy2_c - mean2 * sum_dz_c)
        db2 = sum_dz_c
        sum_dz_c, sum_dzy2_c = _global(sum_dz_c, sum_dzy2_c)
        n2 = (y2f - cols(mean2)) * cols(inv2)
        mdzn2_col = cols((sum_dzy2_c / cnt - mean2 * (sum_dz_c / cnt)) * inv2)
        dy2 = s2col * (dz - cols(sum_dz_c / cnt) - n2 * mdzn2_col)
        dcb = torch.zeros_like(g2)

        # kernel 4: tconv transpose, ReLU mask, BN1 partials, tap gradient
        vecs = torch.stack([s1col, sh1col, torch.zeros_like(s1col), torch.zeros_like(s1col)])
        KBT = block_diag_taps(taps.to(dt)).transpose(1, 2).contiguous()
        dpre, parts, dtaps = tconv_bwd(dy2.to(dt).reshape(N, Wp), y, vecs, KBT, T=T, C=C)
        dtaps = dtaps.to(taps.dtype)

        # BN1 backward, from the rounded dpre; the bias gradient from the f32 dyf
        sum_dp_c = _chan_sum(parts[:, 0].sum(0), C)
        sum_dpy_c = _chan_sum(parts[:, 1].sum(0), C)
        dg1 = inv1 * (sum_dpy_c - mean1 * sum_dp_c)
        db1 = sum_dp_c
        sum_dp_c, sum_dpy_c = _global(sum_dp_c, sum_dpy_c)
        n1 = (widen(y).reshape(B, Tx, Wp) - cols(mean1)) * cols(inv1)
        mdpn1_col = cols((sum_dpy_c / cnt - mean1 * (sum_dp_c / cnt)) * inv1)
        dyf = s1col * (widen(dpre).reshape(B, Tx, Wp) - cols(sum_dp_c / cnt) - n1 * mdpn1_col)
        dbias_col = dyf.sum((0, 1))
        dy = widen(dyf.to(dt))

        dx = torch.matmul(dy, widen(M[:W]).t())
        if ctx.residual:
            dx = dx + dz
        dM = torch.matmul(widen(x).reshape(N, W).t(), dy.reshape(N, Wp))
        if W < Wp:
            dM = F.pad(dM, (0, 0, 0, Wp - W))
        return (dx.to(dt), dM.to(M.dtype), dbias_col, dg1, db1, dtaps, dcb, dg2, db2,
                None, None, None, None)


def train_layer_ref(x, M, bias_col, g1, b1, taps, cb, g2, b2, residual, V, C, T):
    """The same forward as ``FusedTrainLayer`` from the plain versions only,
    for torch autograd to differentiate (the JAX ``custom_vjp=False``
    counterpart).  Same arguments and outputs.  One process only: in a
    process group its statistics are summed across ranks out of autograd's
    sight."""
    outs, _ = _layer_forward(
        x, M, bias_col, g1, b1, taps, cb, g2, b2,
        residual=residual, V=V, C=C, T=T, tconv_fwd=tconv_stats_fwd_ref,
    )
    return outs
