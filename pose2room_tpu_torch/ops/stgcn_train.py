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

Padding contract (as the eval chain): the merged width 3392 pads to 3456;
pad rows/columns of M and pad entries of every per-column vector are zero,
so pad columns stay exactly zero forward and backward.
"""

import ctypes

import torch
import torch.nn.functional as F

from pose2room_tpu_torch import kernels
from pose2room_tpu_torch.ops.stgcn_fused import (
    LANE,
    block_diag_taps,
    shift_next,
    shift_prev,
    tconv_group,
)

BN_EPS = 1e-5
# csrc/stgcn_train_{fwd,bwd}.cu: one 64-wide column group (one joint's
# channels) per tile; column partials per 64-row part (both kernels compute
# 128-row tiles and write two rows of partials each)
KERNEL_C = 64
ROW_TILE = 64


def _tile_cols(vec_c, V, C, Wp):
    """(C,) per-channel -> (Wp,) per-column, zero on padded groups."""
    return F.pad(vec_c.repeat(V), (0, Wp - V * C))


def _chan_sum(col_vec, C):
    """(Wp,) per-column sums -> (C,) per-channel (pad groups are zero)."""
    return col_vec.reshape(-1, C).sum(0)


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

    y: (N, Wp) f32 graph-conv output (+bias), N = B*T; vecs: (4, Wp) rows
    [s1col, sh1col, cbcol, 0] (BN1 as an affine of the live stats); KB:
    (3, 128, 128) block-diagonal taps, tap s applied to row t+s-1 with zero
    rows outside the clip.  Returns (y2 (N, Wp), parts (B, 2, Wp)) with
    parts[b] = per-column [sum(y2), sum(y2^2)] over clip b.
    """
    N, Wp = y.shape
    B = N // T
    t1 = torch.relu(y.reshape(B, T, Wp) * vecs[0] + vecs[1])
    y2 = (tconv_group(shift_prev(t1), KB[0]) + tconv_group(t1, KB[1])
          + tconv_group(shift_next(t1), KB[2]) + vecs[2])
    parts = torch.stack([y2.sum(1), (y2 * y2).sum(1)], dim=1)
    return y2.reshape(N, Wp), parts


def _check_layout(N, Wp, T):
    if Wp % LANE:
        raise ValueError(f"merged width {Wp} is not a multiple of {LANE}")
    if T <= 0 or N % T:
        raise ValueError(f"{N} rows are not whole clips of T={T}")


def tconv_stats_fwd(y, vecs, KB, *, T):
    """Kernel 3 for CUDA tensors, ``tconv_stats_fwd_ref`` for CPU tensors.

    The kernel reads only the 64x64 diagonal blocks of KB (one joint's
    channels), which ``block_diag_taps`` makes the only nonzero ones; it
    writes per-(clip, 64-row tile) column partials, reduced here over the
    tiles in a fixed order.
    """
    if y.device.type == "cpu":
        return tconv_stats_fwd_ref(y, vecs, KB, T=T)
    if y.device.type != "cuda":
        raise ValueError(f"no train forward kernel for device {y.device}")
    N, Wp = y.shape
    _check_layout(N, Wp, T)
    kernels.check_operands("stgcn_train_fwd", {
        "y": (y, (N, Wp)), "vecs": (vecs, (4, Wp)), "KB": (KB, (3, LANE, LANE)),
    }, y.device, align=16)
    B = N // T
    n_tiles = -(-T // ROW_TILE)
    y2 = torch.empty_like(y)
    tile_parts = torch.empty((B, n_tiles, 2, Wp), dtype=torch.float32, device=y.device)
    fn = kernels.load("stgcn_train_fwd").p2r_stgcn_train_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(y.data_ptr(), vecs.data_ptr(), KB.data_ptr(), y2.data_ptr(), tile_parts.data_ptr(),
             B, T, Wp, torch.cuda.current_stream(y.device).cuda_stream)
    kernels.check(err, "stgcn_train_fwd")
    kernels.LAUNCHES["stgcn_train_fwd"] += 1
    return y2, tile_parts.sum(dim=1)


# ---------------------------------------------------------------------------
# kernel 4: tconv transpose + ReLU mask + BN1 partials + tap gradient
# ---------------------------------------------------------------------------

def tconv_bwd_ref(dy2, y, vecs, KBT, *, T):
    """Plain PyTorch version of the backward kernel.

    dy2: (N, Wp) cotangent of the conv output; y: (N, Wp) saved graph-conv
    output (t1 and the ReLU mask are recomputed from it); vecs: (4, Wp) rows
    [s1col, sh1col, 0, 0]; KBT: (3, 128, 128) TRANSPOSED block-diagonal taps.
    Returns (dpre (N, Wp) = mask * tconv^T(dy2), parts (B, 2, Wp) per-column
    [sum(dpre), sum(dpre * y)] per clip, dkb (3, 128, 128) with
    dkb[s] = shift_s(t1)^T @ dy2 summed over every clip and column group).
    """
    N, Wp = y.shape
    B = N // T
    G = Wp // LANE
    y3 = y.reshape(B, T, Wp)
    t1 = torch.relu(y3 * vecs[0] + vecs[1])
    d3 = dy2.reshape(B, T, Wp)
    dt1 = (tconv_group(shift_next(d3), KBT[0]) + tconv_group(d3, KBT[1])
           + tconv_group(shift_prev(d3), KBT[2]))
    dpre = torch.where(t1 > 0.0, dt1, torch.zeros_like(dt1))
    parts = torch.stack([dpre.sum(1), (dpre * y3).sum(1)], dim=1)
    dg = d3.reshape(B, T, G, LANE)

    def dkb_of(th):
        return torch.einsum("btgk,btgo->bgko", th.reshape(B, T, G, LANE), dg).sum((0, 1))

    dkb = torch.stack([dkb_of(shift_prev(t1)), dkb_of(t1), dkb_of(shift_next(t1))])
    return dpre.reshape(N, Wp), parts, dkb


def tconv_bwd(dy2, y, vecs, KBT, *, T, C):
    """Kernel 4 for CUDA tensors, ``tconv_bwd_ref`` for CPU tensors.

    Returns (dpre (N, Wp), parts (B, 2, Wp), dtaps (3, C, C)), dtaps being
    ``_fold_diag_blocks`` of the dense tap gradient.  The kernel computes the
    diagonal blocks only: each block of its persistent grid writes one
    partial of the (3, 64, 64) tap gradient over the tiles it walked, and
    this wrapper reduces them, and the per-(clip, 64-row part) column
    partials, with a fixed-order ``torch.sum`` (no float atomics, so
    repeated runs agree bit for bit).
    """
    if y.device.type == "cpu":
        dpre, parts, dkb = tconv_bwd_ref(dy2, y, vecs, KBT, T=T)
        return dpre, parts, _fold_diag_blocks(dkb, C)
    if y.device.type != "cuda":
        raise ValueError(f"no train backward kernel for device {y.device}")
    if C != KERNEL_C:
        raise ValueError(f"the train backward kernel takes {KERNEL_C} channels per joint, not {C}")
    N, Wp = y.shape
    _check_layout(N, Wp, T)
    kernels.check_operands("stgcn_train_bwd", {
        "dy2": (dy2, (N, Wp)), "y": (y, (N, Wp)), "vecs": (vecs, (4, Wp)),
        "KBT": (KBT, (3, LANE, LANE)),
    }, y.device, align=16)
    B = N // T
    lib = kernels.load("stgcn_train_bwd")
    blocks_fn = lib.p2r_stgcn_train_bwd_blocks
    blocks_fn.argtypes = [ctypes.c_int] * 3
    blocks_fn.restype = ctypes.c_int
    blocks = blocks_fn(B, T, Wp)
    kernels.check(-min(blocks, 0), "stgcn_train_bwd")  # a negative count is -cudaError
    dpre = torch.empty_like(y)
    tile_parts = torch.empty((B, -(-T // ROW_TILE), 2, Wp), dtype=torch.float32, device=y.device)
    tap_parts = torch.empty((blocks, 3, KERNEL_C, KERNEL_C), dtype=torch.float32, device=y.device)
    fn = lib.p2r_stgcn_train_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(dy2.data_ptr(), y.data_ptr(), vecs.data_ptr(), KBT.data_ptr(), dpre.data_ptr(),
             tile_parts.data_ptr(), tap_parts.data_ptr(), B, T, Wp, blocks,
             torch.cuda.current_stream(y.device).cuda_stream)
    kernels.check(err, "stgcn_train_bwd")
    kernels.LAUNCHES["stgcn_train_bwd"] += 1
    return dpre, tile_parts.sum(dim=1), tap_parts.sum(dim=0)


# ---------------------------------------------------------------------------
# the block: forward, hand-written backward, and its autograd-able reference
# ---------------------------------------------------------------------------

def _layer_forward(x, M, bias_col, g1, b1, taps, cb, g2, b2, *, residual, V, C, T, tconv_fwd):
    """Forward of one fused train block (the JAX ``fwd_impl``).

    Returns ((out, mean1, var1, mean2, var2), (y, y2)), with y and y2 as
    (N, Wp) for the backward.  ``tconv_fwd`` is the kernel wrapper or its
    plain version.
    """
    B, Tx, W = x.shape
    Wp = M.shape[1]
    N = B * Tx
    cnt = N * V
    y = torch.matmul(x, M[:W]) + bias_col  # (B, T, Wp), f32 accumulation
    mean1, var1 = _stats_from_cols(y.sum((0, 1)), (y * y).sum((0, 1)), cnt, C)
    s1 = g1 * torch.rsqrt(var1 + BN_EPS)
    s1col = _tile_cols(s1, V, C, Wp)
    vecs = torch.stack([s1col, _tile_cols(b1 - mean1 * s1, V, C, Wp),
                        _tile_cols(cb, V, C, Wp), torch.zeros_like(s1col)])
    y = y.reshape(N, Wp)
    y2, parts = tconv_fwd(y, vecs, block_diag_taps(taps).contiguous(), T=T)
    mean2, var2 = _stats_from_cols(parts[:, 0].sum(0), parts[:, 1].sum(0), cnt, C)
    s2 = g2 * torch.rsqrt(var2 + BN_EPS)
    z = y2.reshape(B, Tx, Wp) * _tile_cols(s2, V, C, Wp) + _tile_cols(b2 - mean2 * s2, V, C, Wp)
    if residual:
        z = z + x
    return (torch.relu(z), mean1, var1, mean2, var2), (y, y2)


class FusedTrainLayer(torch.autograd.Function):
    """One ST-GCN block in train mode: the JAX ``make_train_layer``.

    ``FusedTrainLayer.apply(x, M, bias_col, g1, b1, taps, cb, g2, b2,
    residual, V, C, T)`` -> (out (B, T, Wp), mean1, var1, mean2, var2).

    x: (B, T, W) f32; W may be the UNPADDED merged width when there is no
    residual (block 0): the matmul contracts against M's first W rows.
    M: (Wp, Wp) padded folded graph matrix; bias_col: (Wp,); g1, b1, cb, g2,
    b2: (C,); taps: (3, C, C) as (tap, in, out).  The batch statistics are
    outputs for the running-average update only and take no gradient.  The
    conv bias gets the analytic zero: BN2 absorbs any per-channel shift.
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
        cnt = N * V

        def cols(v):
            return _tile_cols(v, V, C, Wp)

        inv1 = torch.rsqrt(var1 + BN_EPS)
        inv2 = torch.rsqrt(var2 + BN_EPS)
        s1col = cols(g1 * inv1)
        sh1col = cols(b1 - mean1 * g1 * inv1)
        s2col = cols(g2 * inv2)

        # BN2 backward through the ReLU (and the residual branch)
        y2f = y2.reshape(B, Tx, Wp)
        z = y2f * s2col + cols(b2 - mean2 * g2 * inv2)
        if ctx.residual:
            z = z + x
        dz = torch.where(z > 0.0, dout, torch.zeros_like(dout))
        sum_dz_c = _chan_sum(dz.sum((0, 1)), C)
        sum_dzy2_c = _chan_sum((dz * y2f).sum((0, 1)), C)
        dg2 = inv2 * (sum_dzy2_c - mean2 * sum_dz_c)
        db2 = sum_dz_c
        n2 = (y2f - cols(mean2)) * cols(inv2)
        mdzn2_col = cols((sum_dzy2_c / cnt - mean2 * (sum_dz_c / cnt)) * inv2)
        dy2 = s2col * (dz - cols(sum_dz_c / cnt) - n2 * mdzn2_col)
        dcb = torch.zeros_like(g2)

        # kernel 4: tconv transpose, ReLU mask, BN1 partials, tap gradient
        vecs = torch.stack([s1col, sh1col, torch.zeros_like(s1col), torch.zeros_like(s1col)])
        KBT = block_diag_taps(taps).transpose(1, 2).contiguous()
        dpre, parts, dtaps = tconv_bwd(dy2.reshape(N, Wp), y, vecs, KBT, T=T, C=C)

        # BN1 backward
        sum_dp_c = _chan_sum(parts[:, 0].sum(0), C)
        sum_dpy_c = _chan_sum(parts[:, 1].sum(0), C)
        dg1 = inv1 * (sum_dpy_c - mean1 * sum_dp_c)
        db1 = sum_dp_c
        n1 = (y.reshape(B, Tx, Wp) - cols(mean1)) * cols(inv1)
        mdpn1_col = cols((sum_dpy_c / cnt - mean1 * (sum_dp_c / cnt)) * inv1)
        dyf = s1col * (dpre.reshape(B, Tx, Wp) - cols(sum_dp_c / cnt) - n1 * mdpn1_col)
        dbias_col = dyf.sum((0, 1))

        dx = torch.matmul(dyf, M[:W].t())
        if ctx.residual:
            dx = dx + dz
        dM = torch.matmul(x.reshape(N, W).t(), dyf.reshape(N, Wp))
        if W < Wp:
            dM = F.pad(dM, (0, 0, 0, Wp - W))
        return dx, dM, dbias_col, dg1, db1, dtaps, dcb, dg2, db2, None, None, None, None


def train_layer_ref(x, M, bias_col, g1, b1, taps, cb, g2, b2, residual, V, C, T):
    """The same forward as ``FusedTrainLayer`` from the plain versions only,
    for torch autograd to differentiate (the JAX ``custom_vjp=False``
    counterpart).  Same arguments and outputs."""
    outs, _ = _layer_forward(
        x, M, bias_col, g1, b1, taps, cb, g2, b2,
        residual=residual, V=V, C=C, T=T, tconv_fwd=tconv_stats_fwd_ref,
    )
    return outs
