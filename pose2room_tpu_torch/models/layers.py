"""Shared building blocks: pointwise conv stacks and ST-GCN blocks.

Port of pose2room_tpu/models/layers.py.  Layout is channels-LAST as in the
JAX package: pose tensors are (B, T, V, C), point features (B, N, C), and a
1x1 convolution is a ``nn.Linear``.  Module and parameter names follow the
reference P2RNet state_dict (SingleConv ``.conv`` / ``.batchnorm``,
``gcn.conv``, ``tcn.{0,2,3}``), so ``state_dict()`` is in reference layout.

BatchNorm has flax's semantics in both modes (``module.training`` picks):
normalise as ``(x - mean) * (scale * rsqrt(var + eps)) + bias`` with eps
1e-5; in training mean = E[x] and the BIASED var = max(E[x^2] - mean^2, 0)
over every axis but the last, and the running stats follow the flax EMA
``ra = m * ra + (1 - m) * batch`` with the keep-rate m = ``bn_momentum``.
``torch.nn.BatchNorm*`` would update running_var with the unbiased variance
and the torch momentum convention, so it is not used.  In a data-parallel
process group the train-mode moments are global, as in the JAX package's
sharded step: each rank's (E[x], E[x^2]) are averaged over the ranks (they
hold batches of one size) through a differentiable all-reduce, whose
backward sums the moments' gradients over the ranks (SyncBatchNorm's
scheme); so every rank's running statistics take the same values.  Under a
tensor-parallel grid the ranks are those of the data group.

A compute ``dtype`` (None: float32, or ``torch.bfloat16``) follows flax's
``nn.Dense(dtype=bf16)`` (``dense``): parameters stay f32, the input and
kernel are cast to bf16, the product comes out bf16 and the bias is added in
bf16 (two roundings); BatchNorm upcasts to f32 (its train-mode statistics
too, as flax's ``BatchNorm(dtype=float32)``), so ReLU after it runs in f32.
"""

import math

import numpy as np
import torch
from torch import nn

from pose2room_tpu_torch.ops.stgcn_fused import LANE, N_VEC_ROWS, block_diag_taps, pad_merged, widen
from pose2room_tpu_torch.ops.stgcn_train import BN_EPS, FusedTrainLayer
from pose2room_tpu_torch.parallel.collectives import all_reduce_sum, data_count, in_group
from pose2room_tpu_torch.parallel.tensor import bias_block, copy_in, full_weight, gather_out, is_sharded


def lecun_normal_(tensor, fan_in, generator):
    """flax's lecun_normal: truncated normal on [-2, 2] std units, rescaled
    so the variance is 1/fan_in.

    Drawn by the inverse CDF, as ``jax.random.truncated_normal`` draws it:
    one uniform per element from ``generator``, mapped through erfinv.  Not
    ``nn.init.trunc_normal_``, whose sampling changed between torch releases
    (2.11 draws by the inverse CDF, 2.13 by rejection from normals), so the
    same seed gave other weights on another torch."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    with torch.no_grad():
        tensor.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
        tensor.erfinv_()
        tensor.mul_(std * math.sqrt(2.0))
        return tensor.clamp_(min=-2.0 * std, max=2.0 * std)


def dense(x, kernel, bias=None, dtype=None):
    """``x @ kernel + bias`` with flax ``nn.Dense`` semantics; kernel is
    (in, out).  With ``dtype`` bf16 the operands are cast to bf16, their
    product (exact in f32, summed in f32) is rounded to bf16 once, and the
    bf16 bias is added with a second rounding; ``F.linear`` would round once."""
    if dtype is None:
        y = x @ kernel
        return y if bias is None else y + bias
    y = torch.matmul(x.to(dtype).float(), kernel.to(dtype).float()).to(dtype)
    return y if bias is None else y + bias.to(dtype)


def column_parallel_dense(x, kernel, bias=None, dtype=None):
    """``dense`` on a tensor-parallel rank whose ``kernel`` (in, out / tp)
    is its block of the output columns (parallel/tensor.py): the rank's
    block, with its block of the bias, from the whole input, as one process
    computes those columns, then gathered over the model group.  With a
    compute ``dtype`` the group sums the ranks' f32 products for the input
    gradient before its one rounding to bf16, as one process's product
    rounds once (and as JAX's lowered tensor-parallel layer sums them on the
    CPU: an all-reduce promoted to f32)."""
    if dtype is None:
        return gather_out(dense(copy_in(x), kernel, bias_block(bias)))
    y = torch.matmul(copy_in(x.to(dtype).float()), kernel.to(dtype).float()).to(dtype)
    bias = bias_block(bias)
    return gather_out(y if bias is None else y + bias.to(dtype))


def linear(x, lin, dtype=None):
    """``nn.Linear`` ``lin`` applied as flax ``nn.Dense(dtype)``: the layer
    itself in f32, ``dense`` with a compute dtype, column-parallel when its
    weight is a tensor-parallel shard."""
    if not is_sharded(lin):
        return lin(x) if dtype is None else dense(x, lin.weight.t(), lin.bias, dtype)
    if dtype is None:
        return gather_out(nn.functional.linear(copy_in(x), lin.weight, bias_block(lin.bias)))
    return column_parallel_dense(x, lin.weight.t(), lin.bias, dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with flax semantics and reference
    parameter names.  ``momentum`` is the flax keep-rate."""

    def __init__(self, num_features, momentum=0.9):
        super().__init__()
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def affine(self):
        """(scale, shift) of the eval normalisation: y = x * s + b."""
        s = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        return s, self.bias - self.running_mean * s

    @torch.no_grad()
    def update_running_stats(self, mean, var):
        """Flax EMA of the batch moments (no gradient flows into the buffers)."""
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward(self, x):
        x = widen(x)
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean, meansq = x.mean(axes), (x * x).mean(axes)
            if in_group():
                mean, meansq = (all_reduce_sum(torch.stack([mean, meansq])) / data_count()).unbind(0)
            var = torch.clamp(meansq - mean * mean, min=0.0)
            self.update_running_stats(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = self.weight * torch.rsqrt(var + BN_EPS)
        return (x - mean) * mul + self.bias


class SingleConv(nn.Module):
    """1x1 conv [+ BatchNorm] [+ ReLU]: the reference's SingleConv."""

    def __init__(self, in_dim, out_dim, bias, bn, relu, bn_momentum=0.9, dtype=None):
        super().__init__()
        self.conv = nn.Linear(in_dim, out_dim, bias=bias)
        self.batchnorm = BatchNorm(out_dim, bn_momentum) if bn else None
        self.relu = relu
        self.dtype = dtype

    def forward(self, x):
        x = linear(x, self.conv, self.dtype)
        if self.batchnorm is not None:
            x = self.batchnorm(x)
        return torch.relu(x) if self.relu else x

    def reset_parameters(self, generator):
        lecun_normal_(self.conv.weight, self.conv.in_features, generator)
        if self.conv.bias is not None:
            nn.init.zeros_(self.conv.bias)


class MLP1x1(nn.ModuleList):
    """Stack of Linear(+BatchNorm+ReLU) layers, the 'cbr' SingleConv chain.

    ``final_plain`` makes the last layer a bare Linear with bias ('c' order).
    With batch norm the Linear before it has no bias (torch convention).
    """

    def __init__(self, in_dim, features, use_bn=True, final_plain=True, bn_momentum=0.9, dtype=None):
        layers = []
        for i, f in enumerate(features):
            plain = i == len(features) - 1 and final_plain
            layers.append(SingleConv(
                in_dim, f, bias=plain or not use_bn,
                bn=use_bn and not plain, relu=not plain, bn_momentum=bn_momentum, dtype=dtype,
            ))
            in_dim = f
        super().__init__(layers)

    def forward(self, x):
        for layer in self:
            x = layer(x)
        return x


class TemporalConv(nn.Module):
    """(k, 1) temporal convolution over (B, T, V, C) at ``stride`` along T,
    zero-padded by (k - 1) / 2 frames at each end ('SAME' at stride 1), with
    the reference Conv2d weight layout (out, in, k, 1).  With ``dtype`` bf16
    it runs as flax's ``conv_general_dilated`` on bf16 operands: the conv
    rounded to bf16 once, then the bf16 bias added (JAX layers.py:156-166).

    3 taps at stride 1 (P2RNet's ST-GCN) are three shifted products; any
    other size (2s-AGCN's 9 taps, stride 2) stacks its k shifted slices and
    takes one product of (k C) inputs.  On the H100 in f32 that beats cuDNN's
    choices at three of 2s-AGCN's five shapes, and its forward at B = 64
    runs in 124 ms against 201 ms on cuDNN, which picks an FFT with a
    14.6 GB workspace for 256 channels at T = 75 (H100, TF32 off)."""

    def __init__(self, channels, kernel_size=3, dtype=None, stride=1):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError(f"a temporal conv of {kernel_size} taps has no centre tap")
        self.weight = nn.Parameter(torch.empty(channels, channels, kernel_size, 1))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.dtype = dtype
        self.stride = stride

    def taps(self):
        """(k, in, out): tap s applies to row t+s-(k-1)/2."""
        return self.weight[..., 0].permute(2, 1, 0)

    def forward(self, x):
        if self.weight.shape[2] != 3 or self.stride != 1:
            return self._stacked(x)
        taps = self.taps()
        if self.dtype is not None:
            x, taps = x.to(self.dtype).float(), taps.to(self.dtype).float()
        zero = torch.zeros_like(x[:, :1])
        prev = torch.cat([zero, x[:, :-1]], dim=1)
        nxt = torch.cat([x[:, 1:], zero], dim=1)
        y = prev @ taps[0] + x @ taps[1] + nxt @ taps[2]
        if self.dtype is None:
            return y + self.bias
        return y.to(self.dtype) + self.bias.to(self.dtype)

    def _stacked(self, x):
        """(B, T, V, C) -> (B, T', V, C): the k shifted, strided slices of
        the zero-padded x side by side on the channels, then one product
        with the taps as a (k C, C) matrix."""
        w, s = self.weight, self.stride
        B, T, V, C = x.shape
        k = w.shape[2]
        t_out = (T - 1) // s + 1
        xp = nn.functional.pad(x, (0, 0, 0, 0, (k - 1) // 2, (k - 1) // 2))
        cols = torch.stack([xp[:, j:j + s * (t_out - 1) + 1:s] for j in range(k)], dim=3).view(B, t_out, V, k * C)
        taps = w[..., 0].permute(0, 2, 1).reshape(w.shape[0], k * C)  # (out, (tap, in))
        if self.dtype is None:
            return nn.functional.linear(cols, taps, self.bias)
        y = nn.functional.linear(cols.to(self.dtype).float(), taps.to(self.dtype).float())
        return y.to(self.dtype) + self.bias.to(self.dtype)


class _GraphConv(nn.Module):
    """Holder of the graph conv's 1x1 weights, reference key ``gcn.conv``."""

    def __init__(self, in_channels, out_channels, K):
        super().__init__()
        self.conv = nn.Linear(in_channels, out_channels * K)


class STGCNBlock(nn.Module):
    """Spatial graph conv + temporal conv with identity residual.

    Input x: (B, T, V, C_in); A: (K, V, V) adjacency stack already scaled by
    the caller's edge-importance weights.  ``forward`` is the per-block
    module path (BatchNorm live in training), the reference of both fused
    chains; ``fold_eval_arrays`` gives the eval chain's operands and
    ``apply_fused_train`` runs the train chain.  With ``dtype`` bf16 the
    module path folds M in bf16 and the fused folds fold in f32 and cast
    once, as the JAX package does (layers.py:241, 305-306, 362-366).
    """

    def __init__(self, in_channels, out_channels, K, num_joints, residual, bn_momentum=0.9, dtype=None):
        super().__init__()
        if residual and in_channels != out_channels:
            raise NotImplementedError("only the identity residual is ported")
        if LANE % out_channels:
            raise NotImplementedError(f"{out_channels} channels do not divide a {LANE}-lane group")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.K, self.num_joints, self.residual = K, num_joints, residual
        self.dtype = dtype
        self.gcn = _GraphConv(in_channels, out_channels, K)
        self.tcn = nn.Sequential(
            BatchNorm(out_channels, bn_momentum), nn.ReLU(), TemporalConv(out_channels, dtype=dtype),
            BatchNorm(out_channels, bn_momentum),
        )

    def reset_parameters(self, generator):
        lecun_normal_(self.gcn.conv.weight, self.in_channels, generator)
        nn.init.zeros_(self.gcn.conv.bias)
        lecun_normal_(self.tcn[2].weight, 3 * self.out_channels, generator)
        nn.init.zeros_(self.tcn[2].bias)

    def folded_graph_matrix(self, A, dtype=None):
        """(V*C_in, V*C_out) folded matrix and (V, C_out) bias term.

        out[btwc] = sum_{v,i,k} x[btvi] W[i,kc] A[kvw], so A folds into the
        weights once: M[viwc] = sum_k W[i,kc] A[kvw], and the graph conv is
        one dense matmul.  The bias enters before the A-contraction.  With
        ``dtype`` bf16, M is folded from bf16 W and A and rounded to bf16
        (the module path, JAX layers.py:241); the bias term stays f32.
        """
        K, C, V = self.K, self.out_channels, self.num_joints
        Wk = full_weight(self.gcn.conv).t().reshape(self.in_channels, K, C)
        if dtype is None:
            M = torch.einsum("ikc,kvw->viwc", Wk, A)
        else:
            M = torch.einsum("ikc,kvw->viwc", Wk.to(dtype).float(), A.to(dtype).float()).to(dtype)
        bias_out = torch.einsum("kc,kw->wc", self.gcn.conv.bias.reshape(K, C), A.sum(1))
        return M.reshape(V * self.in_channels, V * C), bias_out

    def forward(self, x, A):
        B, T, V, _ = x.shape
        M, bias_out = self.folded_graph_matrix(A, self.dtype)
        xm = x.reshape(B, T, V * self.in_channels)
        if self.dtype is not None:  # bf16 operands, f32 product (preferred_element_type)
            xm, M = xm.to(self.dtype).float(), M.float()
        y = (xm @ M).reshape(B, T, V, self.out_channels)
        y = self.tcn(y + bias_out)
        return torch.relu(y + x) if self.residual else torch.relu(y)

    def block_diag_taps(self):
        """Temporal taps as (3, 128, 128) block-diagonal matrices."""
        return block_diag_taps(self.tcn[2].taps())

    def fold_eval_arrays(self, A):
        """Operands of ops/stgcn_fused.py: (M padded (Wp, Wp), vecs (8, Wp),
        KB (3, 128, 128)), merged layout joint-major (v*C + c); M and KB in
        the compute dtype (folded in f32, cast once), vecs f32.

        Pad rows/columns of M and pad entries of vecs are zero, so pad
        columns stay zero through the whole chain.
        """
        C, V = self.out_channels, self.num_joints
        W0 = V * C
        Wp = pad_merged(W0)
        M, bias_out = self.folded_graph_matrix(A)
        M = nn.functional.pad(M, (0, Wp - W0, 0, Wp - W0))
        s1, b1 = self.tcn[0].affine()
        s2, b2 = self.tcn[3].affine()
        # gcn bias into the first BN shift: BN1(y + bias_out) = y*s1 + (bias_out*s1 + b1);
        # conv bias into the second: BN2(y2 + cb) = y2*s2 + (b2 + cb*s2)
        s1t = s1.repeat(V)
        rows = [s1t, bias_out.reshape(W0) * s1t + b1.repeat(V), s2.repeat(V),
                (b2 + self.tcn[2].bias * s2).repeat(V)]
        vecs = M.new_zeros(N_VEC_ROWS, Wp)
        vecs[: len(rows), :W0] = torch.stack(rows)
        dt = self.dtype or M.dtype
        return M.to(dt).contiguous(), vecs, self.block_diag_taps().to(dt).contiguous()

    def fold_eval_arrays_sparse(self, A, order, vlist, wlist):
        """Operands of ops/stgcn_sparse.py: (tiles (nnz, 2C, 2C), vecs (8, Wp),
        KB (3, 128, 128)) in the joint-permuted merged layout; tiles and KB in
        the compute dtype (folded in f32, cast once), vecs f32.

        order: (Vp,) numpy joint permutation (values >= num_joints are pad
        slots); vlist / wlist: numpy input / output tile of each packed tile
        (ops/stgcn_sparse.py:sparse_tile_lists, tile_columns).  Each tile is
        built from its (2, 2) joint sub-blocks, tile[(a,i),(b,o)] =
        sum_k A_k[v_a, w_b] W_k[i, o], so the dense (Wp, Wp) matrix is never
        formed.  Pad slots get zero vectors, so their columns stay zero.  KB
        does not mix joints, so the permutation leaves it unchanged.
        """
        C, V, K = self.out_channels, self.num_joints, self.K
        order = np.asarray(order, dtype=np.int64)
        Vp = len(order)
        Wp = Vp * C
        Wk = full_weight(self.gcn.conv).t().reshape(self.in_channels, K, C)  # (i, k, o)
        Ap = A.new_zeros(K, Vp, Vp)
        Ap[:, :V, :V] = A
        perm = torch.as_tensor(order, device=A.device)
        Ap = Ap[:, perm][:, :, perm]
        vj = torch.as_tensor(np.stack([2 * vlist, 2 * vlist + 1], axis=1), device=A.device).long()
        wj = torch.as_tensor(np.stack([2 * wlist, 2 * wlist + 1], axis=1), device=A.device).long()
        Asub = Ap[:, vj[:, :, None], wj[:, None, :]]  # (K, nnz, 2, 2)
        tiles = torch.einsum("knab,iko->naibo", Asub, Wk).reshape(len(vlist), 2 * C, 2 * C)

        mask = torch.as_tensor((order < V).astype(np.float32), device=A.device)[:, None]  # (Vp, 1)
        bias_out = torch.einsum("kc,kw->wc", self.gcn.conv.bias.reshape(K, C), Ap.sum(1))  # (Vp, C)
        s1, b1 = self.tcn[0].affine()
        s2, b2 = self.tcn[3].affine()

        def per_joint(row_c):
            return (mask * row_c[None, :]).reshape(Wp)

        s1t = per_joint(s1)
        rows = [s1t, bias_out.reshape(Wp) * s1t + per_joint(b1), per_joint(s2),
                per_joint(b2 + self.tcn[2].bias * s2)]
        vecs = A.new_zeros(N_VEC_ROWS, Wp)
        vecs[: len(rows)] = torch.stack(rows)
        dt = self.dtype or tiles.dtype
        return tiles.to(dt).contiguous(), vecs, self.block_diag_taps().to(dt).contiguous()

    def fold_train_arrays(self, A):
        """Operands of ops/stgcn_train.py:FusedTrainLayer, differentiable in
        the weights: (M padded (Wp, Wp), bias_col (Wp,), g1, b1, taps
        (3, C, C) as (tap, in, out), cb, g2, b2).  M is folded in f32, padded
        and cast to the compute dtype once; the rest stays f32.  BN folding
        happens inside the layer each step, from the live batch statistics."""
        C, V = self.out_channels, self.num_joints
        W0 = V * C
        Wp = pad_merged(W0)
        M, bias_out = self.folded_graph_matrix(A)
        bn1, conv, bn2 = self.tcn[0], self.tcn[2], self.tcn[3]
        return (
            nn.functional.pad(M, (0, Wp - W0, 0, Wp - W0)).to(self.dtype or M.dtype),
            nn.functional.pad(bias_out.reshape(W0), (0, Wp - W0)),
            bn1.weight, bn1.bias, conv.taps(), conv.bias, bn2.weight, bn2.bias,
        )

    def apply_fused_train(self, hm, A, T):
        """The block in training mode on merged (B, T, W) activations in the
        compute dtype through the fused train layer; updates both
        BatchNorms' running statistics from the layer's batch moments, as
        the module path would.  Returns (B, T, Wp) in the compute dtype."""
        args = self.fold_train_arrays(A)
        Wp = args[0].shape[1]
        if self.residual and hm.shape[-1] < Wp:
            # residual blocks add x to the padded-width output; in the
            # backbone chain only block 0 (no residual) sees unpadded input
            hm = nn.functional.pad(hm, (0, Wp - hm.shape[-1]))
        out, m1, v1, m2, v2 = FusedTrainLayer.apply(
            hm, *args, self.residual, self.num_joints, self.out_channels, int(T)
        )
        self.tcn[0].update_running_stats(m1, v1)
        self.tcn[3].update_running_stats(m2, v2)
        return out
