"""ST-GCN pose backbone: a (B,T,53,3) clip -> seed features.

Port of pose2room_tpu/models/stgcn.py (reference
models/p2rnet/modules/stgcn.py:12-152):

* seed selection: fixed linspace when n_seeds >= n_frames, else 'uniform'
  arc-length resampling of the hip trajectory or 'random' sort-sampling;
* hip-relative joint features through a 3-layer 1x1 conv (sk_feat);
* temporal-window (knn=20) relative-position embedding of the hip trajectory
  through a 3-layer 1x1 conv, mean-pooled over the window (pos_embed);
* six ST-GCN blocks with per-block edge-importance multipliers;
* a joint-flatten 1x1 conv to 256-d per-frame features, gathered at seeds.

In eval mode the six blocks run on the merged (B, T, V*C) layout through
``ops/stgcn_fused.py`` (the graph GEMM kernel in f32 on a card, a matmul
in bf16 or on the CPU, then the CUDA epilogue kernel), or with
``sparse_eval`` on the joint-permuted layout through ``ops/stgcn_sparse.py``
(the block-sparse graph matmul kernel, then the same epilogue kernel).  The
operands are a function of the weights alone: ``fold_eval_operands`` builds
them once per weight load and ``forward(folded=...)`` reuses them.  In
training mode with ``fused_train`` the blocks run on the same layout through
``ops/stgcn_train.py`` (BatchNorm on live batch statistics, hand-written
backward, the CUDA train kernels); ``fused_eval`` / ``fused_train`` off run
the per-block module path instead.

A compute ``dtype`` of bf16 (eval and training) runs the chain on bf16
activations with bf16 operands, as the JAX package's bf16 path does
(stgcn.py:224-380): pos_embed and sk_feat end in bf16 Dense layers, the
window mean accumulates in f32 and rounds once, the chain takes bf16 input
(the fused train chain keeps bf16 between blocks, the module path f32), and
conv_joint is a bf16 Dense whose output goes to f32.
"""

import numpy as np
import torch
from torch import nn

from pose2room_tpu_torch.models.graph import SPARSE_JOINT_ORDER, build_spatial_graph
from pose2room_tpu_torch.models.layers import MLP1x1, STGCNBlock, column_parallel_dense, dense, lecun_normal_, linear
from pose2room_tpu_torch.ops.sampling import gather_points
from pose2room_tpu_torch.ops.stgcn_fused import LANE, fused_epilogue, fused_stgcn_layer, gemm_b_operand, widen
from pose2room_tpu_torch.ops.stgcn_sparse import (
    sparse_graph_matmul_bn_relu,
    sparse_tile_lists,
    tile_columns,
)
from pose2room_tpu_torch.parallel.collectives import draw_rows
from pose2room_tpu_torch.parallel.tensor import is_sharded


def blocked_cumsum(x, base=16):
    """Inclusive cumsum over dim 1 with a fixed association: sequential
    within blocks of ``base``, plus the exclusive prefix of the block totals
    (recursively).  This is the association of XLA's CPU cumsum (its
    reduce-window rewriter, base length 16), so frame choices that hinge on
    near-equal cumulative distances come out as in the JAX package, and the
    same on the CPU and the card (``torch.cumsum`` associates differently
    on each).  Elementwise adds only: every rounding is pinned."""
    B, n = x.shape
    if n <= base:
        out = [x[:, 0]]
        for i in range(1, n):
            out.append(out[-1] + x[:, i])
        return torch.stack(out, dim=1)
    m = -(-n // base)
    blocks = torch.nn.functional.pad(x, (0, m * base - n)).reshape(B, m, base)
    inner = [blocks[:, :, 0]]
    for i in range(1, base):
        inner.append(inner[-1] + blocks[:, :, i])
    inner = torch.stack(inner, dim=2)  # (B, m, base)
    totals = blocked_cumsum(inner[:, :, -1], base)
    offset = torch.cat([totals.new_zeros(B, 1), totals[:, :-1]], dim=1)
    return (inner + offset[:, :, None]).reshape(B, m * base)[:, :n]


def arc_length_seed_inds(origin_traj, n_seeds):
    """Uniform-arc-length resampling of a trajectory.

    origin_traj: (B, T, 3) hip positions.  Returns (B, n_seeds) int32 frame
    indices evenly covering the cumulative movement distance (argmin of
    |cum_dist - target| per target, first index on ties).
    """
    d = torch.diff(origin_traj, dim=1)
    movement = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
    zeros = movement.new_zeros(origin_traj.shape[0], 1)
    cum = blocked_cumsum(torch.cat([zeros, movement], dim=1))  # (B,T)
    step = cum[:, -1] / (n_seeds - 1)
    target = step[:, None] * torch.arange(n_seeds, dtype=cum.dtype, device=cum.device)
    return torch.argmin((cum[:, :, None] - target[:, None, :]).abs(), dim=1).to(torch.int32)


def window_index_table(n_frames, knn):
    """Static (T, knn) clamped temporal-window indices (stgcn.py:109-114)."""
    idx = np.arange(n_frames)[:, None] + np.arange(-(knn // 2), knn // 2)[None, :]
    return np.clip(idx, 0, n_frames - 1).astype(np.int64)


class STGCN(nn.Module):
    def __init__(self, n_seeds=512, num_frames=768, origin_joint_id=0, num_joints=53,
                 seed_sampling="uniform", fused_eval=True, fused_train=True, sparse_eval=False,
                 knn=20, in_channels=64, out_channels=256, max_hop=5, bn_momentum=0.9, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.n_seeds, self.num_frames = n_seeds, num_frames
        self.origin_joint_id, self.num_joints = origin_joint_id, num_joints
        self.seed_sampling = seed_sampling
        self.fused_eval, self.fused_train = fused_eval, fused_train
        self.sparse_eval = fused_eval and sparse_eval
        if self.sparse_eval and 2 * in_channels != LANE:
            raise NotImplementedError("the block-sparse chain pairs two joints' channels per 128-wide tile")
        self.in_channels = in_channels
        A_np = build_spatial_graph(num_joints, max_hop=max_hop)
        A = torch.from_numpy(A_np)
        self.register_buffer("A", A, persistent=False)
        if self.sparse_eval:
            # static tile lists over the support of A (edge importance scales
            # A elementwise, so the live support is always a subset)
            Vp = num_joints + num_joints % 2
            self.sparse_order = SPARSE_JOINT_ORDER if num_joints == 53 else np.arange(Vp, dtype=np.int32)
            self.sparse_col_off, self.sparse_vlist = sparse_tile_lists(
                (A_np != 0).any(0), self.sparse_order)
        self.register_buffer(
            "window_idx", torch.from_numpy(window_index_table(num_frames, knn)), persistent=False
        )
        self.pos_embed = MLP1x1(3, [64, 64, in_channels], bn_momentum=bn_momentum, dtype=dtype)
        self.sk_feat = MLP1x1(3, [64, 64, in_channels], bn_momentum=bn_momentum, dtype=dtype)
        self.st_gcn_networks = nn.ModuleList(
            STGCNBlock(in_channels, in_channels, A.shape[0], num_joints, residual=(i != 0),
                       bn_momentum=bn_momentum, dtype=dtype)
            for i in range(6)
        )
        self.edge_importance = nn.ParameterList(
            nn.Parameter(torch.ones_like(A)) for _ in self.st_gcn_networks
        )
        self.conv_joint = nn.Linear(num_joints * in_channels, out_channels)

    def reset_parameters(self, generator):
        for mlp in (self.pos_embed, self.sk_feat):
            for layer in mlp:
                layer.reset_parameters(generator)
        for block in self.st_gcn_networks:
            block.reset_parameters(generator)
        lecun_normal_(self.conv_joint.weight, self.conv_joint.in_features, generator)
        nn.init.zeros_(self.conv_joint.bias)

    def _conv_joint_joint_major(self):
        """conv_joint as a (V*C, 256) kernel over joint-major (v*C + c) rows
        (this rank's block of the 256 columns under tensor parallelism).
        The reference layout flattens channel-major (c*V + v)."""
        V, C = self.num_joints, self.in_channels
        w = self.conv_joint.weight
        return w.reshape(-1, C, V).permute(0, 2, 1).reshape(-1, V * C).t().contiguous()

    def _conv_joint_sparse_rows(self):
        """The joint-major conv_joint kernel with its rows in the sparse
        chain's joint order and zero rows at the pad slot, (Vp*C, 256)."""
        C = self.in_channels
        kernel = self._conv_joint_joint_major()
        kernel = torch.cat([kernel, kernel.new_zeros(1, kernel.shape[1])])
        order = self.sparse_order.astype(np.int64)[:, None]
        rows = np.where(order < self.num_joints, order * C + np.arange(C)[None], self.num_joints * C)
        return kernel[torch.as_tensor(rows.reshape(-1), device=kernel.device)].contiguous()

    def _conv_joint_dense(self, x, kernel, bias):
        """conv_joint on the merged layout with a kernel of the fold:
        column-parallel when its weight is a tensor-parallel shard."""
        apply = column_parallel_dense if is_sharded(self.conv_joint) else dense
        return apply(x, kernel, bias, self.dtype)

    @torch.no_grad()
    def fold_eval_operands(self):
        """The fused chain's operands, a function of the weights only:
        per-block (M, vecs, KB), the joint-major conv_joint kernel and, for
        f32 on a card, each block's graph GEMM B operand (``gemm_b``:
        ``gemm_b_operand(M)``, 95.6 MB a block at full width; None
        otherwise); with ``sparse_eval`` per-block (tiles, vecs, KB), the
        conv_joint kernel rows in the joint order, and the order and tile
        lists as tensors on the model's device.  Re-fold after every weight
        change."""
        bias = self.conv_joint.bias.clone()
        if not self.sparse_eval:
            blocks = [
                blk.fold_eval_arrays(self.A * imp)
                for blk, imp in zip(self.st_gcn_networks, self.edge_importance)
            ]
            gemm = blocks[0][0].is_cuda and blocks[0][0].dtype == torch.float32
            return {"blocks": blocks, "conv_joint": (self._conv_joint_joint_major(), bias),
                    "gemm_b": [gemm_b_operand(M) for M, _, _ in blocks] if gemm else None}
        vlist, wlist = self.sparse_vlist, tile_columns(self.sparse_col_off)
        blocks = [
            blk.fold_eval_arrays_sparse(self.A * imp, self.sparse_order, vlist, wlist)
            for blk, imp in zip(self.st_gcn_networks, self.edge_importance)
        ]
        dev = self.A.device
        return {
            "blocks": blocks,
            "conv_joint": (self._conv_joint_sparse_rows(), bias),
            "order": torch.as_tensor(self.sparse_order.astype(np.int64), device=dev),
            "col_off": torch.as_tensor(self.sparse_col_off, device=dev),
            "vlist": torch.as_tensor(vlist, device=dev),
        }

    def seed_indices(self, origin, generator=None, shard=(0, 1)):
        """(B, n_seeds) int32 frame indices.  ``shard`` (index, count): with
        'random' sampling the scores of the global batch are drawn and this
        batch's rows kept (``parallel.draw_rows``: a data-parallel rank's
        or a model group's rows)."""
        B, T, _ = origin.shape
        if self.n_seeds >= T:
            inds = torch.round(torch.linspace(0, T - 1, self.n_seeds, device=origin.device))
            return inds.to(torch.int32).expand(B, -1)
        if self.seed_sampling == "uniform":
            return arc_length_seed_inds(origin, self.n_seeds)
        if self.seed_sampling == "random":
            # drawn on the generator's device (the host's by default), so a
            # host generator's seed gives the same frames on any device
            gen_device = generator.device if generator is not None else "cpu"
            scores = draw_rows(lambda n: torch.rand((n, T), generator=generator, device=gen_device), B, shard)
            scores = scores.to(origin.device)
            picked = torch.argsort(scores, dim=1)[:, : self.n_seeds]
            return torch.sort(picked, dim=1).values.to(torch.int32)
        raise NotImplementedError(self.seed_sampling)

    def forward(self, input_joints, folded=None, generator=None, shard=(0, 1)):
        """input_joints: (B, T, V, 3) -> dict of seed tensors.  ``folded``:
        ``fold_eval_operands()`` of the current weights (eval mode only);
        ``shard``: see ``seed_indices``."""
        B, T, V, _ = input_joints.shape
        if T != self.num_frames:
            raise ValueError(f"clip has {T} frames; the model was built for {self.num_frames}")
        oid = self.origin_joint_id
        origin = input_joints[:, :, oid, :3]  # (B,T,3)
        seed_inds = self.seed_indices(origin, generator, shard)

        x = input_joints - input_joints[:, :, oid : oid + 1]
        neigh = origin[:, self.window_idx, :]  # (B,T,knn,3)
        pos = self.pos_embed(neigh - origin[:, :, None, :])  # (B,T,knn,C)
        pos = pos.mean(dim=2) if self.dtype is None else widen(pos).mean(dim=2).to(self.dtype)
        h = self.sk_feat(x) + pos[:, :, None, :]  # (B,T,V,C)
        C = h.shape[-1]
        W0 = V * C

        if self.training and self.fused_train:
            # same no-entry-pad trick as eval; gradients reach every weight
            # through the fold (M = einsum(W, A * importance), bias_col)
            hm = h.reshape(B, T, W0)  # already in the compute dtype (sk_feat + pos)
            for blk, imp in zip(self.st_gcn_networks, self.edge_importance):
                hm = blk.apply_fused_train(hm, self.A * imp, T)
            frame_feat = self._conv_joint_dense(hm[..., :W0], self._conv_joint_joint_major(), self.conv_joint.bias)
        elif not self.training and self.sparse_eval:
            # joint-permuted padded layout from the entry: pad to Vp joints,
            # gather the order; the permutation leaves through conv_joint's rows
            folded = folded if folded is not None else self.fold_eval_operands()
            order = folded["order"]
            hm = torch.cat([h, h.new_zeros(B, T, len(order) - V, C)], dim=2)
            hm = hm.index_select(2, order).reshape(B, T, len(order) * C)
            col_off, vlist = folded["col_off"], folded["vlist"]
            for blk, (tiles, vecs, KB) in zip(self.st_gcn_networks, folded["blocks"]):
                t1 = sparse_graph_matmul_bn_relu(hm, tiles, vecs, col_off, vlist)
                hm = fused_epilogue(t1, hm if blk.residual else None, vecs, KB, residual=blk.residual)
            frame_feat = self._conv_joint_dense(hm, *folded["conv_joint"])  # (B,T,256)
        elif not self.training and self.fused_eval:
            # no entry pad: block 0 has no residual, so it contracts the
            # unpadded merged input against M's first W0 rows
            folded = folded if folded is not None else self.fold_eval_operands()
            hm = h.reshape(B, T, W0)
            gemm_b = folded.get("gemm_b") or [None] * len(folded["blocks"])
            for blk, (M, vecs, KB), b_split in zip(self.st_gcn_networks, folded["blocks"], gemm_b):
                hm = fused_stgcn_layer(hm, M, vecs, KB, residual=blk.residual, b_split=b_split)
            frame_feat = self._conv_joint_dense(hm[..., :W0], *folded["conv_joint"])  # (B,T,256)
        else:
            for blk, imp in zip(self.st_gcn_networks, self.edge_importance):
                h = blk(h, self.A * imp)
            # reference flattening: channel-major (c*V + v)
            flat = h.permute(0, 1, 3, 2).reshape(B, T, W0)
            frame_feat = linear(flat, self.conv_joint, self.dtype)
        frame_feat = widen(frame_feat)

        seed_skeleton = input_joints[..., :3][torch.arange(B, device=input_joints.device)[:, None],
                                              seed_inds.long()]  # (B,S,V,3)
        return {
            "seed_inds": seed_inds,
            "seed_skeleton": seed_skeleton,
            "seed_features": gather_points(frame_feat, seed_inds),
        }
