"""Three-NN feature interpolation (PointNet++ feature propagation).

Port of pose2room_tpu/ops/interpolate.py (reference
external/pointnet2_ops_lib/_ext-src/src/interpolate_gpu.cu +
pointnet2_utils.py:104-191): for each query point, its 3 nearest known
points, and their features interpolated with inverse-distance weights.
P2RNet never instantiates the FP module; the ops complete the library
surface.

``three_nn`` forms the squared distance as |u|^2 + |k|^2 - 2 u.k, clamped at
0, as the JAX package does.  Its products and sums are elementwise ops, not a
matmul, so they are full f32 on every device whatever the TF32 flags say
(distances that feed a top-k are full f32).  The card's indices equal the
CPU's; its distances agree to f32 rounding, not bit for bit (2.38e-7 apart
on an NVIDIA H100 at B=8, 1024 x 256 points, ``chip_smoke.py``).  The 3 smallest come from a stable sort, so ties go to the lowest
index, as ``lax.top_k`` breaks them.  ``three_interpolate`` is
differentiable in ``known_feats``: autograd's adjoint of the gather is a
scatter-add, as the CUDA backward's atomicAdd.
"""

import torch


def _dot3(a, b):
    """Sum over the last axis (3) of a * b, in one fixed order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def three_nn(unknown, known):
    """For each unknown point, the 3 nearest known points.

    unknown (B, N, 3), known (B, M, 3) with M >= 3.  Returns dist (B, N, 3),
    the Euclidean distances ascending, and idx (B, N, 3) int32 into known.
    """
    cross = _dot3(unknown[:, :, None, :], known[:, None, :, :])  # (B,N,M)
    d2 = _dot3(unknown, unknown)[:, :, None] + _dot3(known, known)[:, None, :] - 2.0 * cross
    d2 = torch.clamp(d2, min=0.0)
    top, idx = torch.sort(d2, dim=-1, stable=True)
    return torch.sqrt(top[..., :3]), idx[..., :3].to(torch.int32)


def three_interpolate(known_feats, idx, weight):
    """known_feats (B, M, C) channel-last, idx (B, N, 3), weight (B, N, 3)
    -> (B, N, C): the weighted sum of the features at the indices."""
    B, N, K = idx.shape
    C = known_feats.shape[-1]
    flat = idx.reshape(B, N * K, 1).long().expand(B, N * K, C)
    gathered = torch.gather(known_feats, 1, flat).reshape(B, N, K, C)
    return (gathered * weight[..., None]).sum(2)


def interpolate_features(unknown, known, known_feats, eps=1e-8):
    """3-NN, inverse-distance weights w_i = (1/d_i) / sum_j (1/d_j) with the
    distances clamped at ``eps`` (PointnetFPModule), then interpolate."""
    dist, idx = three_nn(unknown, known)
    recip = 1.0 / torch.clamp(dist, min=eps)
    weight = recip / recip.sum(-1, keepdim=True)
    return three_interpolate(known_feats, idx, weight)
