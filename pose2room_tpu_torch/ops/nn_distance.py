"""Dense pairwise Chamfer ("nn_distance") and the huber loss.

Port of pose2room_tpu/ops/nn_distance.py (reference
net_utils/nn_distance.py:15-61), squared-L2 form: for every point of each
set, the squared distance to its nearest neighbour in the other set and that
neighbour's index.  The (B, N, M) distance matrix is ||a||^2 + ||b||^2 -
2 a.b^T in full f32 (TF32 off), clamped at 0, as the JAX package forms it.
``torch.argmin`` returns the first index of a tie, as ``jnp.argmin`` does.
"""

import torch


def huber_loss(error, delta=1.0):
    """Elementwise huber: 0.5 x^2 for |x| <= delta, else 0.5 delta^2 + delta (|x| - delta)."""
    abs_error = error.abs()
    quadratic = torch.clamp(abs_error, max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def nn_distance(pc1, pc2):
    """pc1 (B, N, C), pc2 (B, M, C) -> (dist1 (B, N), idx1 (B, N),
    dist2 (B, M), idx2 (B, M)): nearest pc2 point of each pc1 point, and
    the other way round."""
    sq1 = (pc1 * pc1).sum(-1)
    sq2 = (pc2 * pc2).sum(-1)
    cross = torch.einsum("bnc,bmc->bnm", pc1, pc2)
    pc_dist = torch.clamp(sq1[:, :, None] + sq2[:, None, :] - 2.0 * cross, min=0.0)
    return pc_dist.amin(2), pc_dist.argmin(2), pc_dist.amin(1), pc_dist.argmin(1)
