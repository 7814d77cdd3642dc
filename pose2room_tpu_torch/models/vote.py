"""Center voting: each seed casts a vote for an object center.

Port of pose2room_tpu/models/vote.py (reference
models/p2rnet/modules/vote_center.py:11-59): a 3-layer 1x1 conv over seed
features gives a 3-d offset from the seed's hip joint and a residual
feature; vote features = seed features + residual.  The conv stack's
BatchNorms are live in training mode.  With a bf16 ``dtype`` the stack ends
in a bf16 Dense and its output goes to f32 (JAX vote.py:32-38).
"""

import torch
from torch import nn

from pose2room_tpu_torch.models.layers import MLP1x1
from pose2room_tpu_torch.ops.stgcn_fused import widen


class CenterVote(nn.Module):
    def __init__(self, origin_joint_id=0, vote_factor=1, feature_dim=256, bn_momentum=0.9, dtype=None):
        super().__init__()
        self.origin_joint_id, self.vote_factor, self.feature_dim = (
            origin_joint_id, vote_factor, feature_dim,
        )
        self.conv_input = MLP1x1(feature_dim, [256, 256, (3 + feature_dim) * vote_factor],
                                 bn_momentum=bn_momentum, dtype=dtype)

    def reset_parameters(self, generator):
        for layer in self.conv_input:
            layer.reset_parameters(generator)

    def forward(self, seed_skeleton, seed_features):
        """seed_skeleton (B,S,V,3), seed_features (B,S,C) ->
        vote_xyz (B,S*vf,3), vote_features (B,S*vf,C)."""
        seed_xyz = seed_skeleton[:, :, self.origin_joint_id]  # (B,S,3)
        B, S, C = seed_features.shape
        out = widen(self.conv_input(seed_features)).reshape(B, S, self.vote_factor, 3 + self.feature_dim)
        vote_xyz = (seed_xyz[:, :, None, :] + out[..., :3]).reshape(B, S * self.vote_factor, 3)
        vote_features = (seed_features[:, :, None, :] + out[..., 3:]).reshape(
            B, S * self.vote_factor, self.feature_dim
        )
        return vote_xyz, vote_features


def l2_normalize(features):
    """features / max(||features||_2, 1e-12) over the last axis (p2rnet.py:132-133)."""
    norm = torch.linalg.vector_norm(features, dim=2, keepdim=True)
    return features / torch.clamp(norm, min=1e-12)
