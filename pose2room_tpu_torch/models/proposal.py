"""Proposal network: vote aggregation (FPS + ball query) + heads.

Port of pose2room_tpu/models/proposal.py (reference
models/p2rnet/modules/proposal_net.py:37-252 with PointnetSAModuleVotes at
npoint=128, radius=0.3, nsample=16, mlp [256,256,256], use_xyz=False,
bn=False, max pooling):

* 'vote_fps': FPS over votes, proposals sorted by vote index;
  'seed_fps': arc-length resampling of the seed hip trajectory;
* ball query around each proposal and grouping of the vote features
  (use_xyz=False: the grouped, radius-scaled coordinates are not features);
* shared two-layer 1x1 MLP (no BN) and max-pool over the ball;
* four head stacks (center/size/heading -> 128-d GMM features, sem_obj ->
  2+num_class logits) and three MDN heads: the deterministic ``get_mean``
  for generation, multi-mode ``generate_multi`` (injected noise, Bernoulli
  mixture weights) for sampled generation, the sampled ``predict``
  (injected noise) for training and the validation loss.

With a bf16 ``dtype`` the shared MLP runs in bf16 and its max-pool goes to
f32; the three head stacks end in f32 BatchNorm + ReLU, and conv_sem_obj in
a plain bf16 Dense, so ``objectness_scores`` and ``sem_cls_scores`` come out
bf16 as in the JAX package (proposal.py:49-59, 98-99); the MDN heads run in
f32.

FPS and the ball query take detached coordinates (the JAX package's
stop_gradient): indices carry no gradient; the gathers of coordinates and
features do.
"""

import torch
from torch import nn

from pose2room_tpu_torch.models.layers import MLP1x1, lecun_normal_, linear
from pose2room_tpu_torch.models.mdn import MDNHead, center_mu_init, heading_mu_init, size_mu_init
from pose2room_tpu_torch.models.stgcn import arc_length_seed_inds
from pose2room_tpu_torch.ops.stgcn_fused import widen
from pose2room_tpu_torch.ops.sampling import (
    ball_query,
    furthest_point_sample,
    gather_points,
    group_points,
)
from pose2room_tpu_torch.utils.profiling import annotate

MDN_KEYS = ("center", "size", "heading")


class _VoteAggregation(nn.Module):
    """Reference key ``vote_aggregation.mlp_module.{0,2}``: plain Sequential."""

    def __init__(self, feature_dim, dtype=None):
        super().__init__()
        # reference mlp spec [256,256,256] includes the input dim -> 2 layers
        self.mlp_module = nn.Sequential(
            nn.Linear(feature_dim, 256), nn.ReLU(), nn.Linear(256, feature_dim), nn.ReLU()
        )
        self.dtype = dtype

    def forward(self, x):
        """The shared MLP and the max-pool over the ball (dim 2), in f32."""
        for lin in self.mlp_module[::2]:
            x = torch.relu(linear(x, lin, self.dtype))
        return widen(x.amax(dim=2))


class ProposalNet(nn.Module):
    def __init__(self, num_class=22, num_proposals=128, sampling="vote_fps", radius=0.3,
                 nsample=16, feature_dim=256, num_gaussian=100, gmm_dim=128, bn_momentum=0.9,
                 dtype=None):
        super().__init__()
        self.num_proposals, self.sampling = num_proposals, sampling
        self.radius, self.nsample = radius, nsample
        self.vote_aggregation = _VoteAggregation(feature_dim, dtype)
        bnm = dict(bn_momentum=bn_momentum)
        heads = dict(bnm, dtype=dtype)
        self.conv_center = MLP1x1(feature_dim, [128, gmm_dim], final_plain=False, **heads)
        self.conv_size = MLP1x1(feature_dim, [128, gmm_dim], final_plain=False, **heads)
        self.conv_heading = MLP1x1(feature_dim, [128, gmm_dim], final_plain=False, **heads)
        self.conv_sem_obj = MLP1x1(feature_dim, [128, 128, 2 + num_class], **heads)
        self.gmm_center = MDNHead(num_gaussian, 3, center_mu_init(num_gaussian), gmm_dim, **bnm)
        self.gmm_size = MDNHead(num_gaussian, 3, size_mu_init(num_gaussian), gmm_dim, **bnm)
        self.gmm_heading = MDNHead(num_gaussian, 2, heading_mu_init(num_gaussian), gmm_dim, **bnm)

    def reset_parameters(self, generator):
        for lin in self.vote_aggregation.mlp_module[::2]:
            lecun_normal_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)
        for mlp in (self.conv_center, self.conv_size, self.conv_heading, self.conv_sem_obj):
            for layer in mlp:
                layer.reset_parameters(generator)
        for head in (self.gmm_center, self.gmm_size, self.gmm_heading):
            head.reset_parameters(generator)

    def _aggregate(self, xyz, features, end_points):
        """-> (new_xyz (B,P,3), new_features (B,P,C), inds (B,P) int32)."""
        if self.sampling == "vote_fps":
            inds = furthest_point_sample(xyz.detach(), self.num_proposals).sort(dim=1).values
        elif self.sampling == "seed_fps":
            inds = arc_length_seed_inds(end_points["seed_skeleton"][:, :, 0], self.num_proposals)
        else:
            raise NotImplementedError(self.sampling)
        new_xyz = gather_points(xyz, inds)
        ball_idx = ball_query(self.radius, new_xyz.detach(), xyz.detach(), self.nsample)  # (B,P,S)
        return new_xyz, self.vote_aggregation(group_points(features, ball_idx)), inds

    def forward(self, xyz, features, end_points, eps=None, noise=None):
        """xyz (B,N,3) votes, features (B,N,C) -> end_points with boxes.

        ``eps``: None for generation, or the train path's noise {"center",
        "size", "heading"} -> (B, P, G, n, D) standard normal draws for the
        three MDN ``predict`` heads.  ``noise``: for multi-mode generation,
        {"center", "size", "heading"} -> (eps (B, P, G, n, D), u (B, P, G,
        n)) for the heads' ``generate_multi``; None for MDN ``get_mean``.
        Generation exports pi either way."""
        with annotate("model/proposal"):
            agg_xyz, agg_feat, inds = self._aggregate(xyz, features, end_points)
        with annotate("model/heads"):
            end_points["aggregated_vote_xyz"] = agg_xyz
            end_points["aggregated_vote_inds"] = inds
            feats = (self.conv_center(agg_feat), self.conv_size(agg_feat), self.conv_heading(agg_feat))
            sem_obj = self.conv_sem_obj(agg_feat)  # (B,P,2+num_class)
            heads = (self.gmm_center, self.gmm_size, self.gmm_heading)
            if eps is None:
                if noise is None:
                    means = [head.get_mean(f) for head, f in zip(heads, feats)]
                else:
                    means = [head.generate_multi(f, *noise[k]) for head, f, k in zip(heads, feats, MDN_KEYS)]
                (pred_center, pi_center), (pred_size, pi_size), (pred_heading, pi_heading) = means
                end_points["pi"] = {"center": pi_center, "size": pi_size, "heading": pi_heading}
            else:
                pred_center, pred_size, pred_heading = (
                    head.predict(f, eps[k]) for head, f, k in zip(heads, feats, MDN_KEYS)
                )
            end_points["center"] = agg_xyz + pred_center
            end_points["size"] = pred_size  # log-space
            end_points["heading"] = pred_heading  # (sin, cos)
            end_points["objectness_scores"] = sem_obj[..., 0:2]
            end_points["sem_cls_scores"] = sem_obj[..., 2:]
            return end_points
