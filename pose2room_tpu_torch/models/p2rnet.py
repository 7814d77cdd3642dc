"""P2RNet: backbone -> center votes -> proposals, as a torch module.

Port of pose2room_tpu/models/p2rnet.py (reference
models/p2rnet/modules/network.py:11-106): STGCN backbone, center voting,
L2-normalised vote features, and ProposalNet.

* ``forward`` is the train forward: MDN ``predict`` heads on injected noise,
  BatchNorm on live batch statistics in ``.train()`` mode and on the running
  statistics in ``.eval()`` mode (the validation loss);
* ``generate`` is the eval path: MDN ``get_mean`` heads, or with
  ``multi_mode`` the heads' Bernoulli-sampled ``generate_multi`` on noise
  drawn on the model's device (``multi_noise``) or injected.

``compute_dtype: bfloat16`` runs eval and training in bf16 as the JAX
package does (p2rnet.py:96-125): parameters, optimizer state and
checkpoints stay f32, every module casts where flax does, and gradients
flow back through the casts to the f32 parameters.

``P2RNet(config, device=None)`` builds its weights on the host and moves
them to the card; ``device="cpu"`` runs it on the CPU (the kernels' plain
versions).  Serving folds the graph operands once per weight load
(``fold_eval``) and passes them to every ``generate(folded=...)``.
"""

import dataclasses

import torch
from torch import nn

from pose2room_tpu_torch.device import assert_precision_policy, resolve_device
from pose2room_tpu_torch.models.layers import BatchNorm
from pose2room_tpu_torch.models.proposal import MDN_KEYS, ProposalNet
from pose2room_tpu_torch.models.stgcn import STGCN
from pose2room_tpu_torch.models.vote import CenterVote, l2_normalize


# model.compute_dtype -> the modules' compute dtype (None: float32 throughout)
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class P2RNetConfig:
    num_frames: int = 768
    num_seeds: int = 512
    seed_sampling: str = "uniform"
    num_proposals: int = 128
    vote_factor: int = 1
    cluster_sampling: str = "vote_fps"
    num_gaussian: int = 100
    num_class: int = 22
    num_joints: int = 53
    origin_joint_id: int = 0
    compute_dtype: str = "float32"
    # fused merged-layout ST-GCN chain (matmul + CUDA epilogue kernel);
    # false runs the per-block module path, the chain's reference
    fused_eval: bool = True
    # block-sparse graph matmul in the fused eval chain (joint-permuted
    # layout, the CUDA sparse kernel); off runs the dense graph matmul
    sparse_eval: bool = False
    # fused merged-layout train chain (custom backward through live BN and
    # the CUDA train kernels); false runs the per-block module path
    fused_train: bool = True
    # BatchNorm EMA keep-rate, flax convention (= 1 - torch momentum)
    bn_momentum: float = 0.9

    @classmethod
    def from_cfg(cls, cfg):
        """Build from a reference-format YAML config (a CONFIG object)."""
        data = cfg.config.get("data", {})
        model_cfg = cfg.config.get("model", {}) or {}
        return cls(
            compute_dtype=model_cfg.get("compute_dtype", "float32"),
            bn_momentum=float(model_cfg.get("bn_momentum", 0.9)),
            fused_eval=model_cfg.get("fused_eval", True),
            sparse_eval=model_cfg.get("sparse_eval", False),
            fused_train=model_cfg.get("fused_train", True),
            num_frames=data.get("num_frames", 768),
            num_seeds=data.get("num_seeds", 512),
            seed_sampling=data.get("seed_sampling", "uniform"),
            num_proposals=data.get("num_target", 128),
            vote_factor=data.get("vote_factor", 1),
            cluster_sampling=data.get("cluster_sampling", "vote_fps"),
            num_gaussian=data.get("num_gaussian", 100),
            num_class=cfg.dataset_config.num_class,
            num_joints=cfg.dataset_config.joint_num,
            origin_joint_id=cfg.dataset_config.origin_joint_id,
        )


class P2RNet(nn.Module):
    def __init__(self, config=P2RNetConfig(), *, device=None, generator=None):
        """Weights are initialised from ``generator`` (a CPU torch.Generator;
        a fresh one seeded 0 when None) on the host, then moved to
        ``device``: the card unless ``device="cpu"``."""
        super().__init__()
        if config.compute_dtype not in COMPUTE_DTYPES:
            raise NotImplementedError(f"compute_dtype {config.compute_dtype!r} is not ported")
        device = resolve_device(device)
        self.config = c = config
        self.compute_dtype = dtype = COMPUTE_DTYPES[c.compute_dtype]
        self.backbone = STGCN(
            n_seeds=c.num_seeds, num_frames=c.num_frames, origin_joint_id=c.origin_joint_id,
            num_joints=c.num_joints, seed_sampling=c.seed_sampling, fused_eval=c.fused_eval,
            fused_train=c.fused_train, sparse_eval=c.sparse_eval, bn_momentum=c.bn_momentum,
            dtype=dtype,
        )
        self.centervoting = CenterVote(origin_joint_id=c.origin_joint_id, vote_factor=c.vote_factor,
                                       bn_momentum=c.bn_momentum, dtype=dtype)
        self.detection = ProposalNet(
            num_class=c.num_class, num_proposals=c.num_proposals,
            sampling=c.cluster_sampling, num_gaussian=c.num_gaussian, bn_momentum=c.bn_momentum,
            dtype=dtype,
        )
        self.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(0))
        self.eval()
        self.to(device)

    @property
    def device(self):
        return self.backbone.A.device

    def reset_parameters(self, generator):
        """flax-style init: lecun-normal kernels, zero biases, identity BN,
        unit edge importance, grid mu, zero log_sigma."""
        for part in (self.backbone, self.centervoting, self.detection):
            part.reset_parameters(generator)

    def set_bn_momentum(self, momentum):
        """Set every BatchNorm's EMA keep-rate (flax convention, = 1 - torch
        momentum), which the module path and the fused train chain's
        ``update_running_stats`` both read: the ``bnscheduler`` schedule."""
        self.config = dataclasses.replace(self.config, bn_momentum=float(momentum))
        for module in self.modules():
            if isinstance(module, BatchNorm):
                module.momentum = float(momentum)

    def fold_eval(self):
        """Weight-only operands of the fused eval chain; fold once per weight
        load and pass to ``generate(folded=...)``.  None when the chain is off."""
        return self.backbone.fold_eval_operands() if self.config.fused_eval else None

    def _trunk(self, input_joints, folded=None, generator=None):
        end_points = self.backbone(input_joints, folded=folded, generator=generator)
        xyz, features = self.centervoting(end_points["seed_skeleton"], end_points["seed_features"])
        features = l2_normalize(features)
        end_points["vote_xyz"] = xyz
        end_points["vote_features"] = features
        return end_points, xyz, features

    def mdn_eps(self, batch_size, generator):
        """Standard-normal noise of the three MDN ``predict`` heads, one
        sample each: {"center", "size", "heading"} -> (B, P, G, 1, D), drawn
        on the host from the CPU ``generator`` (so the card and the CPU see
        the same numbers) and moved to the model's device."""
        c = self.config
        dims = {"center": 3, "size": 3, "heading": 2}
        return {
            k: torch.randn((batch_size, c.num_proposals, c.num_gaussian, 1, dims[k]),
                           generator=generator).to(self.device)
            for k in MDN_KEYS
        }

    def multi_noise(self, batch_size, n_samples, generator):
        """Noise of the three MDN ``generate_multi`` heads, drawn on the
        model's device from ``generator`` (a torch.Generator of that device):
        {"center", "size", "heading"} -> (eps (B, P, G, n, D) standard
        normal, u (B, P, G, n) uniform on [0, 1), f32 as pi)."""
        c = self.config
        dims = {"center": 3, "size": 3, "heading": 2}
        shape = (batch_size, c.num_proposals, c.num_gaussian, n_samples)
        return {
            k: (torch.randn(shape + (dims[k],), generator=generator, device=self.device),
                torch.rand(shape, generator=generator, device=self.device))
            for k in MDN_KEYS
        }

    def forward(self, input_joints, eps=None, generator=None):
        """Train forward. input_joints: (B, T, V, 3) f32 on ``self.device``.

        ``eps``: the MDN noise (``mdn_eps`` layout); drawn from ``generator``
        (a CPU torch.Generator, also used for ``seed_sampling: random``)
        when None.  BatchNorm is live in ``.train()`` mode and uses the
        running statistics in ``.eval()`` mode.  Returns the end_points dict.
        """
        assert_precision_policy()
        if eps is None:
            if generator is None:
                raise ValueError("pass the MDN noise eps or a CPU generator to draw it from")
            eps = self.mdn_eps(input_joints.shape[0], generator)
        end_points, xyz, features = self._trunk(input_joints, generator=generator)
        return self.detection(xyz, features, end_points, eps=eps)

    @torch.no_grad()
    def generate(self, input_joints, multi_mode=False, n_samples=1, folded=None, generator=None,
                 noise=None):
        """Eval forward. input_joints: (B, T, V, 3) f32 on ``self.device``.
        ``folded``: ``fold_eval()`` of the current weights (re-fold after any
        weight change).  ``generator``: draws the frames of ``seed_sampling:
        random`` on its own device and, with ``multi_mode`` and no
        ``noise``, the multi-mode noise on the model's device (so it must be
        a generator of that device).  ``multi_mode``: MDN heads sampled
        ``n_samples`` times with Bernoulli mixture weights and averaged, on
        ``noise`` (the ``multi_noise`` layout) when given.  Returns the
        end_points dict."""
        if self.training:
            raise RuntimeError("generate runs on the running statistics: call model.eval() first")
        if multi_mode and noise is None:
            if generator is None:
                raise ValueError("multi_mode: pass the noise or a generator of the model's device")
            noise = self.multi_noise(input_joints.shape[0], n_samples, generator)
        assert_precision_policy()
        end_points, xyz, features = self._trunk(input_joints, folded=folded, generator=generator)
        return self.detection(xyz, features, end_points, noise=noise if multi_mode else None)
