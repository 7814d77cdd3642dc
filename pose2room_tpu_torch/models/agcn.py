"""2s-AGCN, joint stream: the adaptive graph convolutional network of Shi
et al., "Two-Stream Adaptive Graph Convolutional Networks for
Skeleton-Based Action Recognition" (CVPR 2019; lshiwjx/2s-AGCN
model/agcn.py), as a torch module of the port.

Input (N, C, T, V, M) as published (3 coordinates, 300 frames, 25 joints,
2 bodies); output (N, num_class) logits.  Inside, the layout is
channels-last as in the rest of the port: (N*M, T, V, C), a 1x1
convolution is a product over the last axis, BatchNorm is ``layers.
BatchNorm`` over the last axis, the temporal convolution ``layers.
TemporalConv``.  Parameter names and shapes are the published state_dict's
(``l<i>.gcn1.conv_a.<k>.weight`` (C', C_in, 1, 1), ``l<i>.tcn1.conv.weight``
(C, C, 9, 1), ...), less torch BatchNorm's ``num_batches_tracked``.

A unit is ``relu(tcn(gcn(x)) + res(x))``.  Its graph convolution sums three
subsets k over the adjacency A_k + B_k + C_k(x): A_k the fixed NTU graph
(``graph.build_ntu_graph``), B_k the learned ``PA``, and C_k a per-sample
(V, V) map, the softmax over dim -2 of theta_k(x)^T phi_k(x) / (C' T), with
theta_k, phi_k 1x1 convolutions to C' = C_out / coff_embedding channels
flattened over (t, c).  y = sum_k W_k(x . adj_k), x multiplied on its joint
axis; gcn(x) = relu(BN(y) + down(x)).  The temporal unit is BN(conv 9x1,
stride s); res is 0 in the first unit, the identity where the shapes match,
else a strided 1x1 conv + BN.  The model: a BatchNorm over the (M, V, C)
channels of the input, ten units, the mean over T*V and then over M, a
linear classifier.

``AGCN(config, device=None, generator=None)`` builds its weights on the host
from ``generator`` (the published init: Kaiming for the convs, the graph
convs' branch init, BN scales 1 and 1e-6 in each graph unit, ``PA`` 1e-6)
and moves them to ``device``, the card unless ``device="cpu"``; it runs in
f32 with TF32 off (``device.py``).  ``attention(x)`` returns the first
unit's C_k, which ``forward`` computes and does not return.

Under a profiler ``forward`` records the spans ``agcn/forward``, and in
each unit ``agcn/gcn`` (theta / phi to the ReLU), ``agcn/adjacency`` inside
it (theta / phi, scores, softmax, + A + B) and ``agcn/tcn`` (the temporal
conv, its BN, the residual and the ReLU).
"""

import dataclasses
import math

import torch
from torch import nn

from pose2room_tpu_torch.device import assert_precision_policy, resolve_device
from pose2room_tpu_torch.models.graph import build_ntu_graph
from pose2room_tpu_torch.models.layers import BatchNorm, TemporalConv
from pose2room_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class AGCNConfig:
    num_class: int = 60
    num_point: int = 25
    num_person: int = 2
    in_channels: int = 3
    frames: int = 300  # the clip length inputs are padded to; the model takes any T
    widths: tuple = (64, 64, 64, 64, 128, 128, 128, 256, 256, 256)
    strides: tuple = (1, 1, 1, 1, 2, 1, 1, 2, 1, 1)
    subsets: int = 3
    coff_embedding: int = 4
    temporal_kernel: int = 9
    compute_dtype: str = "float32"

    @classmethod
    def from_cfg(cls, cfg):
        """From a config's ``model`` section (a CONFIG object)."""
        model = dict(cfg.config.get("model", {}) or {})
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(model) - names
        if unknown:
            raise KeyError(f"model keys {sorted(unknown)} are not AGCN's (it takes {sorted(names)})")
        for key in ("widths", "strides"):
            if key in model:
                model[key] = tuple(model[key])
        return cls(**model)


def conv1x1(x, conv):
    """A 1x1 ``nn.Conv2d`` (out, in, 1, 1) on channels-last x (..., in)."""
    return nn.functional.linear(x, conv.weight[:, :, 0, 0], conv.bias)


class GraphUnit(nn.Module):
    """The adaptive graph convolution (published ``unit_gcn``)."""

    def __init__(self, in_channels, out_channels, A, coff_embedding=4):
        super().__init__()
        K = A.shape[0]
        self.inter_c = out_channels // coff_embedding
        self.register_buffer("A", torch.as_tensor(A), persistent=False)
        self.PA = nn.Parameter(torch.as_tensor(A).clone())
        self.conv_a = nn.ModuleList(nn.Conv2d(in_channels, self.inter_c, 1) for _ in range(K))
        self.conv_b = nn.ModuleList(nn.Conv2d(in_channels, self.inter_c, 1) for _ in range(K))
        self.conv_d = nn.ModuleList(nn.Conv2d(in_channels, out_channels, 1) for _ in range(K))
        self.down = (nn.Sequential(nn.Conv2d(in_channels, out_channels, 1), BatchNorm(out_channels))
                     if in_channels != out_channels else None)
        self.bn = BatchNorm(out_channels)

    def attention(self, x):
        """(NM, K, V, V) C_k of channels-last x (NM, T, V, C_in): the
        softmax over dim -2 of the scores theta_k^T phi_k / (C' T)."""
        NM, T, V, _ = x.shape
        K, C = len(self.conv_a), self.inter_c
        w = torch.cat([c.weight[:, :, 0, 0] for c in (*self.conv_a, *self.conv_b)])
        b = torch.cat([c.bias for c in (*self.conv_a, *self.conv_b)])
        ab = nn.functional.linear(x, w, b).view(NM, T, V, 2, K, C)
        theta = ab[:, :, :, 0].permute(0, 3, 2, 1, 4).reshape(NM * K, V, T * C)
        phi = ab[:, :, :, 1].permute(0, 3, 1, 4, 2).reshape(NM * K, T * C, V)
        scores = torch.bmm(theta, phi).view(NM, K, V, V) / (C * T)
        return torch.softmax(scores, dim=-2)

    def forward(self, x):
        NM, T, V, _ = x.shape
        with annotate("agcn/adjacency"):
            adj = self.attention(x) + (self.A + self.PA)
        # x . adj_k on the joint axis, the subsets side by side on the channels
        z = torch.einsum("nkvw,ntvc->ntwkc", adj, x).reshape(NM, T, V, -1)
        w = torch.cat([c.weight[:, :, 0, 0] for c in self.conv_d], dim=1)
        y = nn.functional.linear(z, w, sum(c.bias for c in self.conv_d))
        y = self.bn(y)
        y = y + (x if self.down is None else self.down[1](conv1x1(x, self.down[0])))
        return torch.relu(y)


class TemporalUnit(nn.Module):
    """BN(temporal conv): the published ``unit_tcn``."""

    def __init__(self, channels, kernel_size, stride):
        super().__init__()
        self.conv = TemporalConv(channels, kernel_size, stride=stride)
        self.bn = BatchNorm(channels)

    def forward(self, x):
        return self.bn(self.conv(x))


class Projection(nn.Module):
    """The strided 1x1 conv + BN residual (``unit_tcn`` of kernel 1)."""

    def __init__(self, in_channels, out_channels, stride):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1)
        self.bn = BatchNorm(out_channels)
        self.stride = stride

    def forward(self, x):
        return self.bn(conv1x1(x[:, ::self.stride], self.conv))


class Unit(nn.Module):
    """``TCN_GCN_unit``: relu(tcn(gcn(x)) + res(x))."""

    def __init__(self, in_channels, out_channels, A, stride, residual, kernel_size, coff_embedding):
        super().__init__()
        self.gcn1 = GraphUnit(in_channels, out_channels, A, coff_embedding)
        self.tcn1 = TemporalUnit(out_channels, kernel_size, stride)
        self.identity = residual and in_channels == out_channels and stride == 1
        self.residual = Projection(in_channels, out_channels, stride) if residual and not self.identity else None

    def forward(self, x):
        with annotate("agcn/gcn"):
            h = self.gcn1(x)
        with annotate("agcn/tcn"):
            y = self.tcn1(h)
            if self.identity:
                y = y + x
            elif self.residual is not None:
                y = y + self.residual(x)
            return torch.relu(y)


class AGCN(nn.Module):
    def __init__(self, config=AGCNConfig(), *, device=None, generator=None):
        super().__init__()
        c = config
        if c.compute_dtype != "float32":
            raise NotImplementedError(f"AGCN runs in float32; compute_dtype {c.compute_dtype!r} is not ported")
        if len(c.widths) != len(c.strides):
            raise ValueError(f"{len(c.widths)} widths against {len(c.strides)} strides")
        A = build_ntu_graph(c.num_point)
        if c.subsets != A.shape[0]:
            raise ValueError(f"the NTU graph has {A.shape[0]} subsets, not {c.subsets}")
        device = resolve_device(device)
        self.config = c
        self.data_bn = BatchNorm(c.num_person * c.num_point * c.in_channels)
        width = c.in_channels
        for i, (out, stride) in enumerate(zip(c.widths, c.strides)):
            self.add_module(f"l{i + 1}", Unit(width, out, A, stride, residual=i > 0,
                                              kernel_size=c.temporal_kernel, coff_embedding=c.coff_embedding))
            width = out
        self.fc = nn.Linear(width, c.num_class)
        self.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(0))
        self.eval()
        self.to(device)

    @property
    def units(self):
        return [getattr(self, f"l{i + 1}") for i in range(len(self.config.widths))]

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The published init: Kaiming normal (fan out) for every conv, the
        branch init for the graph convs' W_k, zero conv biases, BN scale 1
        (1e-6 for each graph unit's BN), ``PA`` 1e-6, the classifier
        normal(0, sqrt(2 / num_class)) with a uniform bias."""
        def normal_(t, std):
            t.copy_(torch.randn(t.shape, generator=generator) * std)

        for name, m in self.named_modules():
            if isinstance(m, nn.Conv2d):
                out, _, kh, kw = m.weight.shape
                normal_(m.weight, math.sqrt(2.0 / (out * kh * kw)))
                nn.init.zeros_(m.bias)
            elif isinstance(m, TemporalConv):
                out, _, kh, kw = m.weight.shape
                normal_(m.weight, math.sqrt(2.0 / (out * kh * kw)))
                nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm):
                nn.init.constant_(m.weight, 1e-6 if name.endswith("gcn1.bn") else 1.0)
                nn.init.zeros_(m.bias)
        for unit in self.units:
            g = unit.gcn1
            for conv in g.conv_d:
                out, cin, kh, _ = conv.weight.shape
                normal_(conv.weight, math.sqrt(2.0 / (out * cin * kh * len(g.conv_d))))
            nn.init.constant_(g.PA, 1e-6)
        normal_(self.fc.weight, math.sqrt(2.0 / self.config.num_class))
        bound = 1.0 / math.sqrt(self.fc.in_features)
        self.fc.bias.copy_(torch.rand(self.fc.bias.shape, generator=generator) * 2 * bound - bound)

    def persons(self, x):
        """(N, C, T, V, M) -> channels-last (N*M, T, V, C) through the data
        BatchNorm over the (M, V, C) channels."""
        N, C, T, V, M = x.shape
        h = self.data_bn(x.permute(0, 2, 4, 3, 1).reshape(N, T, M * V * C))
        return h.view(N, T, M, V, C).transpose(1, 2).reshape(N * M, T, V, C)

    def attention(self, x):
        """(N*M, K, V, V): the first unit's C_k for the input x."""
        return self.units[0].gcn1.attention(self.persons(x))

    def forward(self, x):
        """x: (N, C, T, V, M) f32 on the model's device -> (N, num_class)."""
        assert_precision_policy()
        with annotate("agcn/forward"):
            N, M = x.shape[0], x.shape[-1]
            h = self.persons(x)
            for unit in self.units:
                h = unit(h)
            pooled = h.mean((1, 2)).view(N, M, -1).mean(1)
            return self.fc(pooled)
