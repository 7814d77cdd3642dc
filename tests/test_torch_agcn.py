"""2s-AGCN (joint stream) on the port against its plain reference, on the CPU.

* the port (``models/agcn.py``) against ``tests/agcn_reference.py`` at a
  tiny size (N 2, M 2, T 16, V 25, widths 8 / 16 / 32 with both strided
  units kept), seeded random weights on every leaf: logits, each unit's
  output and the first unit's C_k, in float64 and f32;
* C_k is per sample: permuting the batch permutes the logits, and two
  samples give different maps; each of A, B (``PA``) and C_k moves the
  output;
* ``build_ntu_graph`` against rows of the published partition written out;
* ``TemporalConv``: 3 taps at stride 1 bit-equal to its shifted products,
  9 taps at stride 2 against ``conv2d``;
* ``build_model`` with ``method: AGCN`` (the runners refuse it), and the
  model's spans under a profiler.
"""

import math
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import agcn_reference as ref
from pose2room_tpu_torch.models.agcn import AGCN, AGCNConfig
from pose2room_tpu_torch.models.graph import build_ntu_graph
from pose2room_tpu_torch.models.layers import TemporalConv
from pose2room_tpu_torch.runners.common import METHODS, build_model, setup

TINY = dict(num_class=10, widths=(8, 8, 16, 16, 32, 32), strides=(1, 1, 2, 1, 2, 1))
N, M, T, V = 2, 2, 16, 25


def random_weights(names_shapes, seed):
    """Every leaf random: convs at 1/sqrt(fan_in), biases and BN shifts
    small, BN scales and running variances near 1, PA beside the graph's
    entries."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in names_shapes.items():
        z = torch.randn(shape, generator=gen, dtype=torch.float64)
        if name.endswith("running_var"):
            x = torch.exp(0.2 * z)
        elif name.endswith("running_mean") or name.endswith("bias"):
            x = 0.1 * z
        elif name.endswith("PA"):
            x = 0.1 * z
        elif len(shape) == 1:  # a BN scale
            x = 1.0 + 0.2 * z
        else:
            x = z / math.sqrt(math.prod(shape[1:]))
        out[name] = x.float()
    return out


def models(dtype=torch.float32, seed=3, **cfg):
    cfg = {**TINY, **cfg}
    reference = ref.Model(num_class=cfg["num_class"], widths=cfg["widths"], strides=cfg["strides"])
    shapes = {k: tuple(v.shape) for k, v in reference.state_dict().items() if not k.endswith("num_batches_tracked")}
    weights = random_weights(shapes, seed)
    ref.load(reference, weights).eval().to(dtype)
    port = AGCN(AGCNConfig(**cfg), device="cpu")
    port.load_state_dict(weights, strict=True)
    return port.eval().to(dtype), reference


def skeletons(seed=0, n=N, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3, T, V, M).cumsum(2) * 0.1
    x[1:, ..., 1] = 0  # a second body absent, as NTU stores it
    return torch.from_numpy(x).to(dtype)


def unit_outputs(port, x):
    got = []
    hooks = [u.register_forward_hook(lambda m, i, o: got.append(o)) for u in port.units]
    try:
        logits = port(x)
    finally:
        for h in hooks:
            h.remove()
    return logits, got


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12), (torch.float32, 2e-5)])
def test_port_matches_the_reference(dtype, tol):
    port, reference = models(dtype)
    x = skeletons(dtype=dtype)
    with torch.no_grad():
        logits, units = unit_outputs(port, x)
        keep = []
        want = reference(x, keep)
        att = port.attention(x)
    assert logits.shape == (N, TINY["num_class"]) and logits.dtype == dtype
    assert rel(logits, want) < tol
    assert len(units) == len(keep) == len(TINY["widths"])
    for got, ref_out in zip(units, keep):  # channels-last against (N*M, C, T, V)
        assert rel(got.permute(0, 3, 1, 2), ref_out) < tol
    assert units[-1].shape == (N * M, T // 4, V, TINY["widths"][-1])
    assert (att - reference.l1.gcn1.attention).abs().max() < tol / 10


def test_attention_is_per_sample():
    port, _ = models(torch.float64)
    x = skeletons(seed=5, n=3, dtype=torch.float64)
    perm = torch.tensor([2, 0, 1])
    with torch.no_grad():
        logits, permuted = port(x), port(x[perm])
        att = port.attention(x).view(3, M, 3, V, V)
    assert torch.allclose(permuted, logits[perm], rtol=0, atol=1e-12)
    assert (att[0, 0] - att[2, 0]).abs().max() > 1e-3
    assert torch.allclose(att.sum(-2), torch.ones_like(att.sum(-2)))  # softmax over dim -2


@pytest.mark.parametrize("term", ["A", "PA", "C"])
def test_each_adjacency_term_moves_the_output(monkeypatch, term):
    port, _ = models(torch.float64)
    x = skeletons(seed=7, dtype=torch.float64)
    with torch.no_grad():
        base = port(x)
        for unit in port.units:
            g = unit.gcn1
            if term == "A":
                g.A.zero_()
            elif term == "PA":
                g.PA.zero_()
            else:
                monkeypatch.setattr(g, "attention", lambda h, g=g: torch.zeros_like(g.A).expand(h.shape[0], -1, -1, -1))
        moved = port(x)
    assert rel(moved, base) > 1e-2


def test_ntu_graph_rows():
    A = build_ntu_graph()
    assert A.shape == (3, 25, 25) and A.dtype == np.float32
    assert np.array_equal(A[0], np.eye(25))
    # inward: column i holds the edge from joint i to its parent (0-based);
    # the spine at the shoulders (20) has none
    parent = {0: 1, 1: 20, 2: 20, 3: 2, 4: 20, 5: 4, 6: 5, 7: 6, 8: 20, 9: 8, 10: 9, 11: 10, 12: 0, 13: 12,
              14: 13, 15: 14, 16: 0, 17: 16, 18: 17, 19: 18, 21: 22, 22: 7, 23: 24, 24: 11}
    want_in = np.zeros((25, 25))
    for child, par in parent.items():
        want_in[par, child] = 1.0
    assert np.array_equal(A[1], want_in)
    # outward: column j spreads over j's children, each 1 / their number
    assert np.allclose(A[2][:, 20], np.isin(np.arange(25), [1, 2, 4, 8]) * 0.25)
    assert np.allclose(A[2][:, 0], np.isin(np.arange(25), [12, 16]) * 0.5)
    assert np.array_equal(A[2][:, 3], np.zeros(25))  # the head ends a chain
    assert np.array_equal(A, ref.ntu_graph())


def test_temporal_conv_three_taps_bit_equal_to_shifted_products():
    torch.manual_seed(0)
    conv = TemporalConv(16)
    torch.nn.init.normal_(conv.weight)
    torch.nn.init.normal_(conv.bias)
    x = torch.randn(2, 12, 5, 16)
    taps = conv.weight[..., 0].permute(2, 1, 0)
    zero = torch.zeros_like(x[:, :1])
    want = (torch.cat([zero, x[:, :-1]], 1) @ taps[0] + x @ taps[1] + torch.cat([x[:, 1:], zero], 1) @ taps[2]
            + conv.bias)
    assert torch.equal(conv(x), want)


@pytest.mark.parametrize("taps, stride, frames", [(9, 2, 300), (9, 2, 75), (9, 1, 20), (5, 3, 11)])
def test_temporal_conv_k_taps_strided_against_conv2d(taps, stride, frames):
    torch.manual_seed(1)
    conv = TemporalConv(8, taps, stride=stride).double()
    torch.nn.init.normal_(conv.weight)
    torch.nn.init.normal_(conv.bias)
    x = torch.randn(3, frames, 4, 8, dtype=torch.float64)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, stride=(stride, 1),
                                      padding=((taps - 1) // 2, 0)).permute(0, 2, 3, 1)
    got = conv(x)
    assert got.shape == (3, (frames - 1) // stride + 1, 4, 8)
    assert torch.allclose(got, want, rtol=0, atol=1e-12)


def test_build_model_builds_agcn_from_its_method():
    assert METHODS["AGCN"] is AGCN
    cfg = {"method": "AGCN", "seed": 11, "model": {**TINY, "widths": list(TINY["widths"]),
                                                   "strides": list(TINY["strides"])}}
    a, b = build_model(cfg, device="cpu"), build_model(dict(cfg), device="cpu")
    assert isinstance(a, AGCN) and a.config == AGCNConfig(**TINY) and not a.training
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in a.state_dict())
    assert float(a.l1.gcn1.PA.detach().abs().max()) == pytest.approx(1e-6)  # the published init
    with torch.no_grad():
        assert a(skeletons()).shape == (N, TINY["num_class"])
    with pytest.raises(KeyError):
        build_model({"method": "AGCN", "model": {"channels": 64}}, device="cpu")
    with pytest.raises(NotImplementedError):  # the runners drive P2RNet
        setup(types.SimpleNamespace(config=cfg), device="cpu")


def test_forward_records_its_spans():
    port, _ = models()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            port(skeletons())
    spans = [e for e in prof.events() if e.device_type == DeviceType.CPU and e.name.startswith("p2r/agcn/")]
    counts = {name: sum(e.name == name for e in spans) for name in {e.name for e in spans}}
    units = len(TINY["widths"])
    assert counts == {"p2r/agcn/forward": 1, "p2r/agcn/gcn": units, "p2r/agcn/adjacency": units,
                      "p2r/agcn/tcn": units}
    for e in spans:
        if e.name == "p2r/agcn/adjacency":
            assert e.cpu_parent.name == "p2r/agcn/gcn"
        elif e.name in ("p2r/agcn/gcn", "p2r/agcn/tcn"):
            assert e.cpu_parent.name == "p2r/agcn/forward"
