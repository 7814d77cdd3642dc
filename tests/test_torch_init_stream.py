"""The port's seeded weight init gives the same weights on every torch
release, and the trace script that found where two machines part ways.

The same seeded CPU run gave other numbers on torch 2.13 than on torch 2.11
(ROADMAP §3): ``scripts/torch_cpu_trace.py`` on both machines found the data
equal and the first differing tensor the first weight the init draws, every
element of it.  ``nn.init.trunc_normal_`` draws by the inverse CDF in 2.11
and by rejection from normals in 2.13; ``models/layers.py:lecun_normal_``
now draws by the inverse CDF itself, and gives on torch 2.13 the weights
that torch 2.11 gave.
"""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from pose2room_tpu_torch.models import layers
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig

SMALL = dict(num_frames=96, num_seeds=64, num_proposals=16, num_gaussian=10)
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "torch_cpu_trace.py")

# P2RNet(SMALL) from torch.Generator seed 42, as torch 2.11.0 (CPU) drew it
# (scripts/torch_cpu_trace.py on an H100 machine's CPU): the first three
# and the last three values of the first and the last lecun-normal kernel
GOLDEN_2_11 = {
    "backbone.pos_embed.0.conv.weight": (
        ("0x1.727fa6p-1", "0x1.a75920p-1", "-0x1.7dcceep-3"), None),
    "detection.gmm_heading.mdn.pi.conv.weight": (
        None, ("0x1.27eab4p-3", "0x1.48d230p-3", "-0x1.77a664p-5")),
}


def test_init_equals_torch_2_11_weights():
    sd = P2RNet(P2RNetConfig(**SMALL), device="cpu", generator=torch.Generator().manual_seed(42)).state_dict()
    for name, (head, tail) in GOLDEN_2_11.items():
        flat = sd[name].flatten().tolist()
        if head:
            assert flat[:3] == [float.fromhex(h) for h in head], name
        if tail:
            assert flat[-3:] == [float.fromhex(h) for h in tail], name


def test_init_does_not_call_nn_init_trunc_normal(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("nn.init.trunc_normal_ changed its sampling between torch releases")

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", refuse)
    P2RNet(P2RNetConfig(**SMALL), device="cpu", generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("fan_in", [3, 192])
def test_lecun_normal_is_truncated_at_two_std(fan_in):
    """Inside [-2, 2] std units, variance 1/fan_in (flax's lecun_normal)."""
    t = layers.lecun_normal_(torch.empty(200_000), fan_in, torch.Generator().manual_seed(1))
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    assert t.abs().max().item() <= 2.0 * std
    assert abs(t.std().item() * math.sqrt(fan_in) - 1.0) < 0.01
    assert abs(t.mean().item()) < 0.01 * std


def _trace_module():
    spec = importlib.util.spec_from_file_location("torch_cpu_trace", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("digests", [False, True])
def test_trace_compare_names_the_first_difference(tmp_path, capsys, digests):
    trace = _trace_module()
    records = {"data/x": np.arange(4, dtype=np.float32), "init/w": np.ones(3, np.float32),
               "call/0001/y": np.zeros(2, np.float32)}
    other = dict(records, **{"init/w": np.array([1, 1, 2], np.float32), "call/0001/y": np.ones(2, np.float32)})
    for path, rec in (("a.npz", records), ("b.npz", other)):
        if digests:
            rec = {k: trace.digest(v) for k, v in rec.items()}
        np.savez(tmp_path / path, _order=np.array(list(rec)), _versions=np.array(path),
                 _digests=np.array(digests), **{k.replace("/", "|"): v for k, v in rec.items()})
    trace.compare(str(tmp_path / "a.npz"), str(tmp_path / "b.npz"))
    out = capsys.readouterr().out
    assert "first difference: init/w" in out
    assert "2 of 3 recorded tensors differ" in out
    trace.compare(str(tmp_path / "a.npz"), str(tmp_path / "a.npz"))
    assert "agree bit for bit" in capsys.readouterr().out
