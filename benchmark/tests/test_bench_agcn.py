"""The ``classify`` kind over 2s-AGCN (``agcn-ntu60-f32``): a tiny cell of
new files runs and is correct, C_k dropped from the program's sum is not,
the reference's two copies agree bit for bit, the kind's operation count is
the layer equations', and its skeletons are laid out as 2s-AGCN reads them
(CPU); on the card the control is not correct and the cell's span metrics
read above 0."""

import importlib.util
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import cells, checks, result, spec
from benchmark.reference import agcn as ref_agcn
from pose2room_tpu_torch.models.agcn import GraphUnit

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CELL = "tiny-classify-cell"
TINY_MODEL = {"num_class": 10, "frames": 16, "widths": [8, 8, 16, 16, 32, 32], "strides": [1, 1, 2, 1, 2, 1]}
TINY_TRAFFIC = {"kind": "classify", "batch": 2, "pool_batches": 2, "min_frames": 8, "two_bodies": 0.5,
                "warm_batches": 1, "trace_batches": 2}
# f32 on both sides of the CPU: sound tiny runs read ~1e-7 and ~1e-9
TINY_LIMITS = {"logit_gap": 1e-4, "adj_gap": 1e-6}
SPAN_METRICS = ("gcn_device_ms.classify", "adjacency_device_ms.classify", "tcn_device_ms.classify")
DEVICE_METRICS = SPAN_METRICS + ("batch_device_ms.classify", "idle_pct.classify", "mfu.classify")


def add_classify_cell(root):
    """A tiny 2s-AGCN cell beside the tiny root's cells, reporting the
    classify metrics of BENCHMARK.json."""
    here = os.path.join(root, "benchmark")
    with open(os.path.join(BENCH, "configs", "agcn-ntu60-f32.json")) as f:
        base = json.load(f)
    with open(os.path.join(here, "configs", "tiny-agcn.json"), "w") as f:
        json.dump(dict(base, name="tiny-agcn", model=dict(base["model"], **TINY_MODEL)), f)
    with open(os.path.join(here, "traffic", "tiny-classify.json"), "w") as f:
        json.dump(TINY_TRAFFIC, f)
    with open(os.path.join(here, "limits", f"{CELL}.json"), "w") as f:
        json.dump(TINY_LIMITS, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-agcn", "source": "tiny", "file": "benchmark/configs/tiny-agcn.json",
                             "reduced": list(TINY_MODEL), "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-agcn", "traffic": "tiny-classify", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("clips_per_s", "generate_ms_p95") + DEVICE_METRICS:
            m["workloads"] = [CELL]
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def classify_root(tiny_root):
    return add_classify_cell(tiny_root)


def run(root, trace, device=torch.device("cpu"), seed=2 ** 31 + 11):
    cell = spec.load_cell(root, CELL)
    ctx = cells.run(cell, seed, 0.3, trace, device, time.perf_counter())
    return cell, ctx, result.line_of(ctx, trace, device)


def test_classify_cell_runs_and_is_correct(classify_root):
    cell, ctx, line = run(classify_root, trace=False)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"clips_per_s", "generate_ms_p95", "setup_s"}
    assert line["attempted"] == ctx["window"]["iterations"] * TINY_TRAFFIC["batch"] > 0
    assert set(line["checks"]) == set(TINY_LIMITS)
    assert ctx["shape"]["N"] == TINY_TRAFFIC["batch"] and ctx["shape"]["widths"] == TINY_MODEL["widths"]
    cell, ctx, line = run(classify_root, trace=True)
    program = ctx["trace"]["program"]
    units, batches = len(TINY_MODEL["widths"]), TINY_TRAFFIC["trace_batches"]
    assert program["p2r/agcn/forward"]["count"] == batches
    for name in ("gcn", "adjacency", "tcn"):
        assert program[f"p2r/agcn/{name}"]["count"] == units * batches
    assert program["p2r/agcn/adjacency"]["host_s"] <= program["p2r/agcn/gcn"]["host_s"]
    # no device operation ran on the CPU: the device metrics are left out
    assert {m["name"] for m in cell.per_layer} >= set(DEVICE_METRICS) and not set(line["metrics"]) & set(
        DEVICE_METRICS)
    assert line["correct"] is True


def test_adaptive_map_dropped_is_not_correct(classify_root, monkeypatch):
    """The program's sum over A_k + B_k alone, C_k left out."""
    def without_c(self, x):
        return torch.zeros(x.shape[0], *self.A.shape, dtype=x.dtype, device=x.device)

    monkeypatch.setattr(GraphUnit, "attention", without_c)
    _, _, line = run(classify_root, trace=False)
    assert line["correct"] is False
    assert line["checks"]["logit_gap"]["value"] > 100 * TINY_LIMITS["logit_gap"]


def test_reference_copies_are_bit_equal():
    path = os.path.join(ROOT, "tests", "agcn_reference.py")
    with open(path, "rb") as a, open(os.path.join(BENCH, "reference", "agcn.py"), "rb") as b:
        assert a.read() == b.read()
    spec_ = importlib.util.spec_from_file_location("tests_agcn_reference", path)
    tests_copy = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(tests_copy)
    m = dict(json.load(open(os.path.join(BENCH, "configs", "agcn-ntu60-f32.json")))["model"], **TINY_MODEL)
    kind = spec.kind(ROOT, "classify")
    weights = kind.make_weights(kind.leaf_shapes(m), 5, torch.device("cpu"))
    x = torch.from_numpy(kind.skeletons(np.random.RandomState(2), 2, 16, 8, 0.5))
    outs = []
    for module in (ref_agcn, tests_copy):
        model = module.load(module.Model(num_class=10, widths=m["widths"], strides=m["strides"]), weights).eval()
        with torch.no_grad():
            outs.append((model(x), model.l1.gcn1.attention))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_sample_flops_are_the_layer_equations():
    """The kind's count against the products the reference runs at the
    published widths, one sample, counted by torch's FlopCounterMode on
    shapes alone (meta tensors)."""
    cfg = json.load(open(os.path.join(BENCH, "configs", "agcn-ntu60-f32.json")))["model"]
    kind = spec.kind(ROOT, "classify")
    model = kind.reference_model(cfg).to("meta").eval()
    x = torch.empty(1, 3, cfg["frames"], cfg["num_point"], cfg["num_person"], device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    shape = {"N": 64, "M": 2, "T": 300, "V": 25, "C": 3, "widths": cfg["widths"], "strides": cfg["strides"],
             "K": 3, "coff": 4, "taps": 9, "classes": 60}
    assert kind.sample_flops(shape) == counter.get_total_flops()
    parts = kind.layer_flops(shape)
    assert kind.sample_flops(shape) / 1e9 == pytest.approx(38.81, abs=0.005)
    assert parts["temporal"] / 1e9 == pytest.approx(24.33, abs=0.005)
    assert parts["theta_phi"] / 1e9 == pytest.approx(3.88, abs=0.005)


def test_skeletons_are_centred_padded_ntu_samples():
    kind = spec.kind(ROOT, "classify")
    x = kind.skeletons(np.random.RandomState(0), 64, 300, 40, 0.18)
    assert x.shape == (64, 3, 300, 25, 2) and x.dtype == np.float32
    assert np.array_equal(x[:, :, :, kind.SPINE, 0], np.zeros((64, 3, 300)))  # centred, every frame
    two = np.abs(x[..., 1]).sum((1, 2, 3)) > 0
    assert 0 < two.sum() < 30
    assert np.abs(x[..., 0]).max() < 3.0
    # a body shorter than 300 frames repeats: some frame equals an earlier one
    body = x[0, :, :, :, 0]
    assert any(np.array_equal(body[:, t], body[:, 0]) for t in range(40, 300))


@pytest.mark.gpu
def test_classify_cell_on_the_card(classify_root, cuda_device):
    """The tiny cell traced on the card: correct, the span metrics above 0,
    the adjacency inside the graph units."""
    _, _, line = run(classify_root, trace=True, device=cuda_device)
    assert line["correct"] is True, line["checks"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(DEVICE_METRICS) <= set(got) and all(got[k] > 0 for k in DEVICE_METRICS), got
    assert got["adjacency_device_ms.classify"] <= got["gcn_device_ms.classify"]


SEEDS = (2_147_483_659, 3_000_000_019, 21)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(cuda_device, seed):
    cell = spec.load_cell(ROOT, "agcn-classify-b64")
    ok, compared = checks.judge(spec.kind(ROOT, "classify").control_numbers(cell, seed, cuda_device), cell.limits)
    assert not ok, compared
