"""The work counts against sums done by hand, and the counts found by the
device kernels' names."""

import json
import os

import numpy as np
import pytest

from benchmark.harness import spec, work
from benchmark.reference.graph import spatial_graph

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@pytest.fixture
def full():
    with open(os.path.join(BENCH, "configs", "p2rnet-f32.json")) as f:
        return json.load(f)["model"]


def test_adjacency_nonzeros_and_partitions_match_the_graph(full):
    A = spatial_graph(full["num_joints"], full["max_hop"])
    assert A.shape[0] == full["partitions"] == 11
    assert int((A != 0).sum()) == full["adjacency_nonzeros"] == 971


def test_forward_flops_by_hand(full):
    s = work.shape_of(full, 1)
    T, V, C = 768, 53, 64
    gcn = 6 * (2 * T * V * C * 11 * C + 2 * T * C * 971)
    tcn = 6 * 2 * T * V * 3 * C * C
    mlps = 2 * T * 20 * (3 * 64 + 64 * 64 + 64 * 64) + 2 * T * V * (3 * 64 + 64 * 64 + 64 * 64)
    joint = 2 * T * V * C * 256
    vote = 2 * 512 * (256 * 256 * 2 + 256 * 259)
    agg = 2 * 128 * 16 * 256 * 256 * 2
    heads = 3 * 2 * 128 * (256 * 128 + 128 * 128 + 128 * 128 + 128 * 100) + 2 * 128 * 100 * (3 + 3 + 2)
    sem = 2 * 128 * (256 * 128 + 128 * 128 + 128 * 24)
    assert work.forward_flops(s) == gcn + tcn + mlps + joint + vote + agg + heads + sem
    # train: forward + a weight gradient everywhere + an input gradient except into the data
    data_layers = 2 * T * 20 * 3 * 64 + 2 * T * V * 3 * 64
    assert work.train_flops(s) == 3 * work.forward_flops(s) - data_layers
    assert work.forward_flops(work.shape_of(full, 32)) == work.forward_flops(s)  # per clip


def test_kernel_counts_by_hand(full):
    s = work.shape_of(full, 8)
    counts = spec.kernel_counts(ROOT)
    rows = 8 * 768 * 53
    fps = counts["fps_kernel"](s)
    assert fps == {"flops": 9 * 8 * 512 * 128, "bytes": 4 * 8 * (512 * 3 + 128), "rate": 67e12}
    fwd = counts["train_fwd_kernel"](s)
    assert fwd["flops"] == 2 * 3 * 64 * 64 * rows and fwd["rate"] == 495e12 / 3
    assert fwd["bytes"] == 4 * (2 * rows * 64 + 2 * 8 * 53 * 64 + 3 * 64 * 64 + 3 * 53 * 64)
    assert counts["train_bwd_kernel"](s)["flops"] == 2 * fwd["flops"]
    ep = counts["epilogue_kernel"](s)
    assert ep["flops"] == fwd["flops"] and ep["bytes"] > 4 * rows * 64 * 2.8
    sp = counts["sparse_kernel"](s)
    assert sp["flops"] == 8 * 768 * (2 * 53 * 64 * 11 * 64 + 2 * 971 * 64)
    # the bound: the larger of bytes at 3.35 TB/s and operations at the rate
    assert work.bound_s(1e12, 1.0, 1e12) == 1.0 and work.bound_s(1.0, 3.35e12, 1e15) == 1.0


def test_count_found_by_whole_word_of_the_device_name():
    assert spec.counted(ROOT, "void fps_kernel<4, 4>(float const*, int, int, int*)")[0] == "fps_kernel"
    assert spec.counted(ROOT, "epilogue_kernel(float const*, float const*, float const*)")[0] == "epilogue_kernel"
    assert spec.counted(ROOT, "epilogue_kernel_bf16(__nv_bfloat16 const*)") is None
    assert spec.counted(ROOT, "ampere_sgemm_128x64_nn") is None


def test_roofline_share_of_a_kernel_at_its_bound_reads_100():
    from benchmark.harness.readers import kernel_roofline_pct

    s = {"B": 1, "S": 512, "P": 128}
    c = spec.kernel_counts(ROOT)["fps_kernel"](s)
    t = work.bound_s(c["flops"], c["bytes"], c["rate"])
    ctx = {"root": ROOT, "shape": s,
           "trace": {"busy_s": 2 * t, "window_s": 1.0, "iterations": 1,
                     "kernels": {"void fps_kernel<4, 4>(float const*)": [2, 2 * t], "sgemm": [1, 5.0]}}}
    assert kernel_roofline_pct(ctx) == pytest.approx(100.0)
    assert np.isclose(kernel_roofline_pct(dict(ctx, trace=dict(ctx["trace"], kernels={
        "void fps_kernel<4, 4>(float const*)": [2, 4 * t]}))), 50.0)
