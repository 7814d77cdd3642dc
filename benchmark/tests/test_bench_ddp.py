"""The ``ddp`` kind (``train-ddp4-b8``'s loop) at a tiny size on the CPU:
the global batches it recomputes are the loader's shards interleaved, and
a cell of two gloo ranks (rank 0 this process, rank 1 spawned) runs, is
correct against the reference trained on the global batch, counts world x
batch x steps, and its traced window holds the program's train spans and
the DDP hook's all-reduce span."""

import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark.harness import cells, result, scenes, spec
from pose2room_tpu_torch.data.dataset import SceneDataset
from pose2room_tpu_torch.data.loader import DataLoader

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CELL = "tiny-ddp-cell"
TINY_DDP = {"kind": "ddp", "world": 2, "batch": 2, "scenes": 4, "objects": [2, 5], "frames": 120, "workers": 2,
            "epoch_items": 64, "checked_steps": 3, "warm_steps": 1, "trace_steps": 2}
TRAIN_METRICS = ("train_samples_per_s", "step_host_ms.train", "h2d_host_ms.train", "noise_host_ms.train",
                 "backward_host_ms.train", "optimizer_host_ms.train", "loader_cpu_ms.train", "loader_wait_ms.train",
                 "step_device_ms.train", "idle_pct.train", "kernel_roofline.train", "allreduce_device_ms.train",
                 "mfu.ddp")
HOST_SPAN_METRICS = ("step_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train",
                     "loader_cpu_ms.train")


def add_ddp_cell(root):
    here = os.path.join(root, "benchmark")
    with open(os.path.join(here, "traffic", "tiny-ddp.json"), "w") as f:
        json.dump(TINY_DDP, f)
    with open(os.path.join(here, "limits", "tiny-train-cell.json")) as f:
        limits = json.load(f)
    with open(os.path.join(here, "limits", f"{CELL}.json"), "w") as f:
        json.dump(limits, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": CELL, "config": "tiny", "traffic": "tiny-ddp", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in TRAIN_METRICS:
            m["workloads"] = [CELL]
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def test_reference_batches_are_the_shards_interleaved():
    kind = spec.kind(ROOT, "ddp")
    scene_list = scenes.make_scenes(np.random.RandomState(3), 3, [2, 5], 120)
    world, batch, seed, items = 2, 2, 17, 10  # 10 rows: the order repeats up to whole global batches
    want = kind.reference_batches(scene_list, seed, batch, world, 3, 96, items)
    reps = -(-items // len(scene_list))
    loaders = [DataLoader(SceneDataset(scene_list * reps, num_frames=96, augment=True), batch_size=batch,
                          shuffle=True, seed=seed, num_workers=0, process_index=r, process_count=world)
               for r in range(world)]
    shards = [list(loader)[:3] for loader in loaders]
    for b in range(3):
        for k in kind.GT_KEYS:
            assert np.array_equal(want[b][k], kind.interleave([shards[r][b][k] for r in range(world)])), (b, k)
    assert want[0]["input_joints"].shape[0] == world * batch


def test_ddp_cell_of_two_gloo_ranks_runs_and_is_correct(tiny_root):
    root = add_ddp_cell(tiny_root)
    cell = spec.load_cell(root, CELL)
    ctx = cells.run(cell, 2 ** 31 + 13, 0.5, True, torch.device("cpu"), time.perf_counter())
    line = result.line_of(ctx, True, torch.device("cpu"))
    assert line["correct"] is True, line["checks"]
    w = ctx["window"]
    assert w["iterations"] > 0 and w["items"] == TINY_DDP["world"] * TINY_DDP["batch"] * w["iterations"]
    program = ctx["trace"]["program"]
    steps = TINY_DDP["trace_steps"]
    assert program["p2r/train/step"]["count"] == steps
    assert program["p2r/train/allreduce"]["count"] >= steps  # one a gradient bucket
    got = line["metrics"]
    assert all(got[name]["value"] > 0 for name in HOST_SPAN_METRICS), got
    # no device operation on the CPU: the device and MFU metrics are left out
    assert not {"step_device_ms.train", "allreduce_device_ms.train", "mfu.ddp"} & set(got)
    assert ctx["spans"]["loader"]["items"] == ctx["spans"]["loader"]["batches"] * TINY_DDP["batch"]
    for key in ("RANK", "WORLD_SIZE", "MASTER_PORT"):
        assert key not in os.environ


@pytest.mark.gpu
def test_ddp_control_is_not_correct(cuda_device):
    """The reference trained on the global batches with TF32 on, on the
    card, by the limits of ``train-ddp4-b8``."""
    from benchmark.harness import checks

    cell = spec.load_cell(ROOT, "train-ddp4-b8")
    for seed in (2_147_483_659, 21):
        ok, compared = checks.judge(spec.kind(ROOT, "ddp").control_numbers(cell, seed, cuda_device), cell.limits)
        assert not ok, compared
