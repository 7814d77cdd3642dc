"""Fixtures of the benchmark's own tests: a cell made of files in a
temporary directory at a tiny size (the CPU runs the program's kernels'
plain versions there), and the card where a test needs one.

Run from the repository's root: ``python -m pytest benchmark/tests -q``
(CPU), ``python -m pytest benchmark/tests -m gpu -q`` on a machine with
the card."""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_MODEL = {"num_frames": 96, "num_seeds": 64, "num_proposals": 16, "num_gaussian": 10}
TINY_TRAFFIC = {
    "tiny-train": {"kind": "train", "batch": 2, "scenes": 4, "objects": [2, 5], "frames": 120,
                   "workers": 2, "epoch_items": 64, "checked_steps": 3, "warm_steps": 1, "trace_steps": 2},
    "tiny-generate": {"kind": "generate", "batch": 2, "scenes": 4, "objects": [2, 5], "frames": 120,
                      "angles": [0, 90], "warm_batches": 1, "trace_batches": 2},
}
# sound tiny runs on the CPU read well under these (the parameters' change
# over three steps parts further at this size than at full width; the
# change's direction, update_cos, reads 0.25-0.27 on six seeds, an ascent
# 1.97-1.99); each fault of test_bench_faults.py reads above them
TINY_LIMITS = {
    "train": {"batch_gap": 0.0, "seed_gap": 1e-4, "vote_gap": 1e-3, "fps_gap": 1e-3, "ball_gap": 1e-3,
              "loss1_gap": 1e-4, "grad_gap": 0.01, "update_gap": 0.3, "update_cos": 1.0},
    "generate": {"seed_gap": 1e-4, "vote_gap": 1e-3, "fps_gap": 1e-3, "ball_gap": 1e-3, "box_gap": 1e-3},
}
TINY_CELLS = (("tiny-train-cell", "tiny", "tiny-train"), ("tiny-generate-cell", "tiny", "tiny-generate"),
              ("tiny-sparse-cell", "tiny-sparse", "tiny-generate"))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips inside a fixture where none is present")


def write_root(root):
    """BENCHMARK.json and the files of three tiny cells under ``root``, with
    the benchmark's own metric readers, kernel counts and traffic kinds
    linked in."""
    here = os.path.join(root, "benchmark")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(here, sub), exist_ok=True)
    for sub in ("metrics", "counts", "kinds"):
        os.symlink(os.path.join(BENCH, sub), os.path.join(here, sub))
    with open(os.path.join(BENCH, "configs", "p2rnet-f32.json")) as f:
        base = json.load(f)
    configs = []
    for name, sparse in (("tiny", False), ("tiny-sparse", True)):
        cfg = dict(base, name=name, model=dict(base["model"], sparse_eval=sparse, **TINY_MODEL))
        path = f"benchmark/configs/{name}.json"
        with open(os.path.join(root, path), "w") as f:
            json.dump(cfg, f)
        configs.append({"name": name, "source": "tiny", "file": path, "reduced": list(TINY_MODEL), "why": "test"})
    for name, traffic in TINY_TRAFFIC.items():
        with open(os.path.join(here, "traffic", f"{name}.json"), "w") as f:
            json.dump(traffic, f)
    workloads = []
    for name, config, traffic in TINY_CELLS:
        workloads.append({"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "test"})
        with open(os.path.join(here, "limits", f"{name}.json"), "w") as f:
            json.dump(TINY_LIMITS[TINY_TRAFFIC[traffic]["kind"]], f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    gen = [w["name"] for w in workloads if "generate" in w["traffic"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-train-cell"] if m["workloads"] == ["train-b8"] else gen
    bench.update(configs=configs, workloads=workloads)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_root(str(tmp_path))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
