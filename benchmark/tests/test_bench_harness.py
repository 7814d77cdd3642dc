"""The harness finds a cell made of files alone and prints the result line
(CPU, tiny sizes)."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import cells, result, spec, work

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
SPAN_METRICS = ("step_host_ms.train", "h2d_host_ms.train", "noise_host_ms.train", "backward_host_ms.train",
                "optimizer_host_ms.train", "loader_cpu_ms.train")


def run_ctx(root, workload, trace, seed=2 ** 31 + 5):
    cell = spec.load_cell(root, workload)
    ctx = cells.run(cell, seed, 0.5, trace, torch.device("cpu"), time.perf_counter())
    return cell, ctx, result.line_of(ctx, trace, torch.device("cpu"))


def run_line(root, workload, trace, seed=2 ** 31 + 5):
    cell, _, line = run_ctx(root, workload, trace, seed)
    return cell, line


def own_dir(root, sub):
    """Replace the tiny root's link to the benchmark's ``sub`` by a copy, so
    that a test can add files there."""
    path = os.path.join(root, "benchmark", sub)
    os.unlink(path)
    shutil.copytree(os.path.join(BENCH, sub), path)
    return path


@pytest.mark.parametrize("workload", ["tiny-generate-cell", "tiny-sparse-cell", "tiny-train-cell"])
def test_cell_of_new_files_runs_and_prints_the_line(tiny_root, workload):
    cell, line = run_line(tiny_root, workload, trace=False)
    assert list(line) == LINE_KEYS  # the comparison's numbers come last
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    e2e = {m["name"] for m in cell.end_to_end}
    assert set(line["metrics"]) == e2e and "setup_s" in e2e and len(e2e) >= 2
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    assert set(line["checks"]) == set(cell.limits)
    json.dumps(line)


def test_traced_run_reads_no_device_metric_on_the_cpu(tiny_root):
    cell, ctx, line = run_ctx(tiny_root, "tiny-generate-cell", trace=True)
    assert line["device"]["busy_s"] == 0.0 and line["device"]["window_s"] > 0
    # no device operation ran: every device metric is left out, none reads 0
    assert {"batch_device_ms.generate", "backbone_device_ms.generate"} <= {m["name"] for m in cell.per_layer}
    assert set(line["metrics"]) <= {"loader_wait_ms.train"}
    # the backbone's span is in the window: its metric is left out for want of a device
    assert ctx["trace"]["program"]["p2r/model/backbone"]["count"] == ctx["trace"]["iterations"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"} and len(line["breakdown"]["idle_gaps"]) <= 10


def test_traced_train_run_reads_the_program_spans_and_the_loader(tiny_root):
    """The train step's host spans and the loader's CPU counter read above
    0 in a traced run; the counter starts with the traced steps."""
    cell, ctx, line = run_ctx(tiny_root, "tiny-train-cell", trace=True)
    assert set(SPAN_METRICS) <= {m["name"] for m in cell.per_layer}
    got = line["metrics"]
    assert all(got[name]["value"] > 0 for name in SPAN_METRICS), got
    assert got["step_host_ms.train"]["value"] >= (got["backward_host_ms.train"]["value"]
                                                 + got["optimizer_host_ms.train"]["value"])
    assert ctx["shape"] == work.shape_of(cell.config["model"], cell.traffic["batch"])  # the kind states none
    steps = cell.traffic["trace_steps"]
    assert steps <= ctx["spans"]["loader"]["batches"] <= steps + 1  # and the one batch prefetched
    assert ctx["spans"]["loader"]["items"] == ctx["spans"]["loader"]["batches"] * cell.traffic["batch"]


def test_metric_without_a_reader_is_refused(tiny_root):
    with pytest.raises(FileNotFoundError):
        spec.reader(tiny_root, "no_such_metric")


def test_same_seed_same_inputs(tiny_root):
    cell = spec.load_cell(tiny_root, "tiny-generate-cell")
    a, b = (cells.traffic_of(cell, 3_000_000_019, torch.device("cpu")) for _ in range(2))
    assert torch.equal(a.pool, b.pool)
    assert all(torch.equal(a.weights[k], b.weights[k]) for k in a.weights)
    c = cells.traffic_of(cell, 3_000_000_020, torch.device("cpu"))
    assert not torch.equal(a.pool, c.pool) and a.pool.shape == c.pool.shape


def test_traffic_kind_of_a_new_file_runs(tiny_root):
    """A traffic kind is a file found by name: a new loop in kinds/, a mix
    that names it and a cell over that mix run with no file of the harness
    changed."""
    bench = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    kinds = os.path.join(tiny_root, "benchmark", "kinds")
    os.unlink(kinds)
    os.makedirs(kinds)
    with open(os.path.join(bench, "kinds", "generate.py")) as f:
        source = f.read()
    with open(os.path.join(kinds, "tiny-loop.py"), "w") as f:
        f.write(source + "\nMARK = 'tiny-loop'\n")
    here = os.path.join(tiny_root, "benchmark")
    with open(os.path.join(here, "traffic", "tiny-generate.json")) as f:
        traffic = dict(json.load(f), kind="tiny-loop")
    with open(os.path.join(here, "traffic", "tiny-loop.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(here, "limits", "tiny-generate-cell.json")) as f:
        limits = json.load(f)
    with open(os.path.join(here, "limits", "tiny-loop-cell.json"), "w") as f:
        json.dump(limits, f)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench_json = json.load(f)
    bench_json["workloads"].append({"name": "tiny-loop-cell", "config": "tiny", "traffic": "tiny-loop",
                                    "chips": 1, "why": "test"})
    for m in bench_json["end_to_end"]:
        if "tiny-generate-cell" in m.get("workloads", ()):
            m["workloads"].append("tiny-loop-cell")
    with open(path, "w") as f:
        json.dump(bench_json, f)
    assert spec.kind(tiny_root, "tiny-loop").MARK == "tiny-loop"
    cell, line = run_line(tiny_root, "tiny-loop-cell", trace=False)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"clips_per_s", "generate_ms_p95", "setup_s"}


TOY_KIND = '''"""A stand-in kind over a model that is not P2RNet: ``layers`` tanh layers
of ``width`` on batches of ``batch``, each layer in a span ``p2r/toy/layer``."""

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness.cells import span, streams


class Traffic:
    def __init__(self, cell, seed, device):
        self.model, self.traffic = cell.config["model"], cell.traffic
        self.batch, w = self.traffic["batch"], self.model["width"]
        gen = torch.Generator().manual_seed(streams(seed)["weights"])
        self.weights = torch.randn(self.model["layers"], w, w, generator=gen) / w ** 0.5
        self.x = torch.randn(self.batch, w, generator=gen)
        self.kept = None

    def shape(self):
        return {"B": self.batch, "width": self.model["width"], "layers": self.model["layers"]}

    def step(self):
        with span("step"):
            y = self.x
            for w in self.weights:
                with record_function("p2r/toy/layer"):
                    y = torch.tanh(y @ w)
        self.kept = y

    def warm(self):
        self.step()

    def finish(self):
        pass

    def window(self, seconds):
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            self.step()
            n += 1
        return {"items": n * self.batch, "iterations": n, "seconds": time.perf_counter() - t0, "ends": []}

    def traced(self):
        for _ in range(self.traffic["trace_iterations"]):
            self.step()
        return self.traffic["trace_iterations"]

    def close(self):
        pass

    def numbers(self):
        y = self.x.double().numpy()
        for w in self.weights.double().numpy():
            y = np.tanh(y @ w)
        return {"max_err": float(np.abs(self.kept.double().numpy() - y).max())}
'''

TOY_METRICS = {
    "toy_items_per_s": "from benchmark.harness.readers import rate\n\n\ndef read(ctx):\n    return rate(ctx)\n",
    "layer_host_ms.toy": ("from benchmark.harness.readers import span_ms\n\n\ndef read(ctx):\n"
                          "    return span_ms(ctx, \"p2r/toy/layer\")\n"),
}


def test_configuration_of_another_model_runs_with_its_own_kind_and_metric(tiny_root):
    """A configuration whose ``model`` holds none of the keys the P2RNet
    shapes read runs through the harness with no file of the harness
    changed: its kind states its shapes, and a metric of its own reads the
    program span the kind's program records."""
    here = os.path.join(tiny_root, "benchmark")
    model = {"compute_dtype": "float32", "width": 32, "layers": 3}
    with pytest.raises(KeyError):
        work.shape_of(model, 4)
    with open(os.path.join(own_dir(tiny_root, "kinds"), "toy.py"), "w") as f:
        f.write(TOY_KIND)
    metrics = own_dir(tiny_root, "metrics")
    for name, source in TOY_METRICS.items():
        with open(os.path.join(metrics, f"{name}.py"), "w") as f:
            f.write(source)
    with open(os.path.join(here, "configs", "toy.json"), "w") as f:
        json.dump({"model": model}, f)
    with open(os.path.join(here, "traffic", "toy.json"), "w") as f:
        json.dump({"kind": "toy", "batch": 4, "trace_iterations": 3}, f)
    with open(os.path.join(here, "limits", "toy-cell.json"), "w") as f:
        json.dump({"max_err": 1e-5}, f)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy", "source": "test", "file": "benchmark/configs/toy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "toy-cell", "config": "toy", "traffic": "toy", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "toy_items_per_s", "unit": "items/s", "better": "higher", "bound": 0.1,
                                "source": "host_clock", "workloads": ["toy-cell"]})
    bench["per_layer"].append({"name": "layer_host_ms.toy", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "toy", "moves": "toy_items_per_s",
                               "workloads": ["toy-cell"]})
    with open(path, "w") as f:
        json.dump(bench, f)

    cell, line = run_line(tiny_root, "toy-cell", trace=False)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"toy_items_per_s", "setup_s"}
    cell, ctx, line = run_ctx(tiny_root, "toy-cell", trace=True)
    assert ctx["shape"] == {"B": 4, "width": 32, "layers": 3}
    assert ctx["trace"]["program"]["p2r/toy/layer"]["count"] == 3 * 3
    assert set(line["metrics"]) == {"layer_host_ms.toy"} and line["metrics"]["layer_host_ms.toy"]["value"] > 0
    assert line["correct"] is True
    json.dumps(line)


def test_run_exits_without_a_result_where_the_cell_cannot_run(tmp_path):
    """Without the card (here) or without the program beside the benchmark
    (a directory of BENCHMARK.json and benchmark/ alone), no result line."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    subprocess.run(["cp", "-r", os.path.join(root, "benchmark"), os.path.join(root, "BENCHMARK.json"),
                    str(tmp_path)], check=True)
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "generate-b32", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    q = subprocess.run([sys.executable, "-c", "import benchmark.harness.cells"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert q.returncode != 0 and "pose2room_tpu_torch" in q.stderr
