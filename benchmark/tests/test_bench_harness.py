"""The harness finds a cell made of files alone and prints the result line
(CPU, tiny sizes)."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import cells, result, spec

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run_line(root, workload, trace, seed=2 ** 31 + 5):
    cell = spec.load_cell(root, workload)
    ctx = cells.run(cell, seed, 0.5, trace, torch.device("cpu"), time.perf_counter())
    return cell, result.line_of(ctx, trace, torch.device("cpu"))


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
    cell, line = run_line(tiny_root, "tiny-generate-cell", trace=True)
    assert line["device"]["busy_s"] == 0.0 and line["device"]["window_s"] > 0
    # no device operation ran: every device metric is left out, none reads 0
    assert set(line["metrics"]) <= {"loader_wait_ms.train"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"} and len(line["breakdown"]["idle_gaps"]) <= 10


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
