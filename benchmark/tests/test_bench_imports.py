"""The import check compares top-level module names whole, and the
reference imports nothing of the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import torch

from benchmark.harness import result, spec
from benchmark.harness.result import forbidden_modules

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_top_level_names_compared_whole():
    assert forbidden_modules({"pose2room_tpu_torch": 1, "pose2room_tpu_torch.models.p2rnet": 1,
                              "numpy": 1}) == []
    assert forbidden_modules({"pose2room_tpu": 1}) == ["pose2room_tpu"]
    assert forbidden_modules({"pose2room_tpu.models.p2rnet": 1}) == ["pose2room_tpu"]
    assert forbidden_modules({"jax": 1, "jaxlib.xla_client": 1, "flax.linen": 1}) == ["flax", "jax", "jaxlib"]
    assert forbidden_modules({"jaxtyping": 1, "flaxen": 1}) == []


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_neither_jax_nor_either_package():
    ref = os.path.join(BENCH, "reference")
    names = [n for f in os.listdir(ref) if f.endswith(".py") for n in _imported(os.path.join(ref, f))]
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"jax", "jaxlib", "flax", "pose2room_tpu", "pose2room_tpu_torch"}, tops
    code = ("import sys; import benchmark.reference.p2rnet, benchmark.reference.loss, benchmark.harness.checks; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'pose2room_tpu', 'pose2room_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(BENCH), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_harness_loads_no_jax():
    code = ("import sys; import benchmark.harness.result, benchmark.harness.cells; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'pose2room_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(BENCH), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


STAND_IN = "bench_forbidden_stand_in"


def test_reader_that_loads_a_forbidden_module_gives_no_line(tiny_root, tmp_path, monkeypatch, capsys):
    """The check runs once the metric readers (found by name, added by later
    changes) have run: a reader that imports a forbidden top-level module
    leaves no result line.  A stand-in module takes JAX's place."""
    mods = tmp_path / "mods"
    mods.mkdir()
    (mods / f"{STAND_IN}.py").write_text("LOADED = True\n")
    monkeypatch.syspath_prepend(str(mods))
    metrics = os.path.join(tiny_root, "benchmark", "metrics")
    os.unlink(metrics)
    shutil.copytree(os.path.join(BENCH, "metrics"), metrics)
    with open(os.path.join(metrics, "stand_in_import.py"), "w") as f:
        f.write(f"def read(ctx):\n    import {STAND_IN}  # noqa: F401\n\n    return 1.0\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["end_to_end"].append({"name": "stand_in_import", "unit": "s", "better": "lower", "bound": 0.1,
                                "source": "host_clock", "workloads": ["tiny-generate-cell"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    cell = spec.load_cell(tiny_root, "tiny-generate-cell")
    cpu = torch.device("cpu")
    try:
        line = result.run_and_report(cell, 2 ** 31 + 21, 0.3, False, cpu, time.perf_counter())
        assert line is not None and "stand_in_import" in line["metrics"]  # not forbidden: a line
        monkeypatch.setattr(result, "FORBIDDEN", result.FORBIDDEN + (STAND_IN,))
        capsys.readouterr()
        assert result.run_and_report(cell, 2 ** 31 + 21, 0.3, False, cpu, time.perf_counter()) is None
        assert STAND_IN in capsys.readouterr().err
    finally:
        sys.modules.pop(STAND_IN, None)
