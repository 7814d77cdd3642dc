"""Everything of a cell, found by name under a root directory.

``<root>/BENCHMARK.json`` names the cell's configuration (its ``file``),
its traffic mix and its metrics; the rest lives under ``<root>/benchmark/``:

* ``traffic/<traffic>.json``: the mix's parameters, read by the loop of
  its ``kind``;
* ``kinds/<kind>.py``: that loop, a class ``Traffic`` (harness/cells.py
  says what it offers);
* ``limits/<workload>.json``: each compared number's limit;
* ``metrics/<metric>.py``: the metric's reader, ``read(ctx)`` -> a number
  or None (nothing to read: the metric is left out of the line);
* ``counts/<kernel>.py``: ``count(shape)`` -> {"flops", "bytes", "rate"}
  of one launch of the device kernel whose name holds ``<kernel>`` as a
  whole word.

A new cell, configuration, mix, traffic kind, metric or kernel count is
new files and new entries in BENCHMARK.json; no file here changes.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import re


@dataclasses.dataclass(frozen=True)
class Cell:
    root: str
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple  # metric entries this cell reports with --trace 0
    per_layer: tuple  # ... with --trace 1


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _reports(metric, workload, e2e_names):
    """Whether a cell reports ``metric``: the cells its ``workloads`` names;
    without that key, every cell for an end-to-end metric (``setup_s``),
    and for a per-layer metric every cell that reports the end-to-end
    metric it ``moves``."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(root, workload):
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = tuple(m for m in bench["end_to_end"] if _reports(m, workload, ()))
    names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"] if _reports(m, workload, names))
    here = os.path.join(root, "benchmark")
    return Cell(
        root=root, name=workload, chips=int(w["chips"]),
        config=_read_json(os.path.join(root, cfg["file"])),
        traffic=_read_json(os.path.join(here, "traffic", f"{w['traffic']}.json")),
        limits=_read_json(os.path.join(here, "limits", f"{workload}.json")),
        end_to_end=e2e, per_layer=per_layer,
    )


def _module(path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + re.sub(r"\W", "_", os.path.relpath(path)), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def kind(root, name):
    """The module of traffic kind ``name``: benchmark/kinds/<name>.py."""
    path = os.path.join(root, "benchmark", "kinds", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"traffic kind {name!r} has no loop at {path}")
    return _module(path)


@functools.lru_cache(maxsize=None)
def reader(root, metric):
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"metric {metric!r} has no reader at {path}")
    return _module(path).read


@functools.lru_cache(maxsize=None)
def kernel_counts(root):
    """{kernel: count function} of every file under counts/."""
    d = os.path.join(root, "benchmark", "counts")
    return {f[:-3]: _module(os.path.join(d, f)).count
            for f in sorted(os.listdir(d)) if f.endswith(".py") and not f.startswith("_")}


def counted(root, device_name):
    """The count file whose kernel name is a whole word of a device
    operation's name, or None."""
    for kernel, count in kernel_counts(root).items():
        if re.search(rf"(?<![A-Za-z0-9_]){re.escape(kernel)}(?![A-Za-z0-9_])", device_name):
            return kernel, count
    return None
