"""A run's result line: the metrics by their readers, the device, the
comparison's numbers beside their limits, and the import check."""

import sys

import torch

from benchmark.harness import cells, checks, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "pose2room_tpu")


def forbidden_modules(modules=None):
    """Top-level names in ``modules`` (sys.modules) that are JAX or the JAX
    package, compared whole: ``pose2room_tpu_torch`` is not
    ``pose2room_tpu``."""
    tops = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def metrics(ctx, entries):
    """{name: {"value", "unit"}} of the entries whose reader finds a number."""
    out = {}
    for m in entries:
        value = spec.reader(ctx["root"], m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def line_of(ctx, trace, device):
    cell = ctx["cell"]
    ok, compared = checks.judge(ctx["numbers"], cell.limits)
    line = {"correct": bool(ok), "attempted": int(ctx["attempted"]), "failed": 0,
            "metrics": metrics(ctx, cell.per_layer if trace else cell.end_to_end)}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": ctx["memory_peak_bytes"]}
    if trace:
        dev["busy_s"] = ctx["trace"]["busy_s"]
        dev["window_s"] = ctx["trace"]["window_s"]
        line["breakdown"] = ctx["trace"]["breakdown"]
    line["device"] = dev
    line["checks"] = compared
    return line


def quarters(window):
    """Iterations that ended in each quarter of the window (a drift shows)."""
    q = window["seconds"] / 4
    return [sum(1 for e in window["ends"] if i * q <= e < (i + 1) * q) for i in range(4)]


def run_and_report(cell, seed, seconds, trace, device, t_start):
    """Run the cell and return its result line, or None (with the reason on
    standard error) when the import check fails.  The check comes last, once
    every metric reader and count file has been loaded and run."""
    ctx = cells.run(cell, seed, seconds, trace, device, t_start)
    if trace:
        missing = sorted({name for name in ctx["trace"]["kernels"] if spec.counted(ctx["root"], name) is None})
        print("device operations without a count file (left out of the rooflines): "
              + "; ".join(n[:80] for n in missing[:20]))
    line = line_of(ctx, trace, device)
    print("set-up seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in ctx["setup_phases"].items()), file=sys.stderr)
    print("iterations in each quarter of the window: " + " ".join(str(n) for n in quarters(ctx["window"])),
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)} (JAX or the JAX package)", file=sys.stderr)
        return None
    return line
