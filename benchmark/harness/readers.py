"""Arithmetic the metric readers share (benchmark/metrics/*.py).

``ctx`` is what ``cells.run`` returns: the untraced window's items and
seconds, the traced window's reduction (None without --trace 1; the
program's spans under its ``program``), the host spans and counters, the
cell's shapes.  A reader that finds nothing to read returns
None, and the metric is left out of the line."""

from benchmark.harness import spec, work


def traced(ctx):
    """The traced window's reduction when a device operation ran in it."""
    t = ctx["trace"]
    return t if t is not None and t["busy_s"] > 0 else None


def span_ms(ctx, name, key="host_s"):
    """Milliseconds a traced iteration spent in the program's span ``name``
    (harness/spans.py): its ``host_s`` on the host's clock, or the
    ``device_s`` of the kernels launched inside it, read only where a
    device operation ran; None where the span is not in the window."""
    t = traced(ctx) if key == "device_s" else ctx["trace"]
    r = None if t is None else t["program"].get(name)
    return None if r is None else 1e3 * r[key] / t["iterations"]


def rate(ctx):
    w = ctx["window"]
    return w["items"] / w["seconds"] if w["items"] else None


def idle_pct(ctx):
    t = traced(ctx)
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def busy_ms_per_iteration(ctx):
    t = traced(ctx)
    return None if t is None else 1e3 * t["busy_s"] / t["iterations"]


def mfu_pct(ctx, flops_per_item):
    """Operations of the window's items over its seconds, as a share of
    the TF32 tensor-core peak (the fastest the card takes f32 operands);
    read in a run whose traced window ran on a device."""
    r = rate(ctx)
    if r is None or traced(ctx) is None or ctx["cell"].config["model"]["compute_dtype"] != "float32":
        return None
    return 100.0 * r * flops_per_item(ctx["shape"]) / work.PEAK_TF32_FLOPS


def kernel_roofline_pct(ctx):
    """Sum over the traced device kernels that have a count file of
    launches x bound, over their device time."""
    t = traced(ctx)
    if t is None:
        return None
    bound = seconds = 0.0
    for name, (launches, secs) in t["kernels"].items():
        hit = spec.counted(ctx["root"], name)
        if hit is None:
            continue
        c = hit[1](ctx["shape"])
        bound += launches * work.bound_s(c["flops"], c["bytes"], c["rate"])
        seconds += secs
    return 100.0 * bound / seconds if seconds > 0 else None
