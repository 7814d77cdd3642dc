"""The traced window: torch.profiler over a fixed number of the window's
own iterations, reduced to what the per-layer metrics read.

* ``busy_s``: the union of the device operations' intervals (kernels,
  copies, fills) inside the window, so that operations overlapping on two
  streams count once;
* ``window_s``: the window's length, from the harness's span around the
  traced loop (which ends in a synchronise);
* ``kernels``: {name: [launches, seconds]} by the device's own names;
* ``breakdown``: the device operations that took most time, and the idle
  gaps between device operations summed by what the main thread (the one
  that runs the window) was doing at their midpoint: the innermost harness
  span, the innermost program span (``p2r/...``) where one is open, and
  the host operation, as ``"<harness span>: <program span>: <operation>"``.
  A loader's or another thread's events name no gap.
"""

import bisect
import collections

WINDOW_SPAN = "bench/window"
SPAN_PREFIX = "bench/"
PROGRAM_PREFIX = "p2r/"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(intervals, t, depth=None):
    """The name of the latest-started of ``intervals`` (start, end, name),
    sorted by start, that is open at ``t``, looking back ``depth`` of them
    (all where None); None where none is."""
    i = bisect.bisect_right(intervals, t, key=lambda iv: iv[0])
    lo = 0 if depth is None else max(0, i - depth)
    return next((n for s, e, n in reversed(intervals[lo:i]) if e >= t), None)


def reduce_events(events, top=10):
    """``events``: (name, is_device, start_us, end_us, thread) of the traced
    window.  Returns the reduction described above; ``busy_s`` 0 when no
    operation ran on a device."""
    window = [(s, e, th) for n, dev, s, e, th in events if not dev and n == WINDOW_SPAN]
    if not window:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    w0, w1, main = window[0]
    device = [(n, max(s, w0), min(e, w1)) for n, dev, s, e, _ in events if dev and e > w0 and s < w1]
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for n, s, e in device:
        kernels[n][0] += 1
        kernels[n][1] += (e - s) * 1e-6
    busy = _merge([(s, e) for _, s, e in device])
    busy_s = sum(e - s for s, e in busy) * 1e-6

    host = [(s, e, n) for n, dev, s, e, th in events if not dev and th == main and n != WINDOW_SPAN]
    spans = sorted((s, e, n[len(SPAN_PREFIX):]) for s, e, n in host if n.startswith(SPAN_PREFIX))
    program = sorted(h for h in host if h[2].startswith(PROGRAM_PREFIX))
    ops = sorted(h for h in host if not h[2].startswith((SPAN_PREFIX, PROGRAM_PREFIX)))
    gaps = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        span = _innermost(spans, mid) or "none"
        layer = _innermost(program, mid)
        op = _innermost(ops, mid, depth=256) or "none"
        gaps[": ".join([span] + ([layer] if layer else []) + [op])] += (e - s) * 1e-6
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) * 1e-6,
        "kernels": {n: v for n, v in kernels.items()},
        "breakdown": {
            "device_ops": [[n[:160], v[1]] for n, v in ranked[:top]],
            "idle_gaps": [[n[:160], v] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
        },
    }


def profiler_events(prof):
    """(name, is_device, start_us, end_us, thread) of every event of a finished
    ``torch.profiler.profile``.  The device-side mirrors of the host's
    annotations (``record_function`` spans, the optimizer's step) are not
    device operations and are left out."""
    from torch.autograd import DeviceType

    events = prof.events()
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    out = []
    for e in events:
        device = e.device_type != DeviceType.CPU
        if device and (getattr(e, "is_user_annotation", False) or e.name in host):
            continue
        out.append((e.name, device, e.time_range.start, e.time_range.end, e.thread))
    return out
