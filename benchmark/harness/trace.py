"""The traced window: torch.profiler over a fixed number of the window's
own iterations, reduced to what the per-layer metrics read.

* ``busy_s``: the union of the device operations' intervals (kernels,
  copies, fills) inside the window, so that operations overlapping on two
  streams count once;
* ``window_s``: the window's length, from the harness's span around the
  traced loop (which ends in a synchronise);
* ``kernels``: {name: [launches, seconds]} by the device's own names;
* ``breakdown``: the device operations that took most time, and the idle
  gaps between device operations summed by what the host was doing at
  their midpoint (the innermost harness span and the host operation).
"""

import bisect
import collections

WINDOW_SPAN = "bench/window"
SPAN_PREFIX = "bench/"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events, top=10):
    """``events``: (name, is_device, start_us, end_us) of the traced window.
    Returns the reduction described above; ``busy_s`` 0 when no operation
    ran on a device."""
    window = [(s, e) for n, dev, s, e in events if not dev and n == WINDOW_SPAN]
    if not window:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    w0, w1 = window[0]
    device = [(n, max(s, w0), min(e, w1)) for n, dev, s, e in events if dev and e > w0 and s < w1]
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for n, s, e in device:
        kernels[n][0] += 1
        kernels[n][1] += (e - s) * 1e-6
    busy = _merge([(s, e) for _, s, e in device])
    busy_s = sum(e - s for s, e in busy) * 1e-6

    spans = sorted((s, e, n[len(SPAN_PREFIX):]) for n, dev, s, e in events
                   if not dev and n.startswith(SPAN_PREFIX) and n != WINDOW_SPAN)
    ops = sorted((s, e, n) for n, dev, s, e in events if not dev and not n.startswith(SPAN_PREFIX))
    starts = [o[0] for o in ops]
    gaps = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        span = next((n for hs, he, n in reversed(spans) if hs <= mid <= he), "none")
        # the latest-started host operation still running at the midpoint
        i = bisect.bisect_right(starts, mid)
        op = next((n for hs, he, n in reversed(ops[max(0, i - 256):i]) if he >= mid), "none")
        gaps[f"{span}: {op}"] += (e - s) * 1e-6
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
    """(name, is_device, start_us, end_us) of every event of a finished
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
        out.append((e.name, device, e.time_range.start, e.time_range.end))
    return out
