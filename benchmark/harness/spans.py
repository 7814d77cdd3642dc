"""The program's own spans in a traced window.

The program marks its layers with spans named ``p2r/<layer>/<part>``
(``pose2room_tpu_torch/utils/profiling.py:SPANS``), recorded only while a
profiler records, so they sit on the profiler's clock beside the host
operations and the device kernels they enclose.

* ``reduce_spans(spans, window)``: for each span name, over the spans
  (name, start_us, end_us, device_us) that overlap the window (start_us,
  end_us), {"count", "host_s" (clipped to the window), "device_s"};
* ``program(prof)``: ``reduce_spans`` of the ``p2r/`` host events of a
  finished profiler over its ``bench/window`` span.  An event's device
  time is its ``device_time_total``: the kernels that the launches inside
  it started, its children's included.  The profiler credits a launch to
  the innermost operator open on the launching thread; the program records
  its spans as operators, so the kernels it launches through ctypes count
  for the span around them.  The backward's kernels, launched on the
  autograd engine's own thread, count for no span of the main thread.

``cells.trace_window`` keeps ``program(prof)`` under the traced window's
``program`` key, which a metric of a span reads (``readers.span_ms``).
"""

import collections

from benchmark.harness.trace import PROGRAM_PREFIX, WINDOW_SPAN


def reduce_spans(spans, window):
    w0, w1 = window
    out = collections.defaultdict(lambda: {"count": 0, "host_s": 0.0, "device_s": 0.0})
    for name, s, e, dev_us in spans:
        if e <= w0 or s >= w1:
            continue
        r = out[name]
        r["count"] += 1
        r["host_s"] += (min(e, w1) - max(s, w0)) * 1e-6
        r["device_s"] += dev_us * 1e-6
    return dict(out)


def program(prof):
    from torch.autograd import DeviceType

    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    window = next((e.time_range.start, e.time_range.end) for e in host if e.name == WINDOW_SPAN)
    return reduce_spans([(e.name, e.time_range.start, e.time_range.end, e.device_time_total)
                         for e in host if e.name.startswith(PROGRAM_PREFIX)], window)
