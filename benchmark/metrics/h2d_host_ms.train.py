"""h2d_host_ms.train: host milliseconds a traced train step spent in the
program's span ``p2r/train/h2d`` (``train/step.py:batch_to_device``, the
batch's upload), on the profiler's clock."""

from benchmark.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "p2r/train/h2d")
