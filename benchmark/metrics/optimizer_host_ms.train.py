"""optimizer_host_ms.train: host milliseconds a traced train step spent in
the program's span ``p2r/train/optimizer`` (the global norm, clipping, the
optimizer's step), on the profiler's clock."""

from benchmark.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "p2r/train/optimizer")
