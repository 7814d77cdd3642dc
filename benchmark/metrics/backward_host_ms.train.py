"""backward_host_ms.train: host milliseconds a traced train step spent in
the program's span ``p2r/train/backward`` (zero_grad and the backward, the
autograd engine's dispatch included), on the profiler's clock."""

from benchmark.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "p2r/train/backward")
