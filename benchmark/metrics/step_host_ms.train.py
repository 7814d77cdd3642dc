"""step_host_ms.train: host milliseconds a traced train step spent in the
program's span ``p2r/train/step`` (``train/step.py:train_step``: forward,
loss, backward and optimizer), on the profiler's clock."""

from benchmark.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "p2r/train/step")
