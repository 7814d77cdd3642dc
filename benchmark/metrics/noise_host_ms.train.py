"""noise_host_ms.train: host milliseconds a traced train step spent in the
program's span ``p2r/model/noise`` (``P2RNet.mdn_eps``: the MDN noise drawn
on the host and uploaded), on the profiler's clock."""

from benchmark.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "p2r/model/noise")
