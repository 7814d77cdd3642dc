"""clips_per_s: every clip whose outputs reached the host in the window,
over the window's seconds (host clock)."""

from benchmark.harness.readers import rate


def read(ctx):
    return rate(ctx)
