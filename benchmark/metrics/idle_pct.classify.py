"""idle_pct.classify: share of the traced window in which no device
operation ran."""

from benchmark.harness.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
