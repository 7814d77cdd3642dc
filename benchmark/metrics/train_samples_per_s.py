"""train_samples_per_s: every sample the window trained on, over the
window's seconds (host clock, from its start to the synchronise after its
last step)."""

from benchmark.harness.readers import rate


def read(ctx):
    return rate(ctx)
