"""mfu.train: the window's train steps' operations (forward and backward,
benchmark/harness/work.py) over its seconds, as a share of the TF32
tensor-core peak."""

from benchmark.harness.readers import mfu_pct
from benchmark.harness.work import train_flops


def read(ctx):
    return mfu_pct(ctx, train_flops)
