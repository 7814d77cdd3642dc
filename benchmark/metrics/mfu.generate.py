"""mfu.generate: the window's generate operations (the forward,
benchmark/harness/work.py) over its seconds, as a share of the TF32
tensor-core peak."""

from benchmark.harness.readers import mfu_pct
from benchmark.harness.work import forward_flops


def read(ctx):
    return mfu_pct(ctx, forward_flops)
