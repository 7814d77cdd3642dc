"""mfu.classify: the window's samples' operations (the layer equations of
2s-AGCN, counted by benchmark/kinds/classify.py) over its seconds, as a
share of the TF32 tensor-core peak: the whole call's share."""

from benchmark.harness import spec
from benchmark.harness.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, spec.kind(ctx["root"], "classify").sample_flops)
