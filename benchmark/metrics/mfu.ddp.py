"""mfu.ddp: the window's train steps' operations over all ranks (forward
and backward, benchmark/harness/work.py; the items are the global
samples) over its seconds, as a share of ``world`` cards' TF32
tensor-core peak: one rank's share of its own card."""

from benchmark.harness.readers import mfu_pct
from benchmark.harness.work import train_flops


def read(ctx):
    pct = mfu_pct(ctx, train_flops)
    return None if pct is None else pct / ctx["cell"].traffic["world"]
