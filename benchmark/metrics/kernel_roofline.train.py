"""kernel_roofline.train: the hand-written kernels' share of their roofline:
over the traced kernels that have a count file (benchmark/counts),
launches x bound over their device time."""

from benchmark.harness.readers import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx)
