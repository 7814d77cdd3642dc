"""gcn_device_ms.classify: device milliseconds a traced batch of the
kernels launched inside the program's span ``p2r/agcn/gcn``: the ten
units' adaptive graph convolutions, theta / phi to their ReLU (the
adjacency's kernels included)."""

from benchmark.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "p2r/agcn/gcn", "device_s")
