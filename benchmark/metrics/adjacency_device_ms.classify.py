"""adjacency_device_ms.classify: device milliseconds a traced batch of the
kernels launched inside the program's span ``p2r/agcn/adjacency``: theta /
phi, the scores, the softmax and + A + B of the ten units (a part of
``gcn_device_ms.classify``)."""

from benchmark.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "p2r/agcn/adjacency", "device_s")
