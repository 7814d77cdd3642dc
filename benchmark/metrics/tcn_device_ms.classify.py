"""tcn_device_ms.classify: device milliseconds a traced batch of the
kernels launched inside the program's span ``p2r/agcn/tcn``: the ten
units' 9-tap temporal convolutions, their BN, the residuals and the ReLU."""

from benchmark.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "p2r/agcn/tcn", "device_s")
