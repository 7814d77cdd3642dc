"""step_device_ms.train: device-busy milliseconds a train step (the union
of the device operations' intervals over the traced steps)."""

from benchmark.harness.readers import busy_ms_per_iteration


def read(ctx):
    return busy_ms_per_iteration(ctx)
