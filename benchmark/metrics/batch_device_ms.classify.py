"""batch_device_ms.classify: device-busy milliseconds a traced batch
(the union of the device's operations over the traced window, over its
batches)."""

from benchmark.harness.readers import busy_ms_per_iteration


def read(ctx):
    return busy_ms_per_iteration(ctx)
