"""batch_device_ms.generate: device-busy milliseconds a generate batch
(the union of the device operations' intervals over the traced batches)."""

from benchmark.harness.readers import busy_ms_per_iteration


def read(ctx):
    return busy_ms_per_iteration(ctx)
