"""backbone_device_ms.generate: device milliseconds a traced generate batch
of the kernels launched inside the program's span ``p2r/model/backbone``
(the ST-GCN); read only where a device operation ran."""

from benchmark.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "p2r/model/backbone", "device_s")
