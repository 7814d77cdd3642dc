"""allreduce_device_ms.train: device milliseconds a traced step of the
kernels launched inside the program's span ``p2r/train/allreduce`` (the
DDP hook's all-reduce of each gradient bucket, parallel/mesh.py): the
NCCL kernels of rank 0; 0 where the collective runs on the host (gloo)."""

from benchmark.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "p2r/train/allreduce", "device_s")
