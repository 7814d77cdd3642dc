"""Data parallelism: one process per card over ``torch.distributed``.

Port of pose2room_tpu/parallel (its data-parallel half; the tensor-parallel
``device.model_parallel`` is not ported and raises).  ``collectives`` holds
the host-object gather and the sums across ranks, ``mesh`` the process group
set-up from torchrun's environment and the DDP wrapper.  Outside a process
group every function is the single-process identity.
"""

from pose2room_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    all_reduce_sum_,
    allgather_object,
    barrier,
    broadcast_object,
    fold_rank,
    in_group,
    process_count,
    process_index,
)
from pose2room_tpu_torch.parallel.mesh import init_distributed, pick_backend, shutdown, unwrap, wrap_model

__all__ = [
    "all_reduce_sum", "all_reduce_sum_", "allgather_object", "barrier", "broadcast_object", "fold_rank",
    "in_group", "process_count", "process_index", "init_distributed", "pick_backend", "shutdown", "unwrap",
    "wrap_model",
]
