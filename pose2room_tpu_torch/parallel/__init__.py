"""Data and tensor parallelism: one process per card over ``torch.distributed``.

Port of pose2room_tpu/parallel.  ``collectives`` holds the host-object
gather and the sums across ranks, ``mesh`` the process group set-up from
torchrun's environment, the DDP wrapper and the (data, model) grid of
``device.model_parallel`` (JAX ``make_mesh``), ``tensor`` that mode's
placement plan (JAX ``shard_params``: the >= 16 Ki-element kernels split on
their output dim over the model group), its weight bridge, its two
column-parallel operators and its gradient reduction.  Outside a process
group every function is the single-process identity, and with
``model_parallel`` 1 no grid is made.
"""

from pose2room_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    all_reduce_sum_,
    allgather_object,
    barrier,
    batch_shard,
    broadcast_object,
    data_count,
    data_index,
    draw_rows,
    fold_rank,
    in_group,
    model_parallel,
    process_count,
    process_index,
)
from pose2room_tpu_torch.parallel.mesh import (
    grid_layout,
    init_distributed,
    make_grid,
    model_parallel_of,
    pick_backend,
    shutdown,
    unwrap,
    wrap_model,
)
from pose2room_tpu_torch.parallel.tensor import gather_batch, gather_state_dict, shard_state_dict, tensor_plan

__all__ = [
    "all_reduce_sum", "all_reduce_sum_", "allgather_object", "barrier", "batch_shard", "broadcast_object",
    "data_count", "data_index", "draw_rows", "fold_rank", "in_group", "model_parallel", "process_count",
    "process_index", "grid_layout", "init_distributed", "make_grid", "model_parallel_of", "pick_backend",
    "shutdown", "unwrap", "wrap_model", "gather_batch", "gather_state_dict", "shard_state_dict", "tensor_plan",
]
