"""Process group set-up and the DDP wrapper: one process per card.

The counterpart of pose2room_tpu/parallel/mesh.py and of the JAX runners'
``initiate_environment`` (runners/common.py:35-41).  Launch with torchrun:

    python -m torch.distributed.run --nproc_per_node N -m pose2room_tpu_torch \
        --config <yaml> --mode {train,test}

``init_distributed`` reads torchrun's ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
(without them it does nothing: one process, as before), makes card
``LOCAL_RANK`` the current device and joins the group: NCCL when each local
rank has a card of its own, gloo when ranks share a card (NCCL refuses two
ranks on one device) or run on the CPU.  Each process stands for one JAX
host: ``train.batch_size`` is its batch, and the global batch is
``process_count()`` times it.

``wrap_model`` is ``DistributedDataParallel`` with a summing gradient hook:
each rank's loss is its share of the global loss (its numerators over the
global normalisers, models/loss.py), so the gradient of the global loss is
the SUM of the ranks' gradients, which DDP's default hook would divide by
the world size.  ``broadcast_buffers`` is off: the BatchNorm statistics are
global (the train chain's column sums and the module path's moments are
summed across ranks), so every rank updates its running statistics to the
same values and no rank's copy needs to overwrite the others'.

``make_grid`` is the counterpart of JAX ``make_mesh(model_parallel=tp)``
(mesh.py:22-38): world rank r sits at (r // tp, r % tp) of
``np.arange(W).reshape(W // tp, tp)``, JAX's device grid.  A model group
is a row, tp ranks that hold one copy of the model between them (each the
``parallel.tensor`` shard of its column) and compute on the same rows; a
data group is a column, the ranks that hold the same shard.  Every rank
creates every group, rows first, in the same order.  ``make_grid(1)``
installs no grid, so the data-parallel path stays as it is.
"""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from pose2room_tpu_torch.parallel.collectives import current_grid, in_group, process_count, process_index, set_grid
from pose2room_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class Grid:
    """A (data, model) grid of world ranks and this rank's two groups."""

    layout: np.ndarray  # (W // tp, tp) world ranks
    rank: int
    model_group: object  # this rank's row
    data_group: object  # this rank's column

    @property
    def tp(self):
        return self.layout.shape[1]

    @property
    def model_index(self):
        """This rank's column: the shard it holds."""
        return self.rank % self.tp

    @property
    def model_ranks(self):
        """The world ranks of this rank's model group, in order."""
        return tuple(int(r) for r in self.layout[self.rank // self.tp])


def model_parallel_of(config):
    """``device.model_parallel`` of a config (1 when unset)."""
    return int((config.get("device", {}) or {}).get("model_parallel", 1) or 1)


def grid_layout(world, tp):
    """The world ranks as a (world // tp, tp) grid, JAX make_mesh's device
    layout; ValueError when tp does not divide the world."""
    if tp < 1 or world % tp:
        raise ValueError(f"device.model_parallel {tp} must divide the {world} processes "
                         f"(JAX make_mesh asserts n % model_parallel == 0; here {world} % {tp} != 0)")
    return np.arange(world).reshape(world // tp, tp)


def make_grid(tp):
    """Install the (data, model) grid of degree ``tp`` over the process
    group and return it; with ``tp`` 1, none (and None).  ValueError when
    tp does not divide the processes, one process with tp > 1 included:
    there is no fallback to tp = 1.  Idempotent for the same tp."""
    layout = grid_layout(process_count(), tp)
    if tp == 1:
        set_grid(None)
        return None
    grid = current_grid()
    if grid is not None and grid.tp == tp:
        return grid
    rank = process_index()
    rows = [dist.new_group([int(r) for r in row]) for row in layout]
    cols = [dist.new_group([int(r) for r in col]) for col in layout.T]
    grid = Grid(layout=layout, rank=rank, model_group=rows[rank // tp], data_group=cols[rank % tp])
    set_grid(grid)
    return grid


def pick_backend(cpu, n_cards, local_world_size):
    """'gloo' on the CPU or when the node's ranks outnumber its cards (they
    share one), else 'nccl'."""
    return "gloo" if cpu or local_world_size > n_cards else "nccl"


def init_distributed(device=None, timeout=None):
    """Join the process group torchrun describes; returns its backend, or
    None without a torchrun environment (a single process).  ``device``:
    the entry point's ``--device`` (``'cpu'`` runs every rank on the host;
    otherwise a card is required, and there is no fallback to the CPU).
    ``timeout`` (a ``datetime.timedelta``): how long the rendezvous and each
    collective may wait before they fail (torch's default when None).
    Idempotent: inside a group it returns the group's backend."""
    if in_group():
        return dist.get_backend()
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    cpu = device is not None and torch.device(device).type == "cpu"
    n_cards = 0 if cpu else torch.cuda.device_count()
    if not cpu and n_cards == 0:
        raise RuntimeError(f"rank {rank}: no CUDA device; pass --device cpu to run the ranks on the CPU")
    backend = pick_backend(cpu, n_cards, local_world)
    where = "cpu"
    if not cpu:
        torch.cuda.set_device(local_rank % n_cards)
        where = f"cuda:{local_rank % n_cards}"
    dist.init_process_group(backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                            rank=rank, world_size=world, **({} if timeout is None else {"timeout": timeout}))
    shared = " (ranks share a card)" if not cpu and backend == "gloo" else ""
    print(f"process group: rank {rank} of {world} on {where}, backend {backend}{shared}")
    return backend


def shutdown():
    """Leave the process group and its grid (a no-op outside one)."""
    set_grid(None)
    if in_group():
        dist.destroy_process_group()


def _sum_hook(process_group, bucket):
    """DDP comm hook: the bucket's gradients summed over the ranks (DDP's
    default allreduce hook, without its division by the world size).  The
    launch is the span ``train/allreduce``; on NCCL the collective's kernel
    counts for it.  DDP calls the hook on the autograd engine's thread."""
    with annotate("train/allreduce"):
        work = dist.all_reduce(bucket.buffer(), group=process_group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


def wrap_model(model):
    """``model`` in DDP with the summing hook inside a process group; the
    model itself outside one.  Every parameter takes part, those of a
    ``train.freeze`` module too: they get no update, but their gradients
    count in the global norm and its clipping (as the JAX chain clips before
    its multi_transform), so they must be the global ones.  Under a
    tensor-parallel grid the model itself: ``parallel.tensor.
    reduce_gradients`` sums its gradients after the backward."""
    if not in_group() or current_grid() is not None:
        return model
    device = next(model.parameters()).device
    ddp = DistributedDataParallel(model, device_ids=[device.index] if device.type == "cuda" else None,
                                  broadcast_buffers=False)
    ddp.register_comm_hook(None, _sum_hook)
    return ddp


def unwrap(model):
    """The module inside a DDP wrapper (the model itself otherwise)."""
    return model.module if isinstance(model, DistributedDataParallel) else model
