"""Collectives across the processes of a data-parallel run.

Port of pose2room_tpu/parallel/collectives.py on ``torch.distributed``:
``allgather_object`` moves picklable host state (the AP calculators' scans,
the loss recorders' sums), ``all_reduce_sum_`` sums tensors in place (the
train chain's column sums, the loss normalisers), ``all_reduce_sum`` is its
differentiable twin (the module path's BatchNorm moments: its backward sums
the gradients across ranks).  Outside an initialised process group each is
the one-process identity: ``[obj]``, a no-op, ``process_index() == 0`` and
``process_count() == 1``.  Inside a group of one they still run, so a world
of one exercises the same collectives.

Under a tensor-parallel grid (``parallel.mesh.make_grid``, ``device.
model_parallel`` > 1) the ranks of one model group hold the same rows, so
these three run over this rank's DATA group (the ranks that hold different
rows; ``data_count`` of them) and ``fold_rank`` folds the data index; with
no grid the data group is the world and each is as it was.
"""

import os

import torch
import torch.distributed as dist

# the installed (data, model) grid of a tensor-parallel run (parallel.mesh.Grid), or None
_GRID = None


def set_grid(grid):
    """Install ``grid`` (None: no grid, the data group is the world)."""
    global _GRID
    _GRID = grid


def current_grid():
    """The installed tensor-parallel grid, or None."""
    return _GRID


def model_parallel():
    """The tensor-parallel degree: the size of a model group (1 without a grid)."""
    return _GRID.tp if _GRID is not None else 1


def data_group():
    """The process group of this rank's column of the grid (None, the
    world's default group, without a grid)."""
    return _GRID.data_group if _GRID is not None else None


def data_index():
    """This rank's row of the grid: the index of its model group among the
    groups that hold different rows (the rank itself without a grid)."""
    return process_index() // model_parallel()


def data_count():
    """The number of model groups: ranks that hold different rows of a
    global batch (the world size without a grid)."""
    return process_count() // model_parallel()


def in_group():
    """True inside an initialised ``torch.distributed`` process group."""
    return dist.is_available() and dist.is_initialized()


def require_joined():
    """RuntimeError when torchrun's environment (``RANK``, ``WORLD_SIZE``)
    describes a process group this process has not joined: state built
    before ``parallel.init_distributed`` would take every rank for rank 0."""
    if not in_group() and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        raise RuntimeError(f"rank {os.environ['RANK']} of {os.environ['WORLD_SIZE']} has not joined the process "
                           "group: call parallel.init_distributed before building the CONFIG")


def process_index():
    return dist.get_rank() if in_group() else 0


def process_count():
    return dist.get_world_size() if in_group() else 1


def allgather_object(obj, group=None):
    """One picklable object per process of ``group`` (default: this rank's
    data group, the world without a grid), as a list in rank order on every
    process (``[obj]`` outside a group or in a group of one)."""
    if not in_group():
        return [obj]
    group = group if group is not None else data_group()
    n = dist.get_world_size(group)
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj, src=0):
    """``obj`` of rank ``src`` on every process (``obj`` outside a group)."""
    if not in_group():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_reduce_sum_(t):
    """Sum ``t`` over the ranks of the data group, in place; returns ``t``
    (unchanged outside a group).  No gradient flows through it."""
    if in_group():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=data_group())
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum across the data group whose backward sums the output gradients
    across it: each rank's input reaches every rank's output."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_sum_(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_(grad.clone())


def all_reduce_sum(t):
    """The sum of ``t`` over the data group as a new tensor,
    differentiable: the gradient of each rank's input is the sum of every
    rank's output gradient.  ``t`` itself outside a group."""
    return _AllReduceSum.apply(t) if in_group() else t


def barrier():
    if in_group():
        dist.barrier()


def fold_rank(seed):
    """A generator seed per model group from a run's seed: ``seed`` itself
    on rank 0 (so one process draws as before), disjoint streams on the
    others (for seeds below 2**32), as the JAX package folds
    ``process_index`` into its keys.  The ranks of a model group compute on
    the same rows, so they share the data index and draw alike."""
    return int(seed) + (data_index() << 32)


def batch_shard():
    """(index, count) of this rank's rows of a global batch, for
    ``draw_rows``: (rank, world) with rows rank::world; under a grid the
    model group's ranks as a tuple, whose rows it holds in that order."""
    if _GRID is None:
        return process_index(), process_count()
    return _GRID.model_ranks, process_count()


def draw_rows(draw, batch_size, shard=(0, 1)):
    """This batch's rows of a draw for the global batch: ``draw(n)`` draws
    n rows; ``shard`` (index, count) says this ``batch_size``-row batch is
    rows index, index + count, ... of a global batch ``count`` times one
    rank's, or, with a tuple of indices (a model group's ranks, see
    ``batch_shard``), the rows of each in turn."""
    index, count = shard
    if isinstance(index, int):
        return draw(batch_size * count)[index::count]
    full = draw(batch_size // len(index) * count)
    return torch.cat([full[i::count] for i in index])
