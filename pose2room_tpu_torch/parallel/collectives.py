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
"""

import os

import torch
import torch.distributed as dist


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


def allgather_object(obj):
    """One picklable object per process, as a list in rank order on every
    process (``[obj]`` outside a group or in a world of one)."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj, src=0):
    """``obj`` of rank ``src`` on every process (``obj`` outside a group)."""
    if not in_group():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_reduce_sum_(t):
    """Sum ``t`` over the ranks, in place; returns ``t`` (unchanged outside
    a group).  No gradient flows through it."""
    if in_group():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum across ranks whose backward sums the output gradients across
    ranks: each rank's input reaches every rank's output."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_sum_(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_(grad.clone())


def all_reduce_sum(t):
    """The sum of ``t`` over the ranks as a new tensor, differentiable: the
    gradient of each rank's input is the sum of every rank's output
    gradient.  ``t`` itself outside a group."""
    return _AllReduceSum.apply(t) if in_group() else t


def barrier():
    if in_group():
        dist.barrier()


def fold_rank(seed):
    """A generator seed per process from a run's seed: ``seed`` itself on
    rank 0 (so one process draws as before), disjoint streams on the others
    (for seeds below 2**32), as the JAX package folds ``process_index`` into
    its keys."""
    return int(seed) + (process_index() << 32)
