"""Tensor parallelism: the placement plan, the weight bridge and the two
column-parallel operators.

Port of JAX ``shard_params`` (pose2room_tpu/parallel/mesh.py:41-66) on the
grid of ``parallel.mesh.make_grid``.  JAX places a leaf of the train state
on the ``model`` axis, split on its last (output) dim, when it has 2 or more
dims, that dim divides tp and it holds at least 16384 elements; every other
leaf is replicated.  A flax ``kernel (in, out)`` is the port's ``weight
(out, in)`` (``convert.state_dict_from_flax``), so a planned weight splits
its dim 0 into tp contiguous blocks and rank r keeps block r % tp.  At the
port's widths the plan is 22 ``nn.Linear`` weights: the six ``gcn.conv``,
``conv_joint``, ``conv_input.{0,1}``, ``mlp_module.{0,2}``, the eight
``conv_*.{0,1}`` and the three ``gmm_*.backbone``.  AdamW's moments of a
planned weight are shards too, as JAX shards ``mu`` / ``nu``.

Compute (Megatron's column-parallel layer): a sharded ``nn.Linear`` gives
this rank's block of the output columns from the whole input, with its
block of the (replicated) bias, as one process computes those columns;
``copy_in`` (identity forward, all-reduce of the gradient over the model
group backward) takes the input and the bias in, ``gather_out``
(all-gather forward, this rank's block of the gradient backward) the
output out, and everything downstream of the gather is replicated within
the model group (``models.layers.linear``, ``column_parallel_dense``).
The ``gcn.conv`` weights are folded into the graph matrix before the
kernels see them, so the folds take the whole weight through ``gather_out``
on dim 0 (``full_weight``), and the kernels' operands stay as they are.

Gradients (``reduce_gradients``): a shard's gradient is this model group's
share of the global loss's, summed over the data group; a replicated
parameter's is whole on every rank of a model group, so it is summed over
the world and divided by tp, which leaves the same bits on every rank.
"""

import math

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from pose2room_tpu_torch.parallel.collectives import allgather_object, current_grid

# JAX shard_params' min_size: leaves below it are replicated
MIN_SIZE = 1 << 14


def out_dim(key, shape):
    """The size of the last dim of the flax leaf the port's tensor ``key``
    comes from: a kernel's output dim is dim 0 of a ``weight`` with 2 or
    more dims; every other leaf keeps its layout."""
    return shape[0] if key.endswith(".weight") and len(shape) >= 2 else shape[-1]


def tensor_plan(shapes, tp, min_size=MIN_SIZE):
    """The keys of ``shapes`` ({key: shape}, a state_dict's order) that JAX
    ``shard_params`` places on the model axis, in that order."""
    if tp <= 1:
        return []
    return [key for key, shape in shapes.items()
            if len(shape) >= 2 and out_dim(key, shape) % tp == 0 and math.prod(shape) >= min_size]


def model_plan(model, tp):
    """``tensor_plan`` of an unsharded model's parameters."""
    return tensor_plan({k: p.shape for k, p in model.named_parameters()}, tp)


def shard_state_dict(full_sd, plan, index, tp):
    """A tensor-parallel rank's state_dict from a whole one (a flax tree
    through ``convert.state_dict_from_flax``, a reference or a port
    checkpoint): block ``index`` of each planned tensor's dim 0, the rest
    as it is."""
    return {k: v.chunk(tp, dim=0)[index].clone() if k in plan else v for k, v in full_sd.items()}


def _all_gather(t, dim, group, tp):
    parts = [torch.empty_like(t) for _ in range(tp)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_state_dict(sd, plan, grid=None):
    """The whole state_dict from a rank's: each planned tensor gathered
    over the model group on dim 0 (a collective of the group, keys in
    ``sd``'s order)."""
    grid = grid or current_grid()
    if grid is None or not plan:
        return sd
    return {k: _all_gather(v, 0, grid.model_group, grid.tp) if k in plan else v for k, v in sd.items()}


class _CopyIn(torch.autograd.Function):
    """Identity forward; the input gradient summed over the model group
    backward (each rank's output block reaches the input)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=current_grid().model_group)
        return grad


class _GatherOut(torch.autograd.Function):
    """The model group's blocks concatenated on ``dim`` in rank order;
    backward: this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, t, dim):
        grid = current_grid()
        ctx.dim, ctx.index, ctx.tp = dim, grid.model_index, grid.tp
        return _all_gather(t, dim, grid.model_group, grid.tp)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.tp, dim=ctx.dim)[ctx.index].contiguous(), None


def copy_in(x):
    return _CopyIn.apply(x)


def gather_out(t, dim=-1):
    return _GatherOut.apply(t, dim)


def bias_block(bias):
    """This rank's block of a replicated bias (None for None), through
    ``copy_in``: its gradient is whole on every rank of the model group."""
    if bias is None:
        return None
    grid = current_grid()
    return copy_in(bias).chunk(grid.tp, dim=0)[grid.model_index]


def is_sharded(module):
    """True for an ``nn.Linear`` whose weight ``shard_module_`` split."""
    return getattr(module, "tp_sharded", False)


def full_weight(lin):
    """``lin.weight`` whole: gathered over the model group, differentiably,
    when it is a shard."""
    return gather_out(lin.weight, 0) if is_sharded(lin) else lin.weight


def sharded_keys(model):
    """The state_dict keys of the model's sharded weights, in its order."""
    return [f"{name}.weight" for name, mod in model.named_modules() if is_sharded(mod)]


@torch.no_grad()
def shard_module_(model, optimizer=None, grid=None):
    """Keep this rank's block of each planned weight of a whole ``model``,
    in place (the Parameters stay, so ``optimizer``'s groups hold them), and
    of its AdamW moments in ``optimizer``'s state; mark the layers.  Returns
    the plan.  Load whole checkpoints first, as JAX runners/common.py:89-95
    shards after ``resume`` / ``finetune``."""
    grid = grid or current_grid()
    plan = model_plan(model, grid.tp)
    for key in plan:
        lin = model.get_submodule(key.rsplit(".", 1)[0])
        if not isinstance(lin, nn.Linear) or not key.endswith(".weight"):
            raise NotImplementedError(f"{key}: only nn.Linear weights have a column-parallel compute")
        p = lin.weight
        full_shape = p.shape
        p.data = p.data.chunk(grid.tp, dim=0)[grid.model_index].clone()
        state = optimizer.state.get(p, {}) if optimizer is not None else {}
        for name, v in state.items():
            if torch.is_tensor(v) and v.shape == full_shape:
                state[name] = v.chunk(grid.tp, dim=0)[grid.model_index].clone()
        lin.tp_sharded = True
    return plan


def full_state_dict(model):
    """``model.state_dict()`` with its shards gathered: what one process
    holds (a collective of the model group under a grid)."""
    return gather_state_dict(model.state_dict(), sharded_keys(model))


def full_optimizer_state_dict(model, optimizer):
    """``optimizer.state_dict()`` with the moments of the sharded weights
    gathered: what one process's optimizer holds."""
    sd = optimizer.state_dict()
    grid = current_grid()
    sharded = {id(model.get_parameter(k)) for k in sharded_keys(model)}
    if grid is None or not sharded:
        return sd
    params = [p for group in optimizer.param_groups for p in group["params"]]
    state = dict(sd["state"])
    for i, p in enumerate(params):
        if id(p) in sharded and i in state:
            state[i] = {k: _all_gather(v, 0, grid.model_group, grid.tp) if torch.is_tensor(v) and v.dim() else v
                        for k, v in state[i].items()}
    return {**sd, "state": state}


def _split(model):
    sharded = {id(model.get_parameter(k)) for k in sharded_keys(model)}
    params = list(model.parameters())
    return [p for p in params if id(p) in sharded], [p for p in params if id(p) not in sharded]


def _sum_grads_(params, group, divisor=1):
    if not params:
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if divisor != 1:
        flat.div_(divisor)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def reduce_gradients(model):
    """After the backward under a grid: each shard's gradient summed over
    the data group, each replicated parameter's over the world and divided
    by tp (every rank of a model group holds it whole), so every rank ends
    with the same bits of each replicated gradient."""
    grid = current_grid()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    sharded, replicated = _split(model)
    _sum_grads_(sharded, grid.data_group)
    _sum_grads_(replicated, None, grid.tp)


@torch.no_grad()
def grad_norm(model):
    """The global gradient norm under a grid (optax.global_norm of one
    process): each shard's squares summed over the model group, counted
    once, beside the replicated parameters'."""
    grid = current_grid()
    sharded, replicated = _split(model)
    sq_rep = sum((p.grad * p.grad).sum() for p in replicated)
    sq_sh = torch.stack([(p.grad * p.grad).sum() for p in sharded]).sum()
    dist.all_reduce(sq_sh, group=grid.model_group)
    return torch.sqrt(sq_rep + sq_sh)


def gather_batch(batch):
    """A model group's batch from its ranks' loaded ones (collated numpy
    dicts): arrays concatenated and lists joined in rank order, as JAX
    ``make_array_from_process_local_data`` lays out the processes' rows.
    The batch itself without a grid."""
    grid = current_grid()
    if grid is None:
        return batch
    parts = allgather_object(batch, group=grid.model_group)
    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            out[k] = [x for part in parts for x in part[k]]
        elif isinstance(v, np.ndarray) and v.shape:
            out[k] = np.concatenate([part[k] for part in parts])
        else:
            out[k] = v
    return out


def state_bytes(model, optimizer):
    """Bytes this rank holds of parameters and their AdamW moments."""
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    for state in optimizer.state.values():
        n += sum(v.numel() * v.element_size() for k, v in state.items() if k in ("exp_avg", "exp_avg_sq"))
    return n
