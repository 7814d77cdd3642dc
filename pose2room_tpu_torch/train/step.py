"""Train and validation steps (port of pose2room_tpu/train/step.py).

A train step is the forward in ``.train()`` mode (live BatchNorm), the
detection loss, the backward, the global gradient norm (optax's
``global_norm``, taken before any clipping) and the AdamW update.  Losses
come back as device tensors; the engine reads them one step late, so the
host never waits for the card between steps.  Under a profiler the upload
and the step's parts are spans (``utils/profiling.py:SPANS``): ``train/h2d``,
and ``train/step`` around the forward, ``train/loss``, ``train/backward`` and
``train/optimizer``.

Data parallel (inside a process group, the model wrapped by
``parallel.wrap_model``): each rank's batch is its rows of the global batch
(``shard``), the loss normalisers and BatchNorm statistics are global, so
each rank's loss is its share of the global loss; DDP's hook SUMS the
ranks' gradients (not their mean), which makes the gradient that reaches
the global norm, the clipping and AdamW the global loss's gradient on every
rank.  The returned losses are the global values, summed over the ranks.

Tensor parallel (under ``parallel.make_grid``): the batch is the model
group's (``parallel.gather_batch``) and the sums above run over the data
group; after the backward ``parallel.tensor.reduce_gradients`` sums the
shards' gradients over the data group and the replicated ones over the
world (divided by tp), and the global norm counts each shard once.
"""

import numpy as np
import torch

from pose2room_tpu_torch.models.loss import detection_loss
from pose2room_tpu_torch.parallel.collectives import all_reduce_sum_, current_grid, in_group
from pose2room_tpu_torch.parallel.mesh import unwrap
from pose2room_tpu_torch.parallel.tensor import grad_norm, reduce_gradients
from pose2room_tpu_torch.train.state import clip_by_global_norm, global_norm
from pose2room_tpu_torch.utils.profiling import annotate

GT_KEYS = (
    "center_label",
    "box_label_mask",
    "size",
    "heading",
    "sem_cls_label",
    "vote_label",
    "vote_label_mask",
)


def batch_to_device(batch, device, h2d_dtype=None):
    """The model input and GT arrays of a collated numpy batch as tensors on
    ``device``.

    ``h2d_dtype`` (``train.h2d_dtype``, e.g. 'float16'; JAX
    engine.device_prefetch): the float32 target arrays are cast to it on the
    host before the upload and back to float32 on the device, to cut the
    bytes moved.  ``input_joints`` is never cast: rounding the model input
    can flip FPS and ball-query selections."""
    cast_to = np.dtype(h2d_dtype) if h2d_dtype else None
    out = {}
    with annotate("train/h2d"):
        for k in ("input_joints", *GT_KEYS):
            x = batch[k]
            if cast_to is not None and k != "input_joints" and x.dtype == np.float32:
                out[k] = torch.from_numpy(x.astype(cast_to)).to(device).float()
            else:
                out[k] = torch.from_numpy(x).to(device)
    return out


def _global_losses(losses):
    """Each rank's shares summed over the data group, in one all-reduce
    (the losses themselves outside a process group)."""
    losses = {k: v.detach() for k, v in losses.items()}
    if not in_group():
        return losses
    return dict(zip(losses, all_reduce_sum_(torch.stack(list(losses.values()))).unbind(0)))


def train_step(model, optimizer, batch, *, eps=None, generator=None, clip_norm=-1.0,
               origin_joint_id=0, shard=(0, 1)):
    """One optimisation step on a ``batch_to_device`` batch.

    ``model``: the P2RNet, or its ``parallel.wrap_model`` wrapper inside a
    process group.  ``eps`` / ``generator``: the MDN noise, or the CPU
    generator it is drawn from; ``shard``: ``parallel.batch_shard()`` of a
    data- or tensor-parallel step (see ``P2RNet.forward``).  Returns (losses,
    end_points): detached scalar tensors including ``grad_norm``, and the
    forward's outputs.  The gradients stay in each parameter's ``.grad``
    until the next step.  Every parameter gets its gradient, those of a
    frozen module (in no param group) too, and all count in the global norm
    and its clipping.
    """
    with annotate("train/step"):
        net = unwrap(model)
        net.train()
        end_points = model(batch["input_joints"], eps=eps, generator=generator, shard=shard)
        with annotate("train/loss"):
            losses = detection_loss(end_points, batch, origin_joint_id,
                                    reduce=all_reduce_sum_ if in_group() else None)
        with annotate("train/backward"):
            # the model's, not the optimizer's: a frozen module's .grad would
            # otherwise accumulate across steps and grow the global norm
            net.zero_grad(set_to_none=True)
            losses["total"].backward()  # through DDP: every rank holds the summed gradients
            if current_grid() is not None:
                reduce_gradients(net)
        with annotate("train/optimizer"):
            grads = [p.grad for p in net.parameters() if p.grad is not None]
            with torch.no_grad():
                norm = global_norm(grads) if current_grid() is None else grad_norm(net)
            if clip_norm > 0:
                clip_by_global_norm(grads, clip_norm, norm)
            optimizer.step()
            losses = _global_losses(losses)
            losses["grad_norm"] = norm
    return losses, end_points


@torch.no_grad()
def eval_step(model, batch, *, eps=None, generator=None, origin_joint_id=0, shard=(0, 1)):
    """Validation loss: the train forward in ``.eval()`` mode (running
    BatchNorm statistics, sampled MDN heads), no gradient; inside a process
    group over global normalisers and summed over the ranks, as
    ``train_step``.  ``model``: the P2RNet (not its DDP wrapper)."""
    model.eval()
    end_points = model(batch["input_joints"], eps=eps, generator=generator, shard=shard)
    return _global_losses(detection_loss(end_points, batch, origin_joint_id,
                                         reduce=all_reduce_sum_ if in_group() else None))
