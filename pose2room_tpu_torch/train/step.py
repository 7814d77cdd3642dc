"""Train and validation steps (port of pose2room_tpu/train/step.py).

A train step is the forward in ``.train()`` mode (live BatchNorm), the
detection loss, the backward, the global gradient norm (optax's
``global_norm``, taken before any clipping) and the AdamW update.  Losses
come back as device tensors; the engine reads them one step late, so the
host never waits for the card between steps.
"""

import numpy as np
import torch

from pose2room_tpu_torch.models.loss import detection_loss
from pose2room_tpu_torch.train.state import clip_by_global_norm, global_norm

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
    for k in ("input_joints", *GT_KEYS):
        x = batch[k]
        if cast_to is not None and k != "input_joints" and x.dtype == np.float32:
            out[k] = torch.from_numpy(x.astype(cast_to)).to(device).float()
        else:
            out[k] = torch.from_numpy(x).to(device)
    return out


def train_step(model, optimizer, batch, *, eps=None, generator=None, clip_norm=-1.0,
               origin_joint_id=0):
    """One optimisation step on a ``batch_to_device`` batch.

    ``eps`` / ``generator``: the MDN noise, or the CPU generator it is drawn
    from (see ``P2RNet.forward``).  Returns (losses, end_points): detached
    scalar tensors including ``grad_norm``, and the forward's outputs.  The
    gradients stay in each parameter's ``.grad`` until the next step.  Every
    parameter gets its gradient, those of a frozen module (in no param
    group) too, and all count in the global norm and its clipping.
    """
    model.train()
    end_points = model(batch["input_joints"], eps=eps, generator=generator)
    losses = detection_loss(end_points, batch, origin_joint_id)
    # the model's, not the optimizer's: a frozen module's .grad would
    # otherwise accumulate across steps and grow the global norm
    model.zero_grad(set_to_none=True)
    losses["total"].backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    with torch.no_grad():
        norm = global_norm(grads)
    if clip_norm > 0:
        clip_by_global_norm(grads, clip_norm, norm)
    optimizer.step()
    losses["grad_norm"] = norm
    return {k: v.detach() for k, v in losses.items()}, end_points


@torch.no_grad()
def eval_step(model, batch, *, eps=None, generator=None, origin_joint_id=0):
    """Validation loss: the train forward in ``.eval()`` mode (running
    BatchNorm statistics, sampled MDN heads), no gradient."""
    model.eval()
    end_points = model(batch["input_joints"], eps=eps, generator=generator)
    return detection_loss(end_points, batch, origin_joint_id)
