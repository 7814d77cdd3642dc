"""Train and validation steps (port of pose2room_tpu/train/step.py).

A train step is the forward in ``.train()`` mode (live BatchNorm), the
detection loss, the backward, the global gradient norm (optax's
``global_norm``, taken before any clipping) and the AdamW update.  Losses
come back as device tensors; the engine reads them one step late, so the
host never waits for the card between steps.
"""

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


def batch_to_device(batch, device):
    """The model input and GT arrays of a collated numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(batch[k]).to(device) for k in ("input_joints", *GT_KEYS)}


def train_step(model, optimizer, batch, *, eps=None, generator=None, clip_norm=-1.0,
               origin_joint_id=0):
    """One optimisation step on a ``batch_to_device`` batch.

    ``eps`` / ``generator``: the MDN noise, or the CPU generator it is drawn
    from (see ``P2RNet.forward``).  Returns (losses, end_points): detached
    scalar tensors including ``grad_norm``, and the forward's outputs.  The
    gradients stay in each parameter's ``.grad`` until the next step.
    """
    model.train()
    end_points = model(batch["input_joints"], eps=eps, generator=generator)
    losses = detection_loss(end_points, batch, origin_joint_id)
    optimizer.zero_grad(set_to_none=True)
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
