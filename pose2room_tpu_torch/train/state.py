"""Optimizer and schedule of the train path.

Port of pose2room_tpu/train/state.py (reference models/optimizers.py:41-94):
AdamW with the YAML lr / betas / eps / weight_decay (the reference builds
AdamW under the label 'Adam'), a MultiStepLR schedule at EPOCH granularity
(lr = base_lr * gamma^(milestones passed)), and optional clipping by the
global gradient norm.

``torch.optim.AdamW`` has optax.adamw's update: bias-corrected
m_hat / (sqrt(v_hat) + eps) and weight decay decoupled from the gradient,
on every parameter (tests/test_torch_train_step.py holds the two equal on
identical gradients).  The clipping is written as optax writes it,
``g / ||g|| * max_norm`` when ``||g|| > max_norm``; torch's
``clip_grad_norm_`` would add 1e-6 to the norm.
"""

import torch


def epoch_lr(base_lr, milestones, gamma, epoch):
    """MultiStepLR: base_lr * gamma^(#milestones <= epoch)."""
    return base_lr * gamma ** sum(1 for m in milestones if epoch >= m)


def set_learning_rate(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = lr


def check_unported_keys(config):
    """Raise for each config key that the JAX package acts on and this port
    does not, when it is set: every runner calls this, so a run never goes
    on without an option it was given."""
    device_cfg = config.get("device", {}) or {}
    if int(device_cfg.get("model_parallel", 1) or 1) > 1:
        raise NotImplementedError("device.model_parallel (tensor-parallel mesh) is not ported")
    if (config.get("train", {}) or {}).get("h2d_dtype"):
        raise NotImplementedError("train.h2d_dtype (compressed host-to-device batches) is not ported")
    if int((config.get("log", {}) or {}).get("profile_steps", 0) or 0) > 0:
        raise NotImplementedError("log.profile_steps (profiler windows) is not ported")


def check_supported(config):
    """Raise for the train-config options this port does not run yet,
    ``check_unported_keys`` included."""
    check_unported_keys(config)
    model_cfg = config.get("model", {}) or {}
    if config.get("train", {}).get("freeze"):
        raise NotImplementedError("train.freeze is not ported")
    if any(isinstance(v, dict) and v.get("optim_spec") for v in model_cfg.values()):
        raise NotImplementedError("per-module optim_spec is not ported")
    if config.get("bnscheduler"):
        raise NotImplementedError("the bnscheduler BN-momentum schedule is not ported")


def make_optimizer(model, optim_cfg=None):
    """AdamW over every parameter of ``model`` from the YAML optimizer
    section.  Returns (optimizer, base_lr, clip_norm)."""
    optim_cfg = optim_cfg or {}
    base_lr = float(optim_cfg.get("lr", 1e-3))
    betas = optim_cfg.get("betas", [0.9, 0.999])
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=base_lr, betas=(float(betas[0]), float(betas[1])),
        eps=float(optim_cfg.get("eps", 1e-8)),
        weight_decay=float(optim_cfg.get("weight_decay", 0.0)),
    )
    return optimizer, base_lr, float(optim_cfg.get("clip_norm", -1))


def global_norm(tensors):
    """sqrt of the sum of squares of every entry (optax.global_norm)."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm, norm):
    """In place, optax.clip_by_global_norm: g / ||g|| * max_norm where the
    global norm ``norm`` is at least ``max_norm``, else g unchanged."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
