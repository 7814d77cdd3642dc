"""Optimizer, learning-rate and BatchNorm-momentum schedules of the train path.

Port of pose2room_tpu/train/state.py (reference models/optimizers.py:22-94):
AdamW with the YAML lr / betas / eps / weight_decay (the reference builds
AdamW under the label 'Adam'), a MultiStepLR schedule at EPOCH granularity
(lr = base_lr * gamma^(milestones passed)), optional clipping by the global
gradient norm, ``train.freeze`` and per-module ``optim_spec`` overrides, and
the ``bnscheduler`` BN-momentum schedule.

``torch.optim.AdamW`` has optax.adamw's update: bias-corrected
m_hat / (sqrt(v_hat) + eps) and weight decay decoupled from the gradient
(tests/test_torch_train_step.py holds the two equal on identical
gradients).  The clipping is written as optax writes it,
``g / ||g|| * max_norm`` when ``||g|| > max_norm``; torch's
``clip_grad_norm_`` would add 1e-6 to the norm.

Param groups: one a top-level submodule (``backbone``, ``centervoting``,
``detection``), named by it.  A frozen submodule's parameters are in no
group, so they get no update at all, not even weight decay (optax
``set_to_zero``); they still get gradients, which count in the global norm
and its clipping, as the JAX chain clips before its ``multi_transform``.
"""

import torch


def lr_factor(milestones, gamma, epoch):
    """MultiStepLR: gamma^(#milestones <= epoch)."""
    return gamma ** sum(1 for m in milestones if epoch >= m)


def apply_lr_schedule(optimizer, base_lrs, factor):
    """Set each group's lr to its own base lr (``base_lrs[group name]``,
    from the config) times the epoch factor."""
    for group in optimizer.param_groups:
        group["lr"] = base_lrs[group["name"]] * factor


def bnm_momentum(bns_cfg, epoch):
    """BN momentum at an epoch under the reference's BNMomentumScheduler
    lambda (models/optimizers.py:54-58: ``max(init * rate**(epoch // step),
    floor)``, torch convention), returned as the flax keep-rate
    ``1 - torch_momentum`` that ``P2RNet.set_bn_momentum`` takes."""
    torch_m = max(
        float(bns_cfg["bn_momentum_init"])
        * float(bns_cfg["bn_decay_rate"]) ** int(epoch // int(bns_cfg["bn_decay_step"])),
        float(bns_cfg["bn_momentum_max"]),
    )
    return 1.0 - torch_m


def check_unported_keys(config):
    """Raise for each config key that the JAX package acts on and this port
    does not, when it is set: every runner calls this, so a run never goes
    on without an option it was given."""
    device_cfg = config.get("device", {}) or {}
    if int(device_cfg.get("model_parallel", 1) or 1) > 1:
        raise NotImplementedError("device.model_parallel (tensor-parallel mesh) is not ported")


def train_options(config):
    """(freeze, phase_specs) of a config: the ``train.freeze`` module names
    and {module: model.<module>.optim_spec} (JAX runners/common.py:62-67)."""
    freeze = tuple((config.get("train", {}) or {}).get("freeze", []) or [])
    phase_specs = {
        phase: spec["optim_spec"]
        for phase, spec in (config.get("model", {}) or {}).items()
        if isinstance(spec, dict) and spec.get("optim_spec")
    }
    return freeze, phase_specs


def make_optimizer(model, optim_cfg=None, freeze=(), phase_specs=None):
    """AdamW from the YAML optimizer section, one param group a top-level
    submodule of ``model`` except the ``freeze`` ones; a module of
    ``phase_specs`` takes ``{**optim_cfg, **spec}``.

    Returns (optimizer, base_lrs, clip_norm): ``base_lrs`` maps each group's
    name to its base lr, for ``apply_lr_schedule``."""
    optim_cfg = optim_cfg or {}
    phase_specs = {k: v for k, v in (phase_specs or {}).items() if v}
    by_module = {}
    for name, p in model.named_parameters():
        by_module.setdefault(name.split(".")[0], []).append(p)
    groups, base_lrs = [], {}
    for module, params in by_module.items():
        if module in freeze:
            continue
        hyper = {**optim_cfg, **phase_specs.get(module, {})}
        betas = hyper.get("betas", [0.9, 0.999])
        base_lrs[module] = float(hyper.get("lr", 1e-3))
        groups.append({
            "params": params, "name": module, "lr": base_lrs[module],
            "betas": (float(betas[0]), float(betas[1])), "eps": float(hyper.get("eps", 1e-8)),
            "weight_decay": float(hyper.get("weight_decay", 0.0)),
        })
    if not groups:
        raise ValueError(f"train.freeze {list(freeze)} leaves no parameter to train")
    return torch.optim.AdamW(groups), base_lrs, float(optim_cfg.get("clip_norm", -1))


def optimizer_steps(optimizer):
    """The number of updates the optimizer has made (AdamW's per-parameter
    ``step``; 0 before the first)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if "step" in optimizer.state.get(p, {}):
                return int(optimizer.state[p]["step"])
    return 0


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
