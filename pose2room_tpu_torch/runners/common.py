"""Shared runner plumbing: the model from the config's ``method``, its
optimizer, and a resumed or finetuned start.

Port of pose2room_tpu/runners/common.py (reference net_utils/utils.py:
205-294).  All three runners (demo, test, train) go through ``setup``, so
``method``, ``resume`` and ``finetune`` act the same in each, as in the JAX
package.
"""

import torch

from pose2room_tpu_torch.config.loader import mount_external_config
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
from pose2room_tpu_torch.train.checkpoint import CheckpointIO
from pose2room_tpu_torch.train.state import make_optimizer, train_options

# the config's ``method:`` -> model class (the JAX package's METHODS registry)
METHODS = {"P2RNet": P2RNet}


def model_class(config):
    """The class the config's ``method`` names (default P2RNet); KeyError,
    worded as the JAX registry words it, for a name it does not know."""
    method = config.get("method", "P2RNet")
    if method not in METHODS:
        raise KeyError(f"{method!r} not found in registry 'methods'; available: {sorted(METHODS)}")
    return METHODS[method]


def build_model(cfg, device=None):
    """The model of the config: its ``method``'s class initialised from
    ``seed`` with a torch.Generator.  Also mounts the dataset and eval
    configs on ``cfg``."""
    cls = model_class(cfg.config)
    mount_external_config(cfg)
    seed = int(cfg.config.get("seed", 42))
    return cls(P2RNetConfig.from_cfg(cfg), device=device, generator=torch.Generator().manual_seed(seed))


def setup(cfg, device=None):
    """Returns (model, optimizer, base_lrs, clip_norm, checkpoint,
    start_epoch, min_loss).

    With ``resume``, the newest ``model_last*`` of the sibling run dirs is
    restored whole (weights, running statistics, optimizer state, epoch,
    min_loss); otherwise, with ``finetune``, each ``weight:`` checkpoint
    (reference or port layout) is loaded partially, each skip logged (JAX
    runners/common.py:78-87)."""
    model = build_model(cfg, device)
    freeze, phase_specs = train_options(cfg.config)
    optimizer, base_lrs, clip_norm = make_optimizer(
        model, cfg.config.get("optimizer"), freeze=freeze, phase_specs=phase_specs)
    checkpoint = CheckpointIO(cfg.save_path, cfg.log_string)
    start_epoch, min_loss = 0, float("inf")
    if cfg.config.get("resume", False):
        path = checkpoint.find_resume_checkpoint()
        if path:
            cfg.log_string(f"Resuming from {path}")
            start_epoch, min_loss = checkpoint.load_into_state(path, model, optimizer)
    elif cfg.config.get("finetune", False):
        for path in cfg.config.get("weight", []) or []:
            cfg.log_string(f"Loading weights from {path}")
            checkpoint.load_weights(path, model)
    return model, optimizer, base_lrs, clip_norm, checkpoint, start_epoch, min_loss
