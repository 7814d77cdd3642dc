"""Shared runner plumbing: the model from the config's ``method``, its
optimizer, and a resumed or finetuned start.

Port of pose2room_tpu/runners/common.py (reference net_utils/utils.py:
205-294).  All three runners (demo, test, train) go through ``setup``, so
``method``, ``resume`` and ``finetune`` act the same in each, as in the JAX
package.  In a data-parallel run every rank builds the same model from the
same seed and loads the same checkpoints onto its own card.  Under a
tensor-parallel grid (``device.model_parallel``, ``parallel.make_grid``)
each rank then keeps its shard of the planned weights and of their AdamW
moments (``parallel.tensor.shard_module_``), after the whole checkpoints
are loaded, as JAX runners/common.py:89-95 shards after them.
"""

import types

import numpy as np
import torch

from pose2room_tpu_torch.config.loader import mount_external_config
from pose2room_tpu_torch.models.agcn import AGCN, AGCNConfig
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
from pose2room_tpu_torch.parallel.collectives import current_grid, process_index
from pose2room_tpu_torch.parallel.tensor import shard_module_
from pose2room_tpu_torch.train.checkpoint import CheckpointIO
from pose2room_tpu_torch.train.state import make_optimizer, train_options

# the config's ``method:`` -> model class (the JAX package's METHODS registry;
# AGCN, 2s-AGCN's joint stream, has no counterpart there)
METHODS = {"P2RNet": P2RNet, "AGCN": AGCN}
# each class's configuration, read from the config by its ``from_cfg``
CONFIGS = {P2RNet: P2RNetConfig, AGCN: AGCNConfig}


def model_class(config):
    """The class the config's ``method`` names (default P2RNet); KeyError,
    worded as the JAX registry words it, for a name it does not know."""
    method = config.get("method", "P2RNet")
    if method not in METHODS:
        raise KeyError(f"{method!r} not found in registry 'methods'; available: {sorted(METHODS)}")
    return METHODS[method]


def build_model(cfg, device=None):
    """The model of the config (a CONFIG, or a plain dict such as
    ``{"method": "AGCN", "model": {...}}``): its ``method``'s class
    initialised from ``seed`` with a torch.Generator.  Also mounts the
    dataset and eval configs on ``cfg``."""
    if isinstance(cfg, dict):
        cfg = types.SimpleNamespace(config=cfg)
    cls = model_class(cfg.config)
    mount_external_config(cfg)
    seed = int(cfg.config.get("seed", 42))
    return cls(CONFIGS[cls].from_cfg(cfg), device=device, generator=torch.Generator().manual_seed(seed))


def setup(cfg, device=None):
    """Returns (model, optimizer, base_lrs, clip_norm, checkpoint,
    start_epoch, min_loss).

    With ``resume``, the newest ``model_last*`` of the sibling run dirs is
    restored whole (weights, running statistics, optimizer state, epoch,
    min_loss); otherwise, with ``finetune``, each ``weight:`` checkpoint
    (reference or port layout) is loaded partially, each skip logged (JAX
    runners/common.py:78-87).

    Seeds numpy's global stream with ``seed + rank`` (JAX
    runners/common.py:41); in a data-parallel run the caller has joined the
    group before building ``cfg`` (the CONFIG raises otherwise), and under
    ``device.model_parallel`` made the grid (``parallel.make_grid``)."""
    if model_class(cfg.config) is not P2RNet:
        raise NotImplementedError(f"the runners drive P2RNet; build {cfg.config['method']} with build_model")
    np.random.seed(int(cfg.config.get("seed", 42)) + process_index())
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
    if current_grid() is not None:
        plan = shard_module_(model, optimizer)
        cfg.log_string(f"tensor parallel over {current_grid().tp} ranks: {len(plan)} weights sharded")
    return model, optimizer, base_lrs, clip_norm, checkpoint, start_epoch, min_loss
