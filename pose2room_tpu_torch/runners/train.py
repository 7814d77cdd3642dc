"""Train runner (port of pose2room_tpu/runners/train.py, reference
train.py:11-61): the model and AdamW from ``runners.common.setup``
(``method``, ``resume``, ``finetune``, ``train.freeze``, ``optim_spec``),
HDF5 loaders over ``data.split`` (thread or process workers) and the epoch
loop; checkpoints under the run directory.  ``model.compute_dtype:
bfloat16`` trains in bf16 (f32 parameters, optimizer state and
checkpoints; the val step runs the bf16 eval chain).

Data parallel (under torchrun, one process a card): each process trains on
its shard of both splits at ``train.batch_size`` / ``val.batch_size`` (the
batch of one process, as in the reference's per-GPU recipe and the JAX
package's hosts), with global BatchNorm statistics and loss normalisers and
summed gradients (``parallel.wrap_model``); rank 0 writes the files.

Tensor parallel (``device.model_parallel: tp``, tp dividing the processes,
else ValueError): the ranks form a (data, model) grid (``parallel.
make_grid``); each model group trains on its ranks' shards gathered, each
rank holds its shard of the planned weights and of their AdamW moments,
and the checkpoints are the ones one process writes.
"""

import os

from pose2room_tpu_torch.data.dataset import P2RNetDataset
from pose2room_tpu_torch.data.loader import DataLoader
from pose2room_tpu_torch.device import resolve_device
from pose2room_tpu_torch.parallel.collectives import process_count, process_index
from pose2room_tpu_torch.parallel.mesh import make_grid, model_parallel_of, wrap_model
from pose2room_tpu_torch.runners.common import setup
from pose2room_tpu_torch.train.engine import train as train_loop


def split_datasets(cfg, modes=("train", "val")):
    """{mode: P2RNetDataset} from ``data.split``/<mode>.json for each of
    ``modes`` (augmentation on the train split only)."""
    data_cfg = cfg.config["data"]
    datasets = {}
    for mode in modes:
        split_file = os.path.join(data_cfg["split"], f"{mode}.json")
        if not os.path.isfile(split_file):
            raise FileNotFoundError(
                f"Dataset split not found: {split_file}. Point data.split at a directory "
                "with train/val/test.json (pose2room_tpu_torch.data.synth."
                "write_synthetic_dataset writes a synthetic one)."
            )
        datasets[mode] = P2RNetDataset(
            split_file, num_frames=data_cfg.get("num_frames", 768),
            max_gt_boxes=data_cfg.get("max_gt_boxes", 10), augment=(mode == "train"),
            use_height=not data_cfg.get("no_height", True),
        )
    return datasets


def run(cfg, device=None, datasets=None):
    """Train from the config.  ``datasets``: {"train", "val"} datasets to use
    instead of the HDF5 splits (anything with ``__len__`` and
    ``__getitem__(idx, rng)``, e.g. ``data.dataset.SceneDataset``).

    Returns (model, history): the trained model and one {"train", "val"}
    dict of mean losses per epoch run (from ``start_epoch`` on a resume).
    The checkpoints are ``<cfg.save_path>/model_{best,last_<e>,final}.pth``.
    """
    config = cfg.config
    make_grid(model_parallel_of(config))
    device = resolve_device(device)
    seed = int(config.get("seed", 42))
    cfg.log_string("Setting up model.")
    model, optimizer, base_lrs, clip_norm, checkpoint, start_epoch, min_loss = setup(cfg, device)
    datasets = datasets if datasets is not None else split_datasets(cfg)
    device_cfg = config.get("device", {}) or {}
    loaders = {
        mode: DataLoader(
            datasets[mode], batch_size=config[mode]["batch_size"], shuffle=(mode == "train"),
            seed=seed, num_workers=device_cfg.get("num_workers", 8) or 0,
            worker_mode=device_cfg.get("worker_mode", "thread"),
            process_index=process_index(), process_count=process_count(),
        )
        for mode in ("train", "val")
    }
    cfg.log_string(f"{len(datasets['train'])} train / {len(datasets['val'])} val samples")
    cfg.log_string("Starting training.")
    try:
        history = train_loop(cfg, wrap_model(model), optimizer, base_lrs, clip_norm, loaders["train"],
                             loaders["val"], checkpoint, start_epoch=start_epoch, min_loss=min_loss)
    finally:
        for loader in loaders.values():
            loader.close()
    cfg.log_string("Training finished.")
    return model, history
