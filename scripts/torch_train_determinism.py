#!/usr/bin/env python3
"""Run-to-run spread of the port's f32 train run on a CUDA card.

    python3 scripts/torch_train_determinism.py [--runs 3]

Two-epoch train runs through the train runner at the full width of
p2rnet_train.yaml (T=768, global batch 8), on the data and config of
``chip_smoke.py``'s train options phase: 16 augmented and 8 plain in-memory
synthetic scenes from seed 5 (2 train steps and 1 val step an epoch),
weight decay 0.01, clip_norm 1.0, a milestone at epoch 1 and the
BN-momentum schedule.  Every run starts from the same seed, first with
PyTorch's default algorithms, then with ``torch.use_deterministic_algorithms``.
For each mode it prints whether each later run's final weights equal the
first run's bit for bit, the largest parameter gap, and the relative gaps of
the epoch-2 mean total losses, and each run's wall time (host clock, the
first run's includes building the kernels).
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pose2room_tpu_torch.config.loader import CONFIG, read_to_dict  # noqa: E402
from pose2room_tpu_torch.data import synth  # noqa: E402
from pose2room_tpu_torch.data.dataset import SceneDataset  # noqa: E402
from pose2room_tpu_torch.runners import train as train_runner  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_YAML = os.path.join(REPO, "configs", "config_files", "p2rnet_train.yaml")
BNS = {"bn_momentum_init": 0.5, "bn_decay_rate": 0.5, "bn_decay_step": 1, "bn_momentum_max": 0.001}


def datasets():
    rng = np.random.RandomState(5)
    scenes = [synth.as_stored(*synth.make_scene(rng, n_objects=int(rng.randint(2, 6)), n_frames=900))
              for _ in range(24)]
    return {"train": SceneDataset(scenes[:16], num_frames=768, augment=True),
            "val": SceneDataset(scenes[16:], num_frames=768, augment=False)}


def train_run(workdir, name, data):
    """One 2-epoch run from its own working directory (the TensorBoard
    board writes to ./runs); returns (final parameters on the host, the
    epoch-2 mean total losses, the run's seconds)."""
    config = read_to_dict(TRAIN_YAML)
    config.update(seed=42, resume=False, finetune=False)
    config["train"].update(epochs=2, batch_size=8)
    config["val"]["batch_size"] = 8
    config["optimizer"].update(weight_decay=0.01, clip_norm=1.0)
    config["scheduler"]["milestones"] = [1]
    config["bnscheduler"] = dict(BNS)
    config["log"].update(path=os.path.join(workdir, name), print_step=1)
    cwd = os.path.join(workdir, f"{name}_cwd")
    os.makedirs(cwd)
    os.chdir(cwd)
    cfg = CONFIG(config, mode="train")
    try:
        t0 = time.perf_counter()
        model, history = train_runner.run(cfg, datasets=data)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        cfg.close()
        os.chdir(workdir)
    params = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
    return params, {phase: history[-1][phase]["total"] for phase in ("train", "val")}, seconds


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_train_determinism: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[{smi}] torch {torch.__version__}", flush=True)
    data = datasets()
    with tempfile.TemporaryDirectory() as workdir:
        for mode in ("default", "deterministic"):
            torch.use_deterministic_algorithms(mode == "deterministic", warn_only=True)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                runs = [train_run(workdir, f"{mode}{i}", data) for i in range(args.runs)]
            torch.use_deterministic_algorithms(False)
            print(f"[{smi}] {mode} algorithms, run seconds: {', '.join(f'{r[2]:.3f}' for r in runs)}",
                  flush=True)
            (p0, l0, _), later = runs[0], runs[1:]
            for i, (p, losses, _) in enumerate(later, 1):
                same = all(torch.equal(p[k], p0[k]) for k in p0)
                gap = max((p[k].double() - p0[k].double()).abs().max().item() for k in p0)
                rel = {ph: abs(losses[ph] - l0[ph]) / abs(l0[ph]) for ph in l0}
                print(f"[{smi}] {mode} algorithms, run {i} vs run 0 after 4 train steps: parameters "
                      f"bit-equal {same}, largest parameter gap {gap:.3e}; epoch-2 mean total loss rel gap "
                      f"train {rel['train']:.2e}, val {rel['val']:.2e}", flush=True)


if __name__ == "__main__":
    main()
