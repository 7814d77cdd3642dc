#!/usr/bin/env python3
"""Multi-mode (Bernoulli-sampled MDN) evaluation workflow of the PyTorch
port, end to end.

Port of scripts/run_multimodal.py (reference
utils/eval/multi_modal_eval.py:36-101): train a model on a synthetic
dataset, run N test passes with ``test.multi_mode: True`` (each pass draws
its own sample count and noise from its run dir's salt, as re-invoking the
reference's test.py N times does), then compute the element-wise max mAP
across runs and the TMD diversity with pose2room_tpu_torch.eval.multi_modal.

Each stage is a ``python -m pose2room_tpu_torch`` subprocess (the port's
public surface), run one at a time.  ``--device cuda`` (the default) runs
them on the card, ``--device cpu`` on the host.  The synthetic split is
HDF5, as the reference's, so the script needs h5py.

Usage (from the repository root):
    python3 scripts/torch_run_multimodal.py [--root out/multimodal] [--runs 3]
        [--epochs 30] [--n-train 120] [--n-test 16] [--dtype bfloat16]
        [--skip-train] [--device {cuda,cpu}]
"""

import argparse
import glob
import os
import subprocess
import sys
import time

import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def newest_run_dir(base):
    dirs = sorted(glob.glob(os.path.join(base, "*")), key=os.path.getmtime)
    return dirs[-1] if dirs else None


def shipped_config(name):
    """A shipped YAML of configs/config_files/ as a dict."""
    with open(os.path.join(REPO, "configs", "config_files", name)) as f:
        return yaml.safe_load(f)


def run_port(cfg_path, mode, device):
    cmd = [sys.executable, "-m", "pose2room_tpu_torch", "--config", cfg_path, "--mode", mode,
           "--device", device]
    print(f"+ {' '.join(cmd)}", flush=True)
    t0 = time.time()
    rc = subprocess.call(cmd, cwd=REPO)
    print(f"  -> rc={rc} in {time.time() - t0:.0f}s", flush=True)
    if rc != 0:
        sys.exit(rc)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(REPO, "out", "multimodal"))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--n-train", type=int, default=120)
    ap.add_argument("--n-test", type=int, default=16)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--skip-train", action="store_true",
                    help="reuse the newest existing checkpoint under --root")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every stage runs: the CUDA card, or the host")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)

    from pose2room_tpu_torch.data.synth import write_synthetic_dataset

    split = os.path.join(root, "dataset", "splits", "script_level")
    if not os.path.isdir(split):
        write_synthetic_dataset(os.path.join(root, "dataset"), n_train=args.n_train, n_test=args.n_test,
                                n_frames=900)
        print(f"synthetic dataset at {split}", flush=True)

    train_cfg = shipped_config("p2rnet_train.yaml")
    train_cfg["data"]["split"] = split
    train_cfg["model"]["compute_dtype"] = args.dtype
    train_cfg["train"]["epochs"] = args.epochs
    train_cfg["scheduler"]["milestones"] = [max(args.epochs // 2, 1)]
    train_cfg["log"]["path"] = os.path.join(root, "out")
    train_cfg["device"]["num_workers"] = 2

    if not args.skip_train:
        cfg_path = os.path.join(root, "train.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(train_cfg, f)
        run_port(cfg_path, "train", args.device)
    ckpt_dir = newest_run_dir(os.path.join(root, "out", "train"))
    if ckpt_dir is None:
        sys.exit(f"no training run under {root}/out/train: drop --skip-train or point --root at a trained root")
    ckpt = os.path.join(ckpt_dir, "model_best.pth")
    if not os.path.isfile(ckpt):
        ckpt = os.path.join(ckpt_dir, "model_final.pth")
    print(f"checkpoint: {ckpt}", flush=True)

    test_cfg = shipped_config("p2rnet_test.yaml")
    test_cfg["data"]["split"] = split
    test_cfg["model"]["compute_dtype"] = args.dtype
    test_cfg["finetune"] = True
    test_cfg["weight"] = [ckpt]
    test_cfg["test"]["multi_mode"] = True
    test_cfg["generation"]["dump_results"] = True
    # dump everything NMS kept: TMD needs per-instance boxes across runs and
    # an undertrained synthetic model rarely clears the reference's 0.5
    test_cfg["generation"]["dump_threshold"] = 0.05
    test_cfg["log"]["path"] = os.path.join(root, "out")
    test_cfg["device"]["num_workers"] = 2

    run_dirs = []
    for i in range(args.runs):
        cfg_path = os.path.join(root, f"test_mm_{i}.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(test_cfg, f)
        run_port(cfg_path, "test", args.device)
        run_dirs.append(newest_run_dir(os.path.join(root, "out", "test")))

    print("\nrun dirs:", run_dirs, flush=True)
    from pose2room_tpu_torch.eval import multi_modal

    return multi_modal.main(run_dirs)


if __name__ == "__main__":
    sys.exit(main())
