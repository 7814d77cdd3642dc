#!/usr/bin/env python3
"""Repeat ``chip_smoke.py``'s data pipeline training and its eval_nn_loss
check on a CUDA card.

    python3 scripts/torch_eval_nn_repeat.py [--runs 10]

Generates phase 12's 24 samples once (in memory), then ``--runs`` times
trains one epoch at p2rnet_train.yaml's width and runs
``chip_smoke.pipeline_eval_nn_loss`` on the new ``model_final.pth``. The
epoch is not deterministic on the card, so each run checks other weights;
each prints the votes' card-to-CPU gap, how many picks FPS on the CPU's own
votes parts from the card's, and the eval_nn_loss gaps. A failed check
raises.
"""

import argparse
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=10)
    args = parser.parse_args()
    if not chip_smoke.torch.cuda.is_available():
        sys.exit("torch_eval_nn_repeat: this needs a CUDA card")
    chip_smoke.set_precision_policy()
    chip_smoke.kernels.timed_build()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as workdir:
        root = os.path.join(workdir, "pipeline")
        os.makedirs(root)
        os.chdir(root)  # DatasetConfig reads the prior under ./datasets, the board writes ./runs
        try:
            samples = chip_smoke.pipeline_datagen(root)
            split = chip_smoke.pipeline_split_in_memory(root, samples)
            for run in range(args.runs):
                run_dir, _, model_cfg = chip_smoke.pipeline_train(root, samples, split, "cuda", False)
                print(f"run {run}:", flush=True)
                chip_smoke.pipeline_eval_nn_loss(run_dir, model_cfg, samples, split["val"], "cuda")
        finally:
            os.chdir(cwd)
    print(f"{args.runs} runs, every check met; {chip_smoke.nvidia_smi()}")


if __name__ == "__main__":
    main()
