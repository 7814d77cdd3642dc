#!/usr/bin/env python3
"""Box sizes of multi-mode generation on the metre-box weights, on the CPU.

    python3 scripts/torch_multi_mode_box_sizes.py [--num-gaussian 100]
        [--size-sigma 0.05] [--n 1 2 5 10 30 99]

The model of ``chip_smoke.metre_box_weights`` (random weights from seed
42, the size head's mixture means set for ~1.5 m boxes, and with
``--size-sigma`` its sigmas too) at a small size (96 frames, 64 seeds, 32
proposals; the layer widths are the model's own), on 4 random clips. For
each sample count n: the widest box side in metres, and the largest box's
bounding-box voxel count at mesh AP's 0.25 m, which ``voxelize_box``
lays out as a dense grid.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num-gaussian", type=int, default=100)
    parser.add_argument("--size-sigma", type=float, default=None)
    parser.add_argument("--n", type=int, nargs="+", default=[1, 2, 5, 10, 30, 99])
    args = parser.parse_args()
    cfg = P2RNetConfig(num_frames=96, num_seeds=64, num_proposals=32, num_gaussian=args.num_gaussian)
    model = P2RNet(cfg, device="cpu", generator=torch.Generator().manual_seed(42))
    mdn = model.detection.gmm_size.mdn
    with torch.no_grad():
        mdn.mu.fill_(2 * np.log(1.5) / mdn.mu.shape[0])
        if args.size_sigma is not None:
            mdn.log_sigma.fill_(float(np.log(args.size_sigma)))
    model.eval()
    clips = torch.from_numpy(np.random.RandomState(0).randn(4, 96, 53, 3).astype(np.float32))
    print(f"G = {args.num_gaussian}, size sigma {args.size_sigma or 'as initialised (1)'}, 4 clips x 32 proposals")
    with torch.no_grad():
        for n in args.n:
            end_points = model.generate(clips, multi_mode=True, n_samples=n, generator=torch.Generator().manual_seed(n))
            sides = end_points["size"].exp()
            voxels = (sides / 0.25).prod(-1)
            print(f"n = {n}: widest side {sides.max().item():.4g} m, median side {sides.median().item():.3f} m, "
                  f"largest box {voxels.max().item():.3g} voxels of 0.25 m")


if __name__ == "__main__":
    main()
