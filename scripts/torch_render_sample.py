#!/usr/bin/env python3
"""Headless dataset verifier of the PyTorch port: render an HDF5 sample's
boxes, skeleton trajectory and votes to a PNG (port of
scripts/render_sample.py, same flags; the reference's GT viewer
utils/virtualhome/vis_gt_vh.py, README.md:57-63).  Needs h5py and
matplotlib.

Usage:
    python3 scripts/torch_render_sample.py <sample.hdf5> [--out out.png] [--max-frames 40]
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    parser = argparse.ArgumentParser("Render a dataset sample.")
    parser.add_argument("sample")
    parser.add_argument("--out", default=None)
    parser.add_argument("--max-frames", type=int, default=40)
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from pose2room_tpu_torch.config.dataset_config import CLASS_LABELS
    from pose2room_tpu_torch.data.dataset import load_sample
    from pose2room_tpu_torch.ops.boxes import box_corners_from_params, rot2head
    from pose2room_tpu_torch.utils.vis import BOX_EDGES

    joints, votes, instances = load_sample(args.sample)

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")

    # GT boxes
    for inst in instances:
        corners = box_corners_from_params(inst["centroid"], inst["size"], rot2head(inst["R_mat"]))
        for a, b in BOX_EDGES:
            ax.plot(*zip(corners[a], corners[b]), color="tab:green", linewidth=1.2)
        ax.text(*inst["centroid"], CLASS_LABELS[inst["class_id"]], fontsize=7, color="tab:green")

    # skeleton trajectory + a few votes
    step = max(1, joints.shape[0] // args.max_frames)
    hips = joints[::step, 0]
    ax.plot(hips[:, 0], hips[:, 1], hips[:, 2], color="tab:blue", linewidth=0.8)
    mask = votes[::step, :, 0] > 0
    src = joints[::step][mask]
    dst = src + votes[::step][mask][:, 1:4]
    for s, d in list(zip(src, dst))[:150]:
        ax.plot(*zip(s, d), color="tab:orange", linewidth=0.3, alpha=0.5)

    ax.set_title(f"GT sample: {os.path.basename(args.sample)}")
    ax.view_init(elev=35, azim=-60)
    out = args.out or os.path.splitext(args.sample)[0] + ".png"
    fig.savefig(out, dpi=130, bbox_inches="tight")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
