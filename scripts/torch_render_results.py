#!/usr/bin/env python3
"""Headless results viewer of the PyTorch port: dumped prediction / GT boxes
and room context to a PNG (port of scripts/render_results.py, same flags).

Reads the ``%06d_pred_confident_nms_bbox.npz`` / ``%06d_gt_bbox.npz`` files
that test and demo runs dump (the formats of models/p2rnet/testing.py) and
composes them with optional room geometry (the sample HDF5's room bbox, GT
instances and skeleton, like the reference's vis_results.read_gt, and/or a
scene point cloud) through pose2room_tpu_torch.utils.room_view.  Needs
matplotlib, and h5py with ``--sample``.

Usage:
    python3 scripts/torch_render_results.py <dump_dir>
        [--sample sample.hdf5]        # room bbox + GT + skeleton from HDF5
        [--joints clip.npy]           # or a raw (F,53,3) pose clip
        [--scene-points pts.npy|.ply] # scene geometry overlay
        [--skeleton-every N]          # draw every Nth skeleton pose
        [--out out.png]
"""

import argparse
import glob
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def load_points(path):
    """(N, 3) points of a .npy array or an ASCII PLY's vertices (the format
    utils/vis.py:write_ply_points writes)."""
    if path.endswith(".npy"):
        return np.load(path).reshape(-1, 3)
    pts, n, in_header = [], 0, True
    with open(path) as f:
        for line in f:
            if in_header:
                if line.startswith("element vertex"):
                    n = int(line.split()[-1])
                if line.strip() == "end_header":
                    in_header = False
                continue
            if len(pts) < n:
                pts.append([float(v) for v in line.split()[:3]])
    return np.asarray(pts)


def main(argv=None):
    parser = argparse.ArgumentParser("Render dumped boxes to PNG.")
    parser.add_argument("dump_dir")
    parser.add_argument("--sample", default=None, help="sample .hdf5 for room bbox/GT/skeleton context")
    parser.add_argument("--joints", default=None, help="optional (F,53,3) .npy clip")
    parser.add_argument("--scene-points", default=None, help=".npy or .ply scene point cloud overlay")
    parser.add_argument("--skeleton-every", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    from pose2room_tpu_torch.ops.boxes import head2rot
    from pose2room_tpu_torch.utils.room_view import read_sample_scene, render_room

    pred_obbs, pred_cls = None, None
    pred_files = sorted(glob.glob(os.path.join(args.dump_dir, "*pred_confident_nms_bbox.npz")))
    if pred_files:
        parts = [np.load(p) for p in pred_files]
        pred_obbs = np.vstack([p["obbs"] for p in parts])
        pred_cls = np.concatenate([p["cls"] for p in parts])

    gt_nodes, room_bbox, joints = [], None, None
    if args.sample:
        gt_nodes, room_bbox, joints = read_sample_scene(args.sample)
    else:
        for path in sorted(glob.glob(os.path.join(args.dump_dir, "*gt_bbox.npz"))):
            data = np.load(path)
            for obb, cls in zip(data["obbs"], data["cls"]):
                gt_nodes.append({"class_id": int(cls), "centroid": obb[0:3], "size": obb[3:6],
                                 "R_mat": head2rot(obb[6])})
    if args.joints:
        joints = np.load(args.joints)

    scene_points = load_points(args.scene_points) if args.scene_points else None

    out = args.out or os.path.join(args.dump_dir, "render.png")
    render_room(
        out,
        room_bbox=room_bbox,
        gt_nodes=gt_nodes,
        pred_obbs=pred_obbs,
        pred_cls=pred_cls,
        joints=joints,
        scene_points=scene_points,
        skeleton_every=args.skeleton_every,
        title=f"pred (red) vs gt: {os.path.basename(args.dump_dir.rstrip('/'))}",
    )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
