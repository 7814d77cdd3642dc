"""Synthetic VirtualHome-format scenes (port of pose2room_tpu/data/synth.py).

A random room (objects with oriented boxes) and a skeleton trajectory that
wanders past them, with per-joint GT votes computed by the reference rule
(utils/virtualhome/3_generate_samples.py:56-79): joints inside an object's
box inflated by contact_dist=1.0 get up to GT_VOTE_FACTOR=3 centroid-offset
votes plus a mask.  ``make_scene`` and ``votes_for_skeleton`` are numpy;
``write_sample`` / ``write_synthetic_dataset`` write the reference HDF5
schema and import h5py only when called.
"""

import json
import os

import numpy as np

from pose2room_tpu_torch.ops.boxes import head2rot, points_in_obb

GT_VOTE_FACTOR = 3


def votes_for_skeleton(joints, instances, contact_dist=1.0):
    """(F, V, 1+3*GT_VOTE_FACTOR) per-joint GT votes: slot 0 the mask, then
    up to 3 centroid offsets (the first fills the unused slots)."""
    F, V, _ = joints.shape
    votes = np.zeros((F, V, 1 + 3 * GT_VOTE_FACTOR), dtype=np.float64)
    counts = np.zeros((F, V), dtype=np.int64)
    flat = joints.reshape(F * V, 3)
    for inst in instances:
        heading = np.arctan2(-inst["R_mat"][0, 2], inst["R_mat"][0, 0])
        inside = points_in_obb(
            flat, inst["centroid"], inst["size"], heading, margin=contact_dist
        ).reshape(F, V)
        offset = inst["centroid"][None, None] - joints  # (F,V,3)
        for k in range(GT_VOTE_FACTOR):
            slot = inside & (counts == k)
            sl = slice(1 + 3 * k, 4 + 3 * k)
            votes[..., sl][slot] = offset[slot]
            if k == 0:
                for k2 in range(1, GT_VOTE_FACTOR):
                    sl2 = slice(1 + 3 * k2, 4 + 3 * k2)
                    votes[..., sl2][slot] = offset[slot]
        votes[..., 0][inside] = 1
        counts[inside] += 1
    return votes


def make_scene(rng, n_objects=4, n_frames=300, num_classes=22, n_joints=53,
               class_buckets=None):
    """A random room: ``n_objects`` boxes (class = volume bucket) and a
    (n_frames, n_joints, 3) skeleton whose hip walks past them.  ``rng`` is
    a numpy RandomState; returns (joints float64, instances)."""
    buckets = class_buckets or num_classes
    instances = []
    for _ in range(n_objects):
        heading = rng.uniform(-np.pi, np.pi)
        size = rng.uniform(0.3, 1.5, size=3)
        vol = float(np.prod(size))  # in (0.027, 3.375)
        cls = int(
            np.clip(np.floor(np.log(vol / 0.027) / np.log(3.375 / 0.027) * buckets),
                    0, buckets - 1)
        )
        instances.append(
            {
                "class_id": cls,
                "centroid": np.array(
                    [rng.uniform(-3, 3), rng.uniform(0.2, 1.0), rng.uniform(-3, 3)]
                ),
                "R_mat": head2rot(heading),
                "size": size,
            }
        )

    waypoints = np.stack([i["centroid"] for i in instances])
    t = np.linspace(0, len(waypoints) - 1, n_frames)
    base = np.stack(
        [np.interp(t, np.arange(len(waypoints)), waypoints[:, d]) for d in range(3)],
        axis=1,
    )
    base[:, 1] = 0.9  # hip height
    base += rng.randn(n_frames, 3) * 0.05
    offsets = rng.randn(1, n_joints, 3) * 0.25
    offsets[0, 0] = 0
    joints = base[:, None, :] + offsets + rng.randn(n_frames, n_joints, 3) * 0.02
    return joints, instances


def as_stored(joints, instances, contact_dist=1.0):
    """(joints, votes, instances) exactly as ``load_sample`` reads back a
    sample that ``write_sample`` wrote: float32 arrays, instance fields
    rounded to float32 and widened to float64."""
    votes = votes_for_skeleton(joints, instances, contact_dist)
    stored = [
        {
            "class_id": int(inst["class_id"]),
            **{k: np.asarray(inst[k]).astype(np.float32).astype(np.float64)
               for k in ("centroid", "R_mat", "size")},
        }
        for inst in instances
    ]
    return joints.astype(np.float32), votes.astype(np.float32), stored


def write_sample(path, joints, instances, contact_dist=1.0):
    """Write one reference-schema HDF5 sample."""
    import h5py

    votes = votes_for_skeleton(joints, instances, contact_dist)
    with h5py.File(path, "w") as f:
        f.create_dataset("skeleton_joints", data=joints.astype(np.float32))
        f.create_dataset("skeleton_joint_votes", data=votes.astype(np.float32))
        nodes = f.create_group("object_nodes")
        for i, inst in enumerate(instances):
            g = nodes.create_group(str(i))
            g.create_dataset("class_id", data=np.array([inst["class_id"]], dtype=np.int64))
            g.create_dataset("centroid", data=inst["centroid"].astype(np.float32))
            g.create_dataset("R_mat", data=inst["R_mat"].astype(np.float32))
            g.create_dataset("size", data=inst["size"].astype(np.float32))


def write_synthetic_dataset(root, n_train=8, n_test=4, seed=0, n_frames=300,
                            class_buckets=None):
    """A tiny reference-format dataset: ``samples/*.hdf5`` and
    ``splits/script_level/{train,val,test}.json`` (val == test, as the
    reference split generator writes it).  Returns (train_split, test_split)."""
    rng = np.random.RandomState(seed)
    sample_dir = os.path.join(root, "samples")
    split_dir = os.path.join(root, "splits", "script_level")
    os.makedirs(sample_dir, exist_ok=True)
    os.makedirs(split_dir, exist_ok=True)
    paths = []
    for i in range(n_train + n_test):
        p = os.path.join(sample_dir, f"sample_{i:04d}.hdf5")
        joints, instances = make_scene(
            rng, n_objects=int(rng.randint(2, 6)), n_frames=n_frames,
            class_buckets=class_buckets,
        )
        write_sample(p, joints, instances)
        paths.append(p)
    splits = {"train": paths[:n_train], "test": paths[n_train:], "val": paths[n_train:]}
    for name, members in splits.items():
        with open(os.path.join(split_dir, f"{name}.json"), "w") as f:
            json.dump(members, f)
    return os.path.join(split_dir, "train.json"), os.path.join(split_dir, "test.json")
