"""VirtualHome samples, train-time augmentation and demo clips.

Port of pose2room_tpu/data/dataset.py (reference
models/p2rnet/dataloader.py:17-147), numpy throughout:

* ``load_sample`` reads the HDF5 layout ``skeleton_joints`` (F,53,3),
  ``skeleton_joint_votes`` (F,53,10) [mask + 3 centroid-offset votes] and
  ``object_nodes/<i>/{class_id, centroid, R_mat, size}``; it is the only
  reader of h5py, imported when it is called;
* ``sample_to_item`` turns a read sample into the reference item dict:
  frames resampled to ``num_frames`` by np.linspace(...).round(), the
  augmentation (random x<->z flip, rotation in {-pi, -pi/2, 0, pi/2}, xz
  offset in [-1, 1]) applied to joints, votes and boxes alike, boxes as
  center / LOG size / (sin, cos) heading padded to ``max_gt_boxes``;
* ``P2RNetDataset`` (a split file of HDF5 paths) and ``SceneDataset``
  (samples held in memory) both index through ``sample_to_item``.
"""

import json
import os

import numpy as np

from pose2room_tpu_torch.ops.boxes import rot2head

FLIP_MATRIX = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], dtype=np.float64)


def _rot_y(theta):
    return np.array(
        [
            [np.cos(theta), 0.0, -np.sin(theta)],
            [0.0, 1.0, 0.0],
            [np.sin(theta), 0.0, np.cos(theta)],
        ]
    )


def load_sample(path):
    """One HDF5 sample -> (joints f32, votes f32, instances) with instance
    fields as float64."""
    import h5py

    with h5py.File(path, "r") as f:
        joints = f["skeleton_joints"][:]
        votes = f["skeleton_joint_votes"][:]
        instances = []
        for name in f["object_nodes"].keys():
            node = f["object_nodes"][name]
            instances.append({
                "class_id": int(np.asarray(node["class_id"]).reshape(-1)[0]),
                "centroid": node["centroid"][:].astype(np.float64),
                "R_mat": node["R_mat"][:].astype(np.float64),
                "size": node["size"][:].astype(np.float64),
            })
    return joints.astype(np.float32, copy=False), votes.astype(np.float32, copy=False), instances


def augment_sample(joints, instances, votes, rng):
    """Random flip / rotate / translate (dataloader.py:31-80), in the
    arrays' own dtype, each transform one (F*V*3, 3) GEMM.  Mutates the
    instance dicts; returns (joints, instances, votes)."""
    if_flip = rng.randint(0, 2)
    rot_angle = rng.choice([-np.pi, -0.5 * np.pi, 0.0, 0.5 * np.pi])
    offset = np.array([1.0, 0.0, 1.0]) * rng.uniform(-1.0, 1.0)
    n_frames, n_joints = votes.shape[:2]
    flip_m = FLIP_MATRIX.astype(joints.dtype)
    rot_mat = _rot_y(rot_angle).astype(joints.dtype)
    vote_vecs = np.ascontiguousarray(votes[..., 1:]).reshape(-1, 3)
    joints_flat = joints.reshape(-1, 3)

    if if_flip:
        joints_flat = joints_flat @ flip_m
        vote_vecs = vote_vecs @ flip_m
        for node in instances:
            node["centroid"] = node["centroid"] @ FLIP_MATRIX
            R = node["R_mat"] @ FLIP_MATRIX
            R[2] = np.cross(R[0], R[1])
            node["R_mat"] = R

    # rotate: votes are centroid offsets, so rotate the absolute endpoints
    joint_anchor = np.repeat(
        joints_flat.reshape(n_frames * n_joints, 1, 3), 3, axis=1
    ).reshape(-1, 3)
    ends = (joint_anchor + vote_vecs) @ rot_mat
    joints_flat = joints_flat @ rot_mat
    vote_vecs = ends - np.repeat(
        joints_flat.reshape(n_frames * n_joints, 1, 3), 3, axis=1
    ).reshape(-1, 3)
    joints = joints_flat.reshape(n_frames, n_joints, 3)
    votes = votes.copy()
    votes[..., 1:] = vote_vecs.reshape(n_frames, n_joints, 9)
    for node in instances:
        node["centroid"] = node["centroid"] @ rot_mat
        node["R_mat"] = node["R_mat"] @ rot_mat

    joints = joints + offset.astype(joints.dtype)
    for node in instances:
        node["centroid"] = node["centroid"] + offset
    return joints, instances, votes


def sample_to_item(joints, votes, instances, rng, *, num_frames=768, max_gt_boxes=10,
                   augment=False, use_height=False, sample_idx=""):
    """A read sample -> the reference item dict of fixed-shape arrays.

    joints (F, 53, 3) f32, votes (F, 53, 10) f32, instances as
    ``load_sample`` returns them (mutated by the augmentation); ``rng`` a
    numpy RandomState, drawn from only when ``augment``.
    """
    # subsample first: the augmentation is the same for every frame and
    # commutes with it; the height floor is the one full-clip statistic
    floor = np.percentile(joints[..., 1], 0.99) if use_height else None
    frame_ids = np.linspace(0, joints.shape[0] - 1, num_frames).round().astype(np.int64)
    joints = joints[frame_ids]
    votes = votes[frame_ids]
    if augment:
        joints, instances, votes = augment_sample(joints, instances, votes, rng)

    boxes3D, classes = [], []
    for inst in instances:
        heading = rot2head(inst["R_mat"])
        boxes3D.append(np.hstack(
            [inst["centroid"], np.log(inst["size"]), [np.sin(heading), np.cos(heading)]]
        ))
        classes.append(inst["class_id"])
    boxes3D = np.array(boxes3D).reshape(-1, 8)

    if use_height:
        height = joints[..., 1] - floor
        joints = np.concatenate([joints, height[..., None]], axis=-1)

    K = max_gt_boxes
    mask = np.zeros(K, dtype=np.float32)
    semcls = np.zeros(K, dtype=np.int64)
    centers = np.zeros((K, 3), dtype=np.float32)
    sizes = np.zeros((K, 3), dtype=np.float32)
    headings = np.zeros((K, 2), dtype=np.float32)
    n = min(len(boxes3D), K)
    if n:
        mask[:n] = 1
        semcls[:n] = classes[:n]
        centers[:n] = boxes3D[:n, 0:3]
        sizes[:n] = boxes3D[:n, 3:6]
        headings[:n] = boxes3D[:n, 6:8]

    return {
        "input_joints": joints.astype(np.float32),
        "box_label_mask": mask,
        "sem_cls_label": semcls,
        "center_label": centers,
        "size": sizes,
        "heading": headings,
        "vote_label": votes[:, :, 1:].astype(np.float32),
        "vote_label_mask": votes[:, :, 0].astype(np.int64),
        "sample_idx": sample_idx,
    }


class P2RNetDataset:
    """Split-file-backed dataset of HDF5 samples yielding reference items."""

    def __init__(self, split_file, num_frames=768, max_gt_boxes=10, augment=False,
                 use_height=False):
        with open(split_file) as f:
            self.paths = json.load(f)
        self.item_kw = dict(num_frames=num_frames, max_gt_boxes=max_gt_boxes,
                            augment=augment, use_height=use_height)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx, rng=None):
        path = self.paths[idx]
        joints, votes, instances = load_sample(path)
        return sample_to_item(
            joints, votes, instances, rng or np.random,
            sample_idx=os.path.splitext(os.path.basename(path))[0], **self.item_kw,
        )


class SceneDataset:
    """Samples held in memory, e.g. from ``synth.make_scene`` through
    ``synth.as_stored``: a list of (joints, votes, instances).  Indexes
    through ``sample_to_item`` like ``P2RNetDataset``, with no file IO."""

    def __init__(self, samples, num_frames=768, max_gt_boxes=10, augment=False,
                 use_height=False):
        self.samples = samples
        self.item_kw = dict(num_frames=num_frames, max_gt_boxes=max_gt_boxes,
                            augment=augment, use_height=use_height)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx, rng=None):
        joints, votes, instances = self.samples[idx]
        instances = [dict(inst) for inst in instances]  # the augmentation rebinds fields
        return sample_to_item(joints, votes, instances, rng or np.random,
                              sample_idx=f"scene_{idx:04d}", **self.item_kw)


def load_demo_clip(path, num_frames=768, use_height=False):
    """Load a raw (F,53,3) .npy pose clip the way the reference demo.py:23-51
    does: optional height channel, then resample to ``num_frames`` frames."""
    joints = np.load(path)
    if use_height:
        floor = np.percentile(joints[..., 1], 0.99)
        height = joints[..., 1] - floor
        joints = np.concatenate([joints, height[..., None]], axis=-1)
    frame_ids = np.linspace(0, joints.shape[0] - 1, num_frames).round().astype(np.int64)
    return joints[frame_ids].astype(np.float32)
