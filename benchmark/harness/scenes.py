"""The traffic's generators: synthetic scenes, their stored form, the
train-time augmentation and rotated clips.

Frozen copies, so that the yardstick does not move when the program's own
copies change: ``make_scene`` / ``votes_for_skeleton`` / ``as_stored`` of
``pose2room_tpu_torch/data/synth.py``, ``augment_sample`` /
``sample_to_item`` of ``pose2room_tpu_torch/data/dataset.py`` and
``rotated_clip`` of ``chip_smoke.py``.  Numpy only: the reference imports
this module too, and neither imports the program.

A scene is a room of 2-5 oriented boxes and a (F, 53, 3) skeleton whose hip
walks past them, with per-joint GT votes by the reference rule (joints
within ``contact_dist`` of a box vote for its centre, up to 3 boxes).
"""

import numpy as np

GT_VOTE_FACTOR = 3
FLIP_MATRIX = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], dtype=np.float64)


def head2rot(heading):
    """Rotation about +Y with rows [[c, 0, -s], [0, 1, 0], [s, 0, c]]."""
    c, s = np.cos(heading), np.sin(heading)
    return np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])


def rot2head(R):
    return np.arctan2(-R[..., 0, 2], R[..., 0, 0])


def points_in_obb(points, center, size, heading, margin=0.0):
    """(N, 3) points inside the box inflated by ``margin`` -> bool (N,)."""
    local = (points - center) @ head2rot(heading).T
    return (np.abs(local) <= size / 2.0 + margin).all(-1)


def votes_for_skeleton(joints, instances, contact_dist=1.0):
    """(F, V, 10) per-joint GT votes: slot 0 the mask, then up to 3 centroid
    offsets (the first fills the unused slots)."""
    F, V, _ = joints.shape
    votes = np.zeros((F, V, 1 + 3 * GT_VOTE_FACTOR), dtype=np.float64)
    counts = np.zeros((F, V), dtype=np.int64)
    flat = joints.reshape(F * V, 3)
    for inst in instances:
        heading = np.arctan2(-inst["R_mat"][0, 2], inst["R_mat"][0, 0])
        inside = points_in_obb(flat, inst["centroid"], inst["size"], heading,
                               margin=contact_dist).reshape(F, V)
        offset = inst["centroid"][None, None] - joints
        for k in range(GT_VOTE_FACTOR):
            slot = inside & (counts == k)
            votes[..., 1 + 3 * k:4 + 3 * k][slot] = offset[slot]
            if k == 0:
                for k2 in range(1, GT_VOTE_FACTOR):
                    votes[..., 1 + 3 * k2:4 + 3 * k2][slot] = offset[slot]
        votes[..., 0][inside] = 1
        counts[inside] += 1
    return votes


def make_scene(rng, n_objects=4, n_frames=300, num_classes=22, n_joints=53):
    """A random room of ``n_objects`` boxes (class = volume bucket) and a
    (n_frames, n_joints, 3) float64 skeleton whose hip walks past them.
    ``rng``: a numpy RandomState.  Returns (joints, instances)."""
    instances = []
    for _ in range(n_objects):
        heading = rng.uniform(-np.pi, np.pi)
        size = rng.uniform(0.3, 1.5, size=3)
        vol = float(np.prod(size))
        cls = int(np.clip(np.floor(np.log(vol / 0.027) / np.log(3.375 / 0.027) * num_classes),
                          0, num_classes - 1))
        instances.append({
            "class_id": cls,
            "centroid": np.array([rng.uniform(-3, 3), rng.uniform(0.2, 1.0), rng.uniform(-3, 3)]),
            "R_mat": head2rot(heading),
            "size": size,
        })
    waypoints = np.stack([i["centroid"] for i in instances])
    t = np.linspace(0, len(waypoints) - 1, n_frames)
    base = np.stack([np.interp(t, np.arange(len(waypoints)), waypoints[:, d]) for d in range(3)], axis=1)
    base[:, 1] = 0.9  # hip height
    base += rng.randn(n_frames, 3) * 0.05
    offsets = rng.randn(1, n_joints, 3) * 0.25
    offsets[0, 0] = 0
    joints = base[:, None, :] + offsets + rng.randn(n_frames, n_joints, 3) * 0.02
    return joints, instances


def as_stored(joints, instances, contact_dist=1.0):
    """(joints f32, votes f32, instances) as a stored sample reads back:
    instance fields rounded to float32 and widened to float64."""
    votes = votes_for_skeleton(joints, instances, contact_dist)
    stored = [{"class_id": int(inst["class_id"]),
               **{k: np.asarray(inst[k]).astype(np.float32).astype(np.float64)
                  for k in ("centroid", "R_mat", "size")}}
              for inst in instances]
    return joints.astype(np.float32), votes.astype(np.float32), stored


def make_scenes(rng, n_scenes, objects, frames, stored=True):
    """``n_scenes`` scenes of ``objects`` = [lo, hi] boxes each (inclusive),
    ``frames`` frames: stored samples, or bare float64 joints."""
    out = []
    for _ in range(n_scenes):
        joints, instances = make_scene(rng, n_objects=int(rng.randint(objects[0], objects[1] + 1)),
                                       n_frames=frames)
        out.append(as_stored(joints, instances) if stored else joints)
    return out


def rotated_clip(joints, angle):
    """Rotate a (F, 53, 3) clip about +Y by ``angle``."""
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]], dtype=np.float32)
    return (joints @ R.T).astype(np.float32)


def frame_ids(n_in, n_out):
    """The frames a clip of ``n_in`` keeps when resampled to ``n_out``."""
    return np.linspace(0, n_in - 1, n_out).round().astype(np.int64)


def _rot_y(theta):
    return np.array([[np.cos(theta), 0.0, -np.sin(theta)], [0.0, 1.0, 0.0],
                     [np.sin(theta), 0.0, np.cos(theta)]])


def augment_sample(joints, instances, votes, rng):
    """Random x<->z flip, rotation in {-pi, -pi/2, 0, pi/2} and xz offset in
    [-1, 1], applied to joints, votes and boxes alike.  Mutates the
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
    anchor = np.repeat(joints_flat.reshape(n_frames * n_joints, 1, 3), 3, axis=1).reshape(-1, 3)
    ends = (anchor + vote_vecs) @ rot_mat
    joints_flat = joints_flat @ rot_mat
    vote_vecs = ends - np.repeat(joints_flat.reshape(n_frames * n_joints, 1, 3), 3, axis=1).reshape(-1, 3)
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


def sample_to_item(joints, votes, instances, rng, num_frames, max_gt_boxes=10, augment=True):
    """A stored sample -> the train item's fixed-shape arrays: frames
    resampled to ``num_frames``, the augmentation drawn from ``rng``, boxes
    as centre / log size / (sin, cos) heading padded to ``max_gt_boxes``."""
    ids = frame_ids(joints.shape[0], num_frames)
    joints, votes = joints[ids], votes[ids]
    instances = [dict(inst) for inst in instances]
    if augment:
        joints, instances, votes = augment_sample(joints, instances, votes, rng)
    K = max_gt_boxes
    mask = np.zeros(K, dtype=np.float32)
    semcls = np.zeros(K, dtype=np.int64)
    centers = np.zeros((K, 3), dtype=np.float32)
    sizes = np.zeros((K, 3), dtype=np.float32)
    headings = np.zeros((K, 2), dtype=np.float32)
    for i, inst in enumerate(instances[:K]):
        heading = rot2head(inst["R_mat"])
        mask[i] = 1
        semcls[i] = inst["class_id"]
        centers[i] = inst["centroid"]
        sizes[i] = np.log(inst["size"])
        headings[i] = [np.sin(heading), np.cos(heading)]
    return {
        "input_joints": joints.astype(np.float32),
        "box_label_mask": mask,
        "sem_cls_label": semcls,
        "center_label": centers,
        "size": sizes,
        "heading": headings,
        "vote_label": votes[:, :, 1:].astype(np.float32),
        "vote_label_mask": votes[:, :, 0].astype(np.int64),
    }
