"""Sample generation: recordings -> reference-schema HDF5 training samples.

Port of pose2room_tpu/datagen/samples.py (reference
utils/virtualhome/3_generate_samples.py, the post-Unity half of the data
pipeline), numpy float64 throughout and float32 on write:

* trims initial poses outside the room (3_generate_samples.py:100-106) and
  rejects clips that never pass near an object (:110-124);
* recenters the world at the room's floor centroid (:126-134);
* maps raw class names -> 22 canonical classes (:136-147);
* 8x flip/rot90 augmentation (aug_idx 0..7: rot90^k, then the same with an
  x<->z flip, :19-53);
* per-joint GT votes: joints within a bbox inflated by contact_dist get up
  to 3 centroid-offset votes + mask; unused slots hold the first vote
  (:56-79);
* ``build_samples`` returns the samples as the HDF5 file holds them
  {skeleton_joints, skeleton_joint_votes, room_bbox, object_nodes}
  (:186-193); ``process_recording`` writes them, and is the only user of
  h5py here, imported when it is called.
"""

import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor
from copy import deepcopy

import numpy as np

from pose2room_tpu_torch.config.dataset_config import CLASS_LABELS, CLASS_LABELS_RAW, CLASS_MAPPING
from pose2room_tpu_torch.ops.boxes import points_in_obb, rot2head

FLIP = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], dtype=np.float64)
ROT90 = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], dtype=np.float64)  # ccw
GT_VOTE_FACTOR = 3
BOX_KEYS = ("centroid", "size", "R_mat")


def class_mapping(raw_names):
    """Raw VirtualHome class names -> canonical (id, name) lists."""
    ids = [CLASS_MAPPING[CLASS_LABELS_RAW.index(n)] for n in raw_names]
    return ids, [CLASS_LABELS[i] for i in ids]


def check_in_box(points, box_prop):
    """Points inside an oriented box given {centroid,size,R_mat} (exact OBB)."""
    centroid = np.asarray(box_prop["centroid"], dtype=np.float64)
    size = np.asarray(box_prop["size"], dtype=np.float64)
    R = np.asarray(box_prop["R_mat"], dtype=np.float64)
    offsets_proj = np.abs((points - centroid) @ R.T)
    return np.min(offsets_proj <= size / 2.0, axis=-1)


def read_pd_script(path, n_joints_total=56, valid_joint_ids=None):
    """Parse a VirtualHome ``pd_script.txt`` pose recording.

    One line per frame of whitespace-separated floats: a leading frame index,
    then n_joints_total * 3 world coordinates.  The 53 modeled joints are
    ``valid_joint_ids`` (Jaw/UpperChest/LastBone dropped, reference
    utils/virtualhome/__init__.py:36-38).
    """
    if valid_joint_ids is None:
        valid_joint_ids = [i for i in range(n_joints_total) if i not in (23, 54, 55)]
    rows = []
    with open(path) as f:
        for line in f:
            vals = line.split()
            if not vals:
                continue
            coords = np.array(vals, dtype=np.float64)
            if coords.size == n_joints_total * 3 + 1:
                coords = coords[1:]
            if coords.size != n_joints_total * 3:
                continue
            rows.append(coords.reshape(n_joints_total, 3))
    joints = np.asarray(rows)
    return joints[:, valid_joint_ids, :]


def augment_8(room_bbox, object_nodes, skeleton_joints, aug_idx):
    """One of 8 flip/rot90 variants; aug_idx 0 = identity."""
    room_bbox = deepcopy(room_bbox)
    object_nodes = deepcopy(object_nodes)
    skeleton_joints = np.array(skeleton_joints, dtype=np.float64)
    if aug_idx > 3:
        skeleton_joints = skeleton_joints @ FLIP
        for box in [room_bbox] + object_nodes:
            box["centroid"] = np.asarray(box["centroid"]) @ FLIP
            R = np.asarray(box["R_mat"]) @ FLIP
            R[2] = np.cross(R[0], R[1])
            box["R_mat"] = R
    rot = np.linalg.matrix_power(ROT90, aug_idx % 4)
    skeleton_joints = skeleton_joints @ rot
    for box in [room_bbox] + object_nodes:
        box["centroid"] = np.asarray(box["centroid"]) @ rot
        box["R_mat"] = np.asarray(box["R_mat"]) @ rot
    return room_bbox, object_nodes, skeleton_joints


def compute_votes(object_nodes, skeleton_joints, contact_dist=1.0):
    """(F,V,10) per-joint vote targets [mask, 3x centroid offsets]."""
    F, V, _ = skeleton_joints.shape
    flat = skeleton_joints.reshape(F * V, 3)
    votes = np.zeros((F * V, 1 + 3 * GT_VOTE_FACTOR))
    vote_idx = np.zeros(F * V, dtype=np.int64)
    for node in object_nodes:
        heading = rot2head(np.asarray(node["R_mat"]))
        inside = points_in_obb(
            flat,
            np.asarray(node["centroid"], dtype=np.float64),
            np.asarray(node["size"], dtype=np.float64),
            heading,
            margin=contact_dist,
        )
        offsets = np.asarray(node["centroid"])[None] - flat
        inds = np.where(inside)[0]
        votes[inds, 0] = 1
        for j in inds:
            k = vote_idx[j]
            votes[j, 1 + 3 * k : 4 + 3 * k] = offsets[j]
            if k == 0:  # pad remaining slots with the first vote
                votes[j, 4:7] = offsets[j]
                votes[j, 7:10] = offsets[j]
        vote_idx[inds] = np.minimum(2, vote_idx[inds] + 1)
    return votes.reshape(F, V, -1)


def build_samples(skeleton_joints, room_bbox, object_nodes, origin_joint_id=0, contact_dist=1.0,
                  augment=True):
    """Stage-3 processing of one recording, in memory.

    Args:
        skeleton_joints: (F, 53, 3) world-space joints.
        room_bbox: {centroid, size, R_mat}.
        object_nodes: [{class_name (raw), centroid, size, R_mat}, ...].
    Returns:
        one dict per augmentation (8, or 1 without ``augment``; [] when the
        recording is rejected) holding exactly what its HDF5 file holds:
        ``aug_idx``, float32 ``skeleton_joints`` (F', 53, 3) and
        ``skeleton_joint_votes`` (F', 53, 10), ``room_bbox`` {centroid,
        size, R_mat} float32, and ``object_nodes``, a list of {class_id
        (1,) int64, centroid, size, R_mat float32}.
    """
    skeleton_joints = np.asarray(skeleton_joints, dtype=np.float64)
    hips = skeleton_joints[:, origin_joint_id]

    # trim initial out-of-room poses; reject if never in the room
    in_room = check_in_box(hips, room_bbox)
    if not in_room.any():
        return []
    skeleton_joints = skeleton_joints[list(in_room).index(True):]
    hips = skeleton_joints[:, origin_joint_id]

    # reject when the trajectory never passes near any object
    near_any = False
    for node in object_nodes:
        dummy = dict(node)
        dummy["size"] = np.asarray(node["size"]) + 2 * contact_dist
        if check_in_box(hips, dummy).any():
            near_any = True
            break
    if not near_any:
        return []

    # recenter world at the room floor centroid
    room_bbox = deepcopy(room_bbox)
    object_nodes = deepcopy(object_nodes)
    room_centroid = np.asarray(room_bbox["centroid"], dtype=np.float64).copy()
    room_centroid[1] -= np.asarray(room_bbox["size"])[1] / 2.0
    room_bbox["centroid"] = np.asarray(room_bbox["centroid"]) - room_centroid
    for node in object_nodes:
        node["centroid"] = np.asarray(node["centroid"]) - room_centroid
    skeleton_joints = skeleton_joints - room_centroid

    # raw -> canonical classes
    for node in object_nodes:
        if "class_name" in node and "class_id" not in node:
            ids, names = class_mapping([node["class_name"]])
            node["class_id"] = ids[0]
            node["class_name"] = names[0]

    samples = []
    for aug_idx in range(8) if augment else [0]:
        rb, nodes, joints = augment_8(room_bbox, object_nodes, skeleton_joints, aug_idx)
        votes = compute_votes(nodes, joints, contact_dist)
        samples.append({
            "aug_idx": aug_idx,
            "skeleton_joints": joints.astype(np.float32),
            "skeleton_joint_votes": votes.astype(np.float32),
            "room_bbox": {k: np.asarray(rb[k], dtype=np.float32) for k in BOX_KEYS},
            "object_nodes": [
                {"class_id": np.array([node["class_id"]], dtype=np.int64),
                 **{k: np.asarray(node[k], dtype=np.float32) for k in BOX_KEYS}}
                for node in nodes
            ],
        })
    return samples


def write_sample(path, sample):
    """Write one ``build_samples`` sample to the reference HDF5 schema."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("skeleton_joints", data=sample["skeleton_joints"])
        f.create_dataset("skeleton_joint_votes", data=sample["skeleton_joint_votes"])
        rg = f.create_group("room_bbox")
        for k in BOX_KEYS:
            rg.create_dataset(k, data=sample["room_bbox"][k])
        og = f.create_group("object_nodes")
        for i, node in enumerate(sample["object_nodes"]):
            g = og.create_group(str(i))
            g.create_dataset("class_id", data=node["class_id"])
            for k in BOX_KEYS:
                g.create_dataset(k, data=node[k])


def stored_sample(sample):
    """(joints, votes, instances) of a ``build_samples`` sample as
    ``data.dataset.load_sample`` reads its file back (instances in the
    file's name order, fields widened to float64), for
    ``data.dataset.SceneDataset``."""
    nodes = sample["object_nodes"]
    instances = [
        {"class_id": int(nodes[i]["class_id"].reshape(-1)[0]),
         **{k: nodes[i][k].astype(np.float64) for k in ("centroid", "R_mat", "size")}}
        for i in sorted(range(len(nodes)), key=str)
    ]
    return sample["skeleton_joints"], sample["skeleton_joint_votes"], instances


def process_recording(skeleton_joints, room_bbox, object_nodes, out_path_base, origin_joint_id=0,
                      contact_dist=1.0, augment=True):
    """Full stage-3 processing of one recording: ``build_samples``, each
    sample written to ``<out_path_base>_<aug_idx>.hdf5``.  Returns the
    written files ([] when the recording is rejected)."""
    written = []
    for sample in build_samples(skeleton_joints, room_bbox, object_nodes, origin_joint_id, contact_dist,
                                augment):
        path = f"{out_path_base}_{sample['aug_idx']}.hdf5"
        write_sample(path, sample)
        written.append(path)
    return written


def find_recordings(recording_root):
    """Every stage-2 ``pd_script.txt`` under ``recording_root``, sorted."""
    return sorted(glob.glob(os.path.join(recording_root, "**", "pd_script.txt"), recursive=True))


def load_recording(recording_root, sk_file):
    """(sample name, joints, room_bbox, object_nodes) of one recording, its
    boxes read from the stage-1 files in the sibling ``script_bbox/`` tree;
    None where the path is not <scene>/<room>/<script>/<char>/... or a bbox
    file is missing."""
    parts = os.path.relpath(sk_file, recording_root).split(os.sep)
    if len(parts) < 4:
        return None
    scene_id, room_id, script_id, char_name = parts[:4]
    bbox_dir = os.path.join(os.path.dirname(recording_root), "script_bbox", scene_id)
    try:
        with open(os.path.join(bbox_dir, f"room_bbox_{room_id}.json")) as f:
            room_bbox = json.load(f)["room_bbox"]
        with open(os.path.join(bbox_dir, f"bbox_{room_id}.json")) as f:
            object_nodes = json.load(f)
    except FileNotFoundError:
        return None
    name = "_".join([scene_id, room_id, script_id, char_name])
    return name, read_pd_script(sk_file), room_bbox, object_nodes


def generate_samples(recording_root, sample_dir, augment=True, n_workers=8):
    """Process every pd_script.txt recording under ``recording_root`` (the
    reference layout, with the stage-1 ``script_bbox/`` tree beside it) on
    ``n_workers`` threads.  Returns the list of written sample files."""
    os.makedirs(sample_dir, exist_ok=True)

    def handle(sk_file):
        recording = load_recording(recording_root, sk_file)
        if recording is None:
            return []
        name, joints, room_bbox, object_nodes = recording
        return process_recording(joints, room_bbox, object_nodes, os.path.join(sample_dir, name),
                                 augment=augment)

    written = []
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        for result in pool.map(handle, find_recordings(recording_root)):
            written.extend(result)
    return written
