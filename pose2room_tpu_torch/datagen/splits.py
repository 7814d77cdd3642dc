"""Split generation + size/layout priors (stage 4 of the data pipeline).

Port of pose2room_tpu/datagen/splits.py (reference
utils/virtualhome/4_split_samples.py), numpy; h5py is imported by
``compute_avg_prior`` when it is called:
* three split levels, seeded:
  - script_level: random permutation over all samples (generalise to new
    activity scripts);
  - char_level: hold out whole character identities;
  - room_level: hold out whole (scene, room) marks; only one character's
    samples are kept (reference filters to 'Female2', :66-67);
* val.json == test.json (:74-76);
* ``avg_data.json`` prior: per-class mean box sizes + mean room layout size
  (:148-180), consumed by DatasetConfig.mean_size_arr.
"""

import json
import os

import numpy as np


def _sample_mark(path, n_parts):
    """First n underscore-parts of a sample filename (scene/room/script/char)."""
    return "_".join(os.path.basename(path).split("_")[:n_parts])


def generate_splits(
    sample_files,
    split_dir,
    level="script_level",
    ratios=None,
    seed=2,
    keep_char=None,
):
    """Write train/val/test JSONs. Returns the split dict."""
    rng = np.random.RandomState(seed)
    os.makedirs(split_dir, exist_ok=True)
    sample_files = sorted(str(p) for p in sample_files)
    ratios = ratios or {
        "script_level": {"train": 0.8, "val": 0.2},
        "char_level": {"train": 4.0 / 5.0, "val": 1.0 / 5.0},
        "room_level": {"train": 14.0 / 15.0, "val": 1.0 / 15.0},
    }[level]

    if level == "script_level":
        order = rng.permutation(len(sample_files))
        n_train = int(round(len(sample_files) * ratios["train"]))
        train = [sample_files[i] for i in order[:n_train]]
        val = [sample_files[i] for i in order[n_train:]]
    else:
        n_parts = {"room_level": 2, "char_level": 4}[level]
        if level == "char_level":
            marks = [os.path.basename(p).split("_")[3] for p in sample_files]
        else:
            marks = [_sample_mark(p, n_parts) for p in sample_files]
        unique, reverse = np.unique(marks, return_inverse=True)
        n_train = int(round(len(unique) * ratios["train"]))
        order = rng.permutation(len(unique))
        train_ids = set(order[:n_train].tolist())
        val_ids = set(order[n_train:].tolist())
        train, val = [], []
        for i, mark_id in enumerate(reverse):
            if level == "room_level" and keep_char and keep_char not in sample_files[i]:
                continue
            if mark_id in train_ids:
                train.append(sample_files[i])
            elif mark_id in val_ids:
                val.append(sample_files[i])

    split = {"train": train, "val": val, "test": val}
    for key, value in split.items():
        with open(os.path.join(split_dir, key + ".json"), "w") as f:
            json.dump(value, f)
    return split


def compute_avg_prior(sample_files, split_dir, num_class=22):
    """Per-class mean box sizes + mean room layout -> avg_data.json."""
    import h5py

    sizes = {c: [] for c in range(num_class)}
    layouts = []
    for path in sample_files:
        with h5py.File(path, "r") as f:
            for key in f["object_nodes"]:
                node = f["object_nodes"][key]
                cls = int(np.asarray(node["class_id"]).reshape(-1)[0])
                sizes[cls].append(np.asarray(node["size"][:], dtype=np.float64))
            if "room_bbox" in f:
                layouts.append(np.asarray(f["room_bbox"]["size"][:], dtype=np.float64))

    prior = {
        "obj_size_cls_avg": {
            str(c): np.mean(v, axis=0).tolist() for c, v in sizes.items() if v
        },
    }
    if layouts:
        prior["layout_size_avg"] = np.mean(layouts, axis=0).tolist()
    with open(os.path.join(split_dir, "avg_data.json"), "w") as f:
        json.dump(prior, f)
    return prior
