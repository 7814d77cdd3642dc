"""VirtualHome dataset constants: classes, joints, skeleton topology, priors.

Port of pose2room_tpu/config/dataset_config.py (reference
configs/dataset_config.py:9-134 and utils/virtualhome/__init__.py:8-38): the
53-joint skeleton topology, the 22 canonical classes and the raw -> canonical
class mapping the data pipeline applies, the contact distance, and the
per-class mean sizes that ``datagen.splits.compute_avg_prior`` writes to
``datasets/virtualhome_22_classes/splits/<level>/avg_data.json`` (relative to
the working directory, as in the reference), with the heading-bin helpers.
"""

import json
import os
from pathlib import Path

import numpy as np

# Skeleton topology of the 53-joint VirtualHome skeleton (child-parent pairs),
# reference models/p2rnet/modules/stgcn_layers.py:151-161 (layout 'virtualroom').
SKELETON_EDGES = [
    (0, 1), (1, 3), (3, 5), (5, 19), (0, 2), (2, 4), (4, 6), (6, 20),
    (0, 7), (7, 8), (8, 9), (9, 10), (10, 21), (10, 22), (8, 11), (11, 13),
    (13, 15), (15, 17), (8, 12), (12, 14), (14, 16), (16, 18), (17, 23),
    (23, 24), (24, 25), (17, 26), (26, 27), (27, 28), (17, 29), (29, 30),
    (30, 31), (17, 32), (32, 33), (33, 34), (17, 35), (35, 36), (36, 37),
    (18, 38), (38, 39), (39, 40), (18, 41), (41, 42), (42, 43), (18, 44),
    (44, 45), (45, 46), (18, 47), (47, 48), (48, 49), (18, 50), (50, 51),
    (51, 52),
]

CLASS_LABELS = [
    "bathtub", "bed", "bench", "bookshelf", "cabinet",
    "chair", "closet", "desk", "dishwasher", "faucet",
    "fridge", "garbagecan", "lamp", "microwave", "monitor",
    "nightstand", "sofa", "stove", "toilet", "washingmachine",
    "window", "computer",
]

CLASS_LABELS_RAW = [
    "bathtub", "bench", "nightstand", "desk", "closet",
    "bathroomcabinet", "toilet", "kitchencabinet", "sofa", "cabinet",
    "garbagecan", "bookshelf", "chair", "bed", "faucet",
    "window", "tv", "computer", "washingmachine", "fridge",
    "dishwasher", "stove", "microwave", "tablelamp",
]

# raw class index -> canonical class index (reference dataset_config.py:53)
CLASS_MAPPING = [0, 2, 15, 7, 6, 4, 18, 4, 16, 4, 11, 3, 5, 1, 9, 20, 14, 21,
                 19, 10, 8, 17, 13, 12]


class DatasetConfig:
    def __init__(self, dataset="virtualhome", split=None):
        if dataset != "virtualhome":
            raise NotImplementedError(f"Unknown dataset {dataset!r}")
        self.dataset = dataset
        self.root_path = Path("datasets/virtualhome_22_classes")
        self.joint_num = 53
        self.origin_joint_id = 0  # hip joint
        self.skeleton_edges = SKELETON_EDGES
        self.class_labels = CLASS_LABELS
        self.class_labels_raw = CLASS_LABELS_RAW
        self.class_mapping = CLASS_MAPPING
        self.num_class = len(CLASS_LABELS)
        self.num_heading_bin = 12
        self.num_size_cluster = self.num_class
        self.type2class = {c: i for i, c in enumerate(CLASS_LABELS)}
        self.class2type = dict(enumerate(CLASS_LABELS))
        self.contact_dist_thresh = 1.0
        self.sample_path = self.root_path / "samples"
        self.split_path = self.root_path / "splits"
        # a split like 'datasets/virtualhome_22_classes/splits/script_level' names the level
        self.split_level = "script_level" if split is None else os.path.basename(str(split))
        self.prior_path = self.split_path / self.split_level / "avg_data.json"
        self.mean_size_arr = np.ones((self.num_class, 3), dtype=np.float64)
        if self.prior_path.is_file():
            with open(self.prior_path) as f:
                prior_data = json.load(f)
            for cls_label, avg_value in prior_data.get("obj_size_cls_avg", {}).items():
                self.mean_size_arr[int(cls_label)] = avg_value
        self.type_mean_size = {self.class2type[i]: self.mean_size_arr[i] for i in range(self.num_class)}

    # Heading-bin helpers (reference dataset_config.py:95-134), for tools
    # that take the reference's binned boxes; P2RNet regresses (sin, cos).
    def angle2class(self, angle):
        num_class = self.num_heading_bin
        angle = angle % (2 * np.pi)
        angle_per_class = 2 * np.pi / float(num_class)
        shifted_angle = (angle + angle_per_class / 2) % (2 * np.pi)
        class_id = np.int16(shifted_angle / angle_per_class)
        residual_angle = shifted_angle - (class_id * angle_per_class + angle_per_class / 2)
        return class_id, residual_angle

    def class2angle(self, pred_cls, residual, to_label_format=True):
        angle_per_class = 2 * np.pi / float(self.num_heading_bin)
        angle = pred_cls * angle_per_class + residual
        if to_label_format and angle > np.pi:
            angle = angle - 2 * np.pi
        return angle

    def class2size(self, pred_cls, residual):
        return self.mean_size_arr[pred_cls, :] + residual

    def param2obb(self, center, heading_class, heading_residual, size_class, size_residual):
        obb = np.zeros((7,))
        obb[0:3] = center
        obb[3:6] = self.class2size(int(size_class), size_residual)
        obb[6] = self.class2angle(heading_class, heading_residual)
        return obb
