"""VirtualHome dataset constants the model and the parse need.

Port of the parts of pose2room_tpu/config/dataset_config.py on the serving
path: the 53-joint skeleton topology, joint count, origin (hip) joint, class
count and the contact distance used to prune boxes far from the trajectory.
"""

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


class DatasetConfig:
    def __init__(self, dataset="virtualhome"):
        if dataset != "virtualhome":
            raise NotImplementedError(f"Unknown dataset {dataset!r}")
        self.joint_num = 53
        self.origin_joint_id = 0  # hip joint
        self.num_class = len(CLASS_LABELS)
        self.class2type = dict(enumerate(CLASS_LABELS))
        self.contact_dist_thresh = 1.0
