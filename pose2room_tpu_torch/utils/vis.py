"""Result dumping (.npz/.json) in the reference file formats + PLY writers.

Port of pose2room_tpu/utils/vis.py.  The reference viewers read
``%06d_pred_confident_nms_bbox.npz`` and ``%06d_pi_dict.json`` as written by
models/p2rnet/testing.py:120-182; the formats stay exactly the same.
"""

import json
import os

import numpy as np

from pose2room_tpu_torch.ops.boxes import box_corners_from_params, corners2params, rot2head

BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def dump_predictions(dump_dir, end_points, eval_dict, parsed_predictions, gt_data=None,
                     batch_id=0, dump_threshold=0.5):
    """Write one sample's prediction (and GT) dumps:
    * ``%06d_pred_confident_nms_bbox.npz``: obbs (n,7) [center,size,heading],
      cls (n,), inst_idx (bool mask over proposals);
    * ``%06d_pi_dict.json``: the kept proposals' mixture weights;
    * ``%06d_gt_bbox.npz``: obbs (n,7), cls, when ``gt_data`` (the padded
      numpy labels) is given.
    """
    os.makedirs(dump_dir, exist_ok=True)
    corners = np.asarray(parsed_predictions["pred_corners_3d"][batch_id])
    obj_prob = np.asarray(parsed_predictions["obj_prob"][batch_id])
    pred_sem_cls = np.asarray(parsed_predictions["pred_sem_cls"][batch_id])
    pred_mask = np.asarray(eval_dict["pred_mask"])

    box_size, R_mat, center = corners2params(corners)
    box_params = np.hstack([center, box_size, rot2head(R_mat)[:, None]])

    keep_idx = np.logical_and(obj_prob > dump_threshold, pred_mask[batch_id] == 1)
    if keep_idx.any():
        np.savez(
            os.path.join(dump_dir, "%06d_pred_confident_nms_bbox.npz" % batch_id),
            obbs=box_params[keep_idx],
            cls=pred_sem_cls[keep_idx],
            inst_idx=keep_idx,
        )

    if "pi" in end_points:
        pi_dict = {
            key: end_points["pi"][key][batch_id].cpu().numpy()[keep_idx].tolist()
            for key in ("center", "size", "heading")
        }
        with open(os.path.join(dump_dir, "%06d_pi_dict.json" % batch_id), "w") as f:
            json.dump(pi_dict, f)

    if gt_data is not None:
        keep = np.asarray(gt_data["box_label_mask"])[batch_id] != 0
        if keep.any():
            sincos = np.asarray(gt_data["heading"])[batch_id][keep]
            np.savez(
                os.path.join(dump_dir, "%06d_gt_bbox.npz" % batch_id),
                obbs=np.hstack([
                    np.asarray(gt_data["center_label"])[batch_id][keep][:, 0:3],
                    np.exp(np.asarray(gt_data["size"])[batch_id][keep]),
                    np.arctan2(sincos[:, 0], sincos[:, 1])[:, None],
                ]),
                cls=np.asarray(gt_data["sem_cls_label"])[batch_id][keep],
            )


def write_ply_points(points, path):
    """Minimal ASCII PLY point-cloud writer."""
    points = np.asarray(points).reshape(-1, 3)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\nend_header\n"
        )
        for p in points:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def write_ply_boxes(obbs, path):
    """Oriented boxes as PLY edge sets. obbs: (n,7) center/size/heading."""
    obbs = np.asarray(obbs).reshape(-1, 7)
    verts, edges = [], []
    for b in obbs:
        corners = box_corners_from_params(b[0:3], b[3:6], b[6])
        base = len(verts)
        verts.extend(corners.tolist())
        edges.extend([(base + i, base + j) for i, j in BOX_EDGES])
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element edge {len(edges)}\n"
            "property int vertex1\nproperty int vertex2\nend_header\n"
        )
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for a, b_ in edges:
            f.write(f"{a} {b_}\n")
