"""Prediction and GT parsing: box decoding, pruning, NMS, per-class assembly.

Port of pose2room_tpu/eval/parse.py (reference net_utils/ap_helper.py:133-446).
The parallel half (exp(size), atan2 heading, softmaxes, corners for all B*K
proposals and GT boxes, and the remove_far_box containment test against the
hip trajectory) runs as torch ops on the tensors' device; the small
sequential greedy NMS and list assembly run on the host in numpy.  The
test runner dispatches the device half of a batch (``parse_predictions_device``,
``gt_corners``) and passes its host copy back in (``device_out``, ``corners``)
one batch later.

In the bf16 chain the class and objectness logits come out bf16, as in the
JAX package, which parses them as they are: the softmaxes take the bf16
logits and give bf16 probabilities (the port's ``torch.softmax`` sums in f32
and rounds once).  numpy has no bf16, so the host copy widens them to f32
(value-exact), where the JAX package keeps ml_dtypes bf16 arrays.
"""

import numpy as np
import torch

from pose2room_tpu_torch.ops.boxes import box_corners_from_params, points_in_obb
from pose2room_tpu_torch.ops.nms import nms_axis_aligned


def device_parse(center, size_log, heading_sincos, sem_cls_scores, objectness_scores,
                 input_joints, remove_far_box=True, contact_dist_thresh=1.0, origin_joint_id=0):
    """Returns corners (B,K,8,3), aabb (B,K,6), obj_prob (B,K),
    sem_cls_probs (B,K,C), pred_sem_cls (B,K), nonempty (B,K) bool, all on
    the inputs' device."""
    size = torch.exp(size_log)
    heading = torch.atan2(heading_sincos[..., 0], heading_sincos[..., 1])
    sem_cls_probs = torch.softmax(sem_cls_scores, dim=-1)
    pred_sem_cls = torch.argmax(sem_cls_scores, dim=-1)
    obj_prob = torch.softmax(objectness_scores, dim=-1)[..., 1]

    corners = box_corners_from_params(center, size, heading)  # (B,K,8,3)
    aabb = torch.cat([corners.amin(dim=2), corners.amax(dim=2)], dim=-1)

    if remove_far_box:
        degenerate = ((size < 0.01) | (size > 10.0)).any(dim=-1)
        hips = input_joints[:, :, origin_joint_id, 0:3]  # (B,N,3)
        inside = points_in_obb(hips[:, None], center, size, heading, margin=contact_dist_thresh)
        nonempty = ~degenerate & inside.any(dim=-1)
    else:
        nonempty = torch.ones(center.shape[:2], dtype=torch.bool, device=center.device)
    return corners, aabb, obj_prob, sem_cls_probs, pred_sem_cls, nonempty


def _host(x):
    """Host numpy copy; bf16 tensors widen to f32."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def parse_predictions_device(end_points, gt_data, config_dict):
    """The device half of ``parse_predictions``: ``device_parse`` of the
    network outputs, without copying anything to the host."""
    dataset_config = config_dict["dataset_config"]
    return device_parse(
        end_points["center"], end_points["size"], end_points["heading"],
        end_points["sem_cls_scores"], end_points["objectness_scores"],
        gt_data["input_joints"],
        remove_far_box=bool(config_dict.get("remove_far_box", True)),
        contact_dist_thresh=float(dataset_config.contact_dist_thresh),
        origin_joint_id=int(dataset_config.origin_joint_id),
    )


def parse_predictions(end_points, gt_data, config_dict, rng=None, device_out=None):
    """Network outputs -> (eval_dict{'pred_mask'}, parsed{'pred_corners_3d',
    'sem_cls_probs', 'obj_prob', 'pred_sem_cls'}) as host numpy, mirroring
    ap_helper.py:parse_predictions.  ``device_out``: the result of
    ``parse_predictions_device`` (or its host copy) when already dispatched."""
    if device_out is None:
        device_out = parse_predictions_device(end_points, gt_data, config_dict)
    corners, aabb, obj_prob, sem_probs, pred_sem_cls, nonempty = (_host(t) for t in device_out)

    if config_dict.get("sample_cls", False):
        rng = rng or np.random
        B, K, C = sem_probs.shape
        cum = np.cumsum(sem_probs.reshape(-1, C), axis=1)
        u = rng.rand(len(cum), 1) * cum[:, -1:]
        pred_sem_cls = (u > cum).sum(axis=1).reshape(B, K)

    bsize, K = obj_prob.shape
    pred_mask = np.zeros((bsize, K), dtype=np.uint8)
    use_3d = config_dict.get("use_3d_nms", True)
    cls_nms = config_dict.get("cls_nms", False)
    nms_iou = config_dict.get("nms_iou", 0.1)
    old_type = config_dict.get("use_old_type_nms", False)
    for i in range(bsize):
        keep = np.where(nonempty[i])[0]
        if len(keep) == 0:
            continue
        if not use_3d:
            # BEV NMS over (x, z) extents
            pick = nms_axis_aligned(aabb[i][keep][:, [0, 2, 3, 5]], obj_prob[i, keep], nms_iou, old_type)
        else:
            pick = nms_axis_aligned(
                aabb[i][keep], obj_prob[i, keep], nms_iou, old_type,
                classes=pred_sem_cls[i, keep] if cls_nms else None,
            )
        pred_mask[i, keep[pick]] = 1

    eval_dict = {"pred_mask": pred_mask}
    parsed = {
        "pred_corners_3d": corners,
        "sem_cls_probs": sem_probs,
        "obj_prob": obj_prob,
        "pred_sem_cls": pred_sem_cls,
    }
    return eval_dict, parsed


def assembly_pred_map_cls(eval_dict, parsed, config_dict):
    """Per-class proposal expansion into [(cls, corners, score), ...] lists;
    with per_class_proposal every surviving proposal contributes an entry for
    every class, scored P(cls)*P(obj) (ap_helper.py:307-314)."""
    corners = parsed["pred_corners_3d"]
    sem_probs = parsed["sem_cls_probs"]
    obj_prob = parsed["obj_prob"]
    pred_sem_cls = parsed["pred_sem_cls"]
    pred_mask = eval_dict["pred_mask"]
    conf_thresh = config_dict.get("conf_thresh", 0.05)
    num_class = config_dict["dataset_config"].num_class

    bsize, K = obj_prob.shape
    batch_pred_map_cls = []
    for i in range(bsize):
        keep = [j for j in range(K) if pred_mask[i, j] == 1 and obj_prob[i, j] > conf_thresh]
        if config_dict.get("per_class_proposal", True):
            cur = [(c, corners[i, j], sem_probs[i, j, c] * obj_prob[i, j])
                   for c in range(num_class) for j in keep]
        else:
            cur = [(int(pred_sem_cls[i, j]), corners[i, j], obj_prob[i, j]) for j in keep]
        batch_pred_map_cls.append(cur)
    eval_dict["batch_pred_map_cls"] = batch_pred_map_cls
    return eval_dict


def gt_corners(center_label, size_log, heading_sincos):
    """GT box corners (B, K2, 8, 3) on the tensors' device."""
    heading = torch.atan2(heading_sincos[..., 0], heading_sincos[..., 1])
    return box_corners_from_params(center_label, torch.exp(size_log), heading)


def parse_groundtruths(gt_data, corners=None):
    """GT corner boxes from the padded labels, padding rows zeroed, as host
    numpy (ap_helper.py:257-292).  ``corners``: ``gt_corners`` of the labels
    (or its host copy) when already dispatched; gt_data: tensors or arrays."""
    if corners is None:
        corners = gt_corners(*(torch.as_tensor(gt_data[k]) for k in ("center_label", "size", "heading")))
    mask = _host(gt_data["box_label_mask"])
    return {
        "sem_cls_label": _host(gt_data["sem_cls_label"]),
        "gt_corners_3d": _host(corners) * mask[:, :, None, None],
        "box_label_mask": mask,
    }


def assembly_gt_map_cls(parsed_gts):
    """[(cls, corners), ...] per scan from parsed GT (ap_helper.py:402-432)."""
    sem = parsed_gts["sem_cls_label"]
    corners = parsed_gts["gt_corners_3d"]
    mask = parsed_gts["box_label_mask"]
    return [
        [(int(sem[i, j]), corners[i, j]) for j in range(corners.shape[1]) if mask[i, j] == 1]
        for i in range(sem.shape[0])
    ]
