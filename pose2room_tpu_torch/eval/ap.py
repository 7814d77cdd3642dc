"""VOC-style AP of oriented 3D boxes (port of pose2room_tpu/eval/ap.py).

Reference net_utils/eval_det.py (the path without meshes): ``voc_ap`` is the
PR-envelope integration (eval_det.py:93-123), each class is matched greedily
in confidence order (eval_det_cls_wo_mesh, eval_det.py:259-343).  Each
(scan, class) takes its whole (n_det, n_gt) IoU matrix at once from
native.oriented_iou_matrix (C++, or the numpy clipper), so no process pool is
needed.  Host numpy throughout.  The voxel-occupancy ("mesh") variant,
``APCalculator.compute_metrics_w_mesh``, matches on eval/voxels.py.
"""

import numpy as np

from pose2room_tpu_torch import native
from pose2room_tpu_torch.ops.boxes import box3d_iou_oriented
from pose2room_tpu_torch.parallel.collectives import allgather_object


def voc_ap(rec, prec, use_07_metric=False):
    """VOC AP from recall / precision arrays (reference semantics)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])


def get_iou_obb(bb1, bb2):
    """Oriented 3D IoU of one pair of corner sets (eval_det.py:86-88)."""
    return float(box3d_iou_oriented(bb1, bb2)[0])


def eval_det_cls(pred, gt, ovthresh=0.25, use_07_metric=False):
    """Recall, precision and AP of one class.

    pred: {img_id: [(corners (8, 3), score)]}; gt: {img_id: [corners]}.
    """
    class_recs = {}
    npos = 0
    for img_id in gt.keys():
        bbox = np.array(gt[img_id])
        npos += len(bbox)
        class_recs[img_id] = {"bbox": bbox, "det": [False] * len(bbox)}
    for img_id in pred.keys():
        if img_id not in gt:
            class_recs[img_id] = {"bbox": np.array([]), "det": []}

    image_ids, confidence, BB = [], [], []
    for img_id in pred.keys():
        for box, score in pred[img_id]:
            image_ids.append(img_id)
            confidence.append(score)
            BB.append(box)
    confidence = np.array(confidence)
    BB = np.array(BB)
    sorted_ind = np.argsort(-confidence)
    BB = BB[sorted_ind, ...] if len(BB) else BB
    image_ids = [image_ids[x] for x in sorted_ind]

    # one (n_det, n_gt) IoU matrix per scan
    iou_cache = {}
    for img_id in set(image_ids):
        det_idx = [d for d, x in enumerate(image_ids) if x == img_id]
        BBGT = class_recs[img_id]["bbox"]
        if BBGT.size == 0 or not det_idx:
            continue
        iou_cache[img_id] = native.oriented_iou_matrix(BB[det_idx], BBGT)

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    pos_in_scan = {}
    for d in range(nd):
        img_id = image_ids[d]
        R = class_recs[img_id]
        ovmax, jmax = -np.inf, -1
        if img_id in iou_cache:
            row = pos_in_scan.setdefault(img_id, 0)
            pos_in_scan[img_id] = row + 1
            ious = iou_cache[img_id][row]
            jmax = int(np.argmax(ious))
            ovmax = float(ious[jmax])
        if ovmax > ovthresh and not R["det"][jmax]:
            tp[d] = 1.0
            R["det"][jmax] = 1
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def eval_det(pred_all, gt_all, ovthresh=0.25, use_07_metric=False):
    """Per-class (rec, prec, ap) dicts over all scans.

    pred_all: {img_id: [(cls, corners, score)]}; gt_all: {img_id: [(cls, corners)]}.
    """
    pred, gt = {}, {}
    for img_id in pred_all.keys():
        for cls, bbox, score in pred_all[img_id]:
            pred.setdefault(cls, {}).setdefault(img_id, []).append((bbox, score))
    for img_id in gt_all.keys():
        for cls, bbox in gt_all[img_id]:
            gt.setdefault(cls, {}).setdefault(img_id, []).append(bbox)
    rec, prec, ap = {}, {}, {}
    for cls in gt.keys():
        rec[cls], prec[cls], ap[cls] = eval_det_cls(pred.get(cls, {}), gt[cls], ovthresh, use_07_metric)
    return rec, prec, ap


class APCalculator:
    """Accumulates per-scan predictions and GT; computes per-class AP and
    recall, mAP and AR (ap_helper.py:24-82)."""

    def __init__(self, ap_iou_thresh=0.25, class2type_map=None):
        self.ap_iou_thresh = ap_iou_thresh
        self.class2type_map = class2type_map
        self.reset()

    def step(self, batch_pred_map_cls, batch_gt_map_cls):
        if len(batch_pred_map_cls) != len(batch_gt_map_cls):
            raise ValueError("one prediction list and one GT list per scan")
        for pred, gt in zip(batch_pred_map_cls, batch_gt_map_cls):
            self.gt_map_cls[self.scan_cnt] = gt
            self.pred_map_cls[self.scan_cnt] = pred
            self.scan_cnt += 1

    def _name(self, key):
        return self.class2type_map[key] if self.class2type_map else str(key)

    def compute_metrics(self):
        rec, _, ap = eval_det(self.pred_map_cls, self.gt_map_cls, ovthresh=self.ap_iou_thresh)
        ret = {}
        for key in sorted(ap.keys()):
            ret[f"{self._name(key)} Average Precision"] = ap[key]
        vals = [v for v in ap.values() if not np.isnan(v)]
        ret["mAP"] = np.mean(vals) if vals else 0.0
        rec_list = []
        for key in sorted(ap.keys()):
            r = rec[key][-1] if len(rec[key]) else 0
            ret[f"{self._name(key)} Recall"] = r
            rec_list.append(r)
        ret["AR"] = np.mean([r for r in rec_list if not np.isnan(r)]) if rec_list else 0.0
        return ret

    def compute_metrics_w_mesh(self):
        """Box AP plus voxel-occupancy ("mesh") AP, ``_mesh``-suffixed
        (ap_helper.py:84-125), in the keys and order of the JAX package.
        Needs scans accumulated with voxel payloads: pred entries (cls,
        corners, score, voxels), GT entries (cls, corners, voxels); see
        eval/voxels.py."""
        from pose2room_tpu_torch.eval.voxels import eval_det_w_mesh

        (rec, _, ap), (rec_m, _, ap_m) = eval_det_w_mesh(
            self.pred_map_cls, self.gt_map_cls, ovthresh=self.ap_iou_thresh
        )
        ret = {}
        for suffix, ap_d, rec_d in (("", ap, rec), ("_mesh", ap_m, rec_m)):
            recs = []
            for key in sorted(ap_d.keys()):
                ret[f"{self._name(key)} Average Precision{suffix}"] = ap_d[key]
                r = rec_d[key][-1] if len(rec_d[key]) else 0
                ret[f"{self._name(key)} Recall{suffix}"] = r
                recs.append(r)
            vals = [v for v in ap_d.values() if not np.isnan(v)]
            ret[f"mAP{suffix}"] = np.mean(vals) if vals else 0.0
            ret[f"AR{suffix}"] = np.mean([r for r in recs if not np.isnan(r)]) if recs else 0.0
        return ret

    def synchronize_between_processes(self, allgather=None):
        """Union the scans of every process (each evaluates its shard of the
        test set) before ``compute_metrics``: re-keyed densely in process
        order, voxel payloads as they are (JAX eval/ap.py:216-245).  A no-op
        in one process.  ``allgather`` (default
        ``parallel.allgather_object``) returns one object a process in rank
        order."""
        states = (allgather or allgather_object)((self.pred_map_cls, self.gt_map_cls))
        if len(states) == 1:
            return
        merged_pred, merged_gt, cnt = {}, {}, 0
        for pred, gt in states:
            for k in sorted(pred.keys()):
                merged_pred[cnt] = pred[k]
                merged_gt[cnt] = gt[k]
                cnt += 1
        self.pred_map_cls, self.gt_map_cls, self.scan_cnt = merged_pred, merged_gt, cnt

    def reset(self):
        self.gt_map_cls = {}
        self.pred_map_cls = {}
        self.scan_cnt = 0
