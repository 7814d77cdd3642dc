"""Voxel-occupancy IoU evaluation (the reference's "mesh" AP variant).

Port of pose2room_tpu/eval/voxels.py, host numpy.  Capability parity with
reference net_utils/eval_det.py:27-83 (``compute_mesh_iou`` over trimesh
VoxelGrid pairs), :133-258 (``eval_det_cls_w_mesh`` dual box/voxel
matching) and
net_utils/ap_helper.py:84-125 (``APCalculator.compute_metrics_w_mesh``),
without the trimesh/binvox dependency: occupancies are dependency-free
integer-voxel index sets (``OccupancyGrid``), and P2RNet's predictions are
oriented boxes, so ``voxelize_box`` rasterizes an OBB into the
(internal, surface) grid pair the IoU formula consumes.  The IoU itself is
the reference's symmetric overlap combination
``(a1*a2)/(a1+a2-a1*a2)`` with ``a_i`` = fraction of i's filled points
covered by the other occupancy (eval_det.py:79-83).
"""

import numpy as np

from pose2room_tpu_torch.eval.ap import get_iou_obb, voc_ap
from pose2room_tpu_torch.ops.boxes import corners2params, rot2head


# packed int64 key per (i, j, k) voxel index; SPAN bounds |index| < SPAN/2,
# far beyond any realistic scene at centimeter voxels, without overflowing
# int64 (SPAN**3 = 2**60)
_SPAN = 2**20


def _voxel_keys(idx):
    i = idx + _SPAN // 2
    return (i[:, 0] * _SPAN + i[:, 1]) * _SPAN + i[:, 2]


def _keys_contain(sorted_keys, keys):
    """Vectorized membership of ``keys`` in a sorted unique key array."""
    if len(sorted_keys) == 0:
        return np.zeros(len(keys), dtype=bool)
    pos = np.searchsorted(sorted_keys, keys)
    pos = np.minimum(pos, len(sorted_keys) - 1)
    return sorted_keys[pos] == keys


class OccupancyGrid:
    """A set of filled voxels on the global ``voxel_size`` lattice.

    Stand-in for the trimesh VoxelGrid surface the reference uses: exposes
    ``filled_count``, world-space ``points`` (filled voxel centers), and
    ``is_filled(points)``.  Membership is a searchsorted over packed int64
    voxel keys — is_filled runs inside the O(n_det x n_gt) matching loop of
    ``eval_det_cls_w_mesh``, so it must be fully vectorized (the reference
    leans on trimesh's vectorized VoxelGrid fill test there)."""

    def __init__(self, indices, voxel_size):
        indices = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
        self.voxel_size = float(voxel_size)
        self._indices = (
            np.unique(indices, axis=0) if len(indices) else indices
        )
        self._keys = _voxel_keys(self._indices)  # sorted by construction

    @property
    def filled_count(self):
        return len(self._indices)

    @property
    def points(self):
        return (self._indices + 0.5) * self.voxel_size

    def is_filled(self, points):
        points = np.asarray(points).reshape(-1, 3)
        idx = np.floor(points / self.voxel_size).astype(np.int64)
        return _keys_contain(self._keys, _voxel_keys(idx))


def voxelize_box(box, voxel_size=0.0625):
    """Rasterize an oriented box into (internal, surface) occupancies.

    Args:
        box: (8, 3) corners or (7,) [center, size, heading] params.
    Returns:
        (internal, surface) OccupancyGrid pair — surface = filled voxels with
        an unfilled 6-neighbor, internal = the rest (matching the
        binvox exact-surface/interior split the reference feeds
        compute_mesh_iou).
    """
    box = np.asarray(box, dtype=np.float64)
    if box.shape == (8, 3):
        size, R, center = corners2params(box[None])
        size, center = size[0], center[0]
        heading = float(rot2head(R[0]))
    else:
        center, size, heading = box[0:3], box[3:6], float(box[6])
    c, s = np.cos(heading), np.sin(heading)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    # candidate voxels: AABB of the box, then exact OBB test on centers
    half_diag = np.abs(R.T * size / 2.0).sum(axis=1)
    lo = np.floor((center - half_diag) / voxel_size).astype(int) - 1
    hi = np.ceil((center + half_diag) / voxel_size).astype(int) + 1
    axes = [np.arange(l, h + 1) for l, h in zip(lo, hi)]
    ii, jj, kk = np.meshgrid(*axes, indexing="ij")
    idx = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)
    centers = (idx + 0.5) * voxel_size
    local = np.abs((centers - center) @ R.T)
    inside = np.all(local <= size / 2.0, axis=1)
    filled = idx[inside]
    if not len(filled):
        empty = OccupancyGrid(np.zeros((0, 3)), voxel_size)
        return empty, empty

    filled_keys = np.sort(_voxel_keys(filled))
    neighbors = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]
    )
    all_neighbors_filled = np.ones(len(filled), dtype=bool)
    for n in neighbors:
        all_neighbors_filled &= _keys_contain(
            filled_keys, _voxel_keys(filled + n)
        )
    on_surface = ~all_neighbors_filled
    return (
        OccupancyGrid(filled[~on_surface], voxel_size),
        OccupancyGrid(filled[on_surface], voxel_size),
    )


def compute_mesh_iou(voxel1, voxel2):
    """Voxel-occupancy IoU of two (internal, surface) pairs — exact port of
    the reference formula (eval_det.py:27-83)."""
    v1_int, v1_surf = voxel1
    v2_int, v2_surf = voxel2
    if v1_surf.filled_count == 0 or v2_surf.filled_count == 0:
        return 0.0

    def own_points(internal, surface):
        if internal.filled_count == 0:
            return surface.points
        surf = surface.points[~internal.is_filled(surface.points)]
        return np.vstack([internal.points, surf])

    def covered(points, internal, surface):
        # boolean OR, matching the reference's numpy bool-array `+` (which
        # is logical or): a point filled in BOTH grids counts once —
        # summing int hits would double-count and let a_i exceed 1
        hits = surface.is_filled(points)
        if internal.filled_count > 0:
            hits = hits | internal.is_filled(points)
        return int(np.sum(hits))

    v1_points = own_points(v1_int, v1_surf)
    v2_points = own_points(v2_int, v2_surf)
    v1_in_v2 = covered(v1_points, v2_int, v2_surf)
    v2_in_v1 = covered(v2_points, v1_int, v1_surf)
    if v1_in_v2 == 0 or v2_in_v1 == 0:
        return 0.0
    a1 = v1_in_v2 / v1_points.shape[0]
    a2 = v2_in_v1 / v2_points.shape[0]
    return (a1 * a2) / (a1 + a2 - a1 * a2)


def eval_det_cls_w_mesh(pred, gt, ovthresh=0.25, use_07_metric=False,
                        get_iou_func=get_iou_obb, get_iou_mesh=compute_mesh_iou):
    """Dual box/voxel precision-recall for one class
    (eval_det.py:133-258 semantics).

    Args:
        pred: {img_id: [(bbox(8,3), score, voxels)]};
        gt: {img_id: [(bbox(8,3), voxels)]}, voxels = (internal, surface).
    Returns:
        ((rec, prec, ap), (rec_mesh, prec_mesh, ap_mesh)).
    """
    class_recs = {}
    npos = 0
    for img_id in gt.keys():
        bbox = np.array([item[0] for item in gt[img_id]])
        mesh = [item[1] for item in gt[img_id]]
        npos += len(bbox)
        class_recs[img_id] = {
            "bbox": bbox, "mesh": mesh,
            "det": [False] * len(bbox), "det_mesh": [False] * len(bbox),
        }
    for img_id in pred.keys():
        if img_id not in gt:
            class_recs[img_id] = {
                "bbox": np.array([]), "mesh": [], "det": [], "det_mesh": [],
            }

    image_ids, confidence, BB, meshes = [], [], [], []
    for img_id in pred.keys():
        for box, score, mesh in pred[img_id]:
            image_ids.append(img_id)
            confidence.append(score)
            BB.append(box)
            meshes.append(mesh)
    confidence = np.array(confidence)
    order = np.argsort(-confidence)
    BB = np.array(BB)[order] if len(BB) else np.array(BB)
    meshes = [meshes[x] for x in order]
    image_ids = [image_ids[x] for x in order]

    nd = len(image_ids)
    tp, fp = np.zeros(nd), np.zeros(nd)
    tp_m, fp_m = np.zeros(nd), np.zeros(nd)
    for d in range(nd):
        R = class_recs[image_ids[d]]
        ovmax, jmax = -np.inf, -1
        ovmax_m, jmax_m = -np.inf, -1
        for j in range(len(R["bbox"])):
            iou = get_iou_func(BB[d].astype(float), R["bbox"][j].astype(float))
            if iou > ovmax:
                ovmax, jmax = iou, j
            iou_m = get_iou_mesh(meshes[d], R["mesh"][j])
            if iou_m > ovmax_m:
                ovmax_m, jmax_m = iou_m, j
        if ovmax > ovthresh and not R["det"][jmax]:
            tp[d] = 1.0
            R["det"][jmax] = True
        else:
            fp[d] = 1.0
        if ovmax_m > ovthresh and not R["det_mesh"][jmax_m]:
            tp_m[d] = 1.0
            R["det_mesh"][jmax_m] = True
        else:
            fp_m[d] = 1.0

    def pr(tp, fp):
        fp, tp = np.cumsum(fp), np.cumsum(tp)
        rec = tp / float(max(npos, 1))
        prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        return rec, prec, voc_ap(rec, prec, use_07_metric)

    return pr(tp, fp), pr(tp_m, fp_m)


def eval_det_w_mesh(pred_all, gt_all, ovthresh=0.25, use_07_metric=False):
    """Per-class dual AP over all scans.

    pred_all: {img_id: [(cls, bbox, score, voxels)]};
    gt_all: {img_id: [(cls, bbox, voxels)]}.
    """
    pred, gt = {}, {}
    for img_id in pred_all.keys():
        for cls, bbox, score, vox in pred_all[img_id]:
            pred.setdefault(cls, {}).setdefault(img_id, []).append(
                (bbox, score, vox)
            )
    for img_id in gt_all.keys():
        for cls, bbox, vox in gt_all[img_id]:
            gt.setdefault(cls, {}).setdefault(img_id, []).append((bbox, vox))

    rec, prec, ap = {}, {}, {}
    rec_m, prec_m, ap_m = {}, {}, {}
    for cls in gt.keys():
        (rec[cls], prec[cls], ap[cls]), (rec_m[cls], prec_m[cls], ap_m[cls]) = (
            eval_det_cls_w_mesh(pred.get(cls, {}), gt[cls], ovthresh,
                                use_07_metric)
        )
    return (rec, prec, ap), (rec_m, prec_m, ap_m)
