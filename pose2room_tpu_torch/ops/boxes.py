"""Oriented 3D box geometry: headings, corners, params, containment, IoU.

Port of pose2room_tpu/ops/boxes.py, with the reference conventions:
* heading is rotation about +Y (up); ``head2rot`` builds R with rows
  [[cos,0,-sin],[0,1,0],[sin,0,cos]] (utils/pc_utils.py:51-67) and
  ``rot2head`` = atan2(-R[0,2], R[0,0]);
* corners: vectors = diag(size/2) @ R and the 8 corners are
  center +- v0 +- v1 +- v2 in the sign order of utils/tools.py:get_box_corners.

* oriented IoU = BEV polygon-intersection area x vertical overlap
  (net_utils/box_util.py:90-118), as a fixed-size Sutherland-Hodgman clip of
  one rectangle by the other's 4 edges (at most 8 vertices), batched over
  leading dimensions.

``head2rot``, ``box_corners_from_params`` and ``points_in_obb`` take numpy
arrays or torch tensors (the parse runs them on the card); ``corners2params``,
``rot2head``, ``get_3d_box`` and the IoU functions are host numpy (the AP
evaluation runs on the host).
"""

import numpy as np
import torch

_CORNER_SIGNS = np.array(
    [
        [-1, -1, -1],
        [+1, -1, -1],
        [+1, +1, -1],
        [-1, +1, -1],
        [-1, -1, +1],
        [+1, -1, +1],
        [+1, +1, +1],
        [-1, +1, +1],
    ],
    dtype=np.float32,
)  # (8, 3) multipliers for (v0, v1, v2)


def _xp(x):
    return torch if torch.is_tensor(x) else np


def head2rot(heading):
    """heading (...,) -> R (..., 3, 3), rotation about +Y."""
    xp = _xp(heading)
    c, s = xp.cos(heading), xp.sin(heading)
    zeros, ones = xp.zeros_like(c), xp.ones_like(c)
    rows = [xp.stack([c, zeros, -s], -1), xp.stack([zeros, ones, zeros], -1), xp.stack([s, zeros, c], -1)]
    return xp.stack(rows, -2)


def rot2head(R_mat):
    """R (..., 3, 3) -> heading (...,)."""
    R_mat = np.asarray(R_mat)
    return np.arctan2(-R_mat[..., 0, 2], R_mat[..., 0, 0])


def box_corners_from_params(center, size, heading):
    """center (...,3), size (...,3) full extents, heading (...) -> (...,8,3),
    in the reference get_3d_box corner order."""
    vectors = (size[..., :, None] / 2.0) * head2rot(heading)  # diag(size/2) @ R
    if torch.is_tensor(vectors):
        signs = torch.as_tensor(_CORNER_SIGNS, dtype=vectors.dtype, device=vectors.device)
        return center[..., None, :] + torch.einsum("kv,...vc->...kc", signs, vectors)
    return center[..., None, :] + np.einsum("kv,...vc->...kc", _CORNER_SIGNS, vectors)


def corners2params(corners):
    """corners (...,8,3) -> (size (...,3), R (...,3,3), center (...,3)), host
    numpy, with the right-hand-system fixups of net_utils/box_util.py:174-205."""
    corners = np.asarray(corners)
    center = (np.max(corners, axis=-2) + np.min(corners, axis=-2)) / 2.0
    v0 = (corners[..., 1, :] - corners[..., 0, :]) / 2.0
    v1 = (corners[..., 2, :] - corners[..., 1, :]) / 2.0
    v2 = (corners[..., 4, :] - corners[..., 0, :]) / 2.0
    vectors = np.stack([v0, v1, v2], axis=-2)  # (...,3,3)
    half = np.linalg.norm(vectors, axis=-1)  # (...,3)
    box_size = half * 2.0
    R = vectors / np.maximum(half[..., None], 1e-12)
    # up vector points up
    yflip = np.where(R[..., 1, 1] < 0, -1.0, 1.0)
    R = R * np.stack([np.ones_like(yflip), yflip, np.ones_like(yflip)], axis=-1)[..., None]
    # right-handed
    zdot = np.sum(np.cross(R[..., 0, :], R[..., 1, :]) * R[..., 2, :], axis=-1)
    zflip = np.where(zdot < 0, -1.0, 1.0)
    R = R * np.stack([np.ones_like(zflip), np.ones_like(zflip), zflip], axis=-1)[..., None]
    return box_size, R, center


def points_in_obb(points, center, size, heading, margin=0.0):
    """Points inside an oriented box inflated by ``margin`` (the exact OBB
    test that replaces the reference's Delaunay ``in_hull``).

    points (..., N, 3); center (..., 3); size (..., 3) full extents;
    heading (...).  Returns bool (..., N).
    """
    xp = _xp(points)
    R = head2rot(heading)  # rows are the box axes
    local = xp.einsum("...nc,...vc->...nv", points - center[..., None, :], R)
    half = size / 2.0 + margin
    return (abs(local) <= half[..., None, :]).all(-1)


def get_3d_box(box_size, heading_angle, center):
    """Corners (8, 3) float64 of one box, the reference helper's signature
    (pc_utils.py:22)."""
    return box_corners_from_params(
        np.asarray(center, dtype=np.float64), np.asarray(box_size, dtype=np.float64),
        np.asarray(heading_angle, dtype=np.float64),
    )


# ---------------------------------------------------------------------------
# Oriented IoU (host numpy)
# ---------------------------------------------------------------------------

def _bev_rect(corners):
    """The CCW BEV rectangle of the reference clipper: corners reordered to
    [7, 6, 2, 3], reversed, their (x, z) (box_util.py:100-104).  (..., 4, 2)."""
    rect = corners[..., [7, 6, 2, 3], :][..., ::-1, :]
    return np.stack([rect[..., 0], rect[..., 2]], axis=-1)


def _clip_poly_by_edge(poly, valid, cp1, cp2):
    """One Sutherland-Hodgman step on a padded polygon.

    poly (..., P, 2) with its valid vertices packed at the front, in order;
    valid (..., P) bool; cp1, cp2 (..., 2) the clip edge.  Returns (poly',
    valid') with P' = 2P: each vertex emits the crossing point of the edge
    into it (if any), then itself if inside, which keeps the cyclic order.
    """
    n = poly.shape[-2]
    count = valid.sum(axis=-1, keepdims=True)
    idx = np.arange(n)
    prev_idx = np.broadcast_to(np.where(idx == 0, np.maximum(count - 1, 0), idx - 1), poly.shape[:-1])
    prev = np.take_along_axis(poly, prev_idx[..., None], axis=-2)
    d = cp2 - cp1

    def side(p):
        # > 0 inside (left of cp1 -> cp2), the reference's `inside`
        return d[..., 0:1] * (p[..., 1] - cp1[..., 1:2]) - d[..., 1:2] * (p[..., 0] - cp1[..., 0:1])

    s_cur, s_prev = side(poly), side(prev)
    cur_in, prev_in = s_cur > 0, s_prev > 0
    denom = s_prev - s_cur
    t = s_prev / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    inter = prev + t[..., None] * (poly - prev)
    emit_inter = valid & (cur_in ^ prev_in)
    emit_vert = valid & cur_in
    out = np.stack([inter, poly], axis=-2).reshape(poly.shape[:-2] + (2 * n, 2))
    ok = np.stack([emit_inter, emit_vert], axis=-1).reshape(valid.shape[:-1] + (2 * n,))
    return out, ok


def _compact(poly, valid, out_n):
    """Pack the valid vertices to the front in order; keep ``out_n`` slots."""
    order = np.argsort(np.where(valid, 0, 1), axis=-1, kind="stable")
    poly = np.take_along_axis(poly, order[..., None], axis=-2)
    valid = np.take_along_axis(valid, order, axis=-1)
    return poly[..., :out_n, :], valid[..., :out_n]


def _shoelace(poly, valid):
    """Area of a padded polygon (valid vertices packed at the front)."""
    count = valid.sum(axis=-1, keepdims=True)
    n = poly.shape[-2]
    idx = np.arange(n)
    nxt = np.broadcast_to(np.where(idx + 1 >= count, 0, idx + 1), poly.shape[:-1])
    pn = np.take_along_axis(poly, nxt[..., None], axis=-2)
    cross = np.where(valid, poly[..., 0] * pn[..., 1] - pn[..., 0] * poly[..., 1], 0.0)
    return 0.5 * np.abs(cross.sum(axis=-1))


def convex_quad_intersection_area(rect1, rect2):
    """Intersection area of two convex quads (..., 4, 2) in CCW order; the
    leading dimensions broadcast."""
    lead = tuple(np.broadcast_shapes(rect1.shape[:-2], rect2.shape[:-2]))
    rect1 = np.broadcast_to(rect1, lead + rect1.shape[-2:])
    rect2 = np.broadcast_to(rect2, lead + rect2.shape[-2:])
    P = 8  # most vertices of a quad clipped by a quad
    poly = np.concatenate([rect1, np.zeros(lead + (P - 4, 2), dtype=rect1.dtype)], axis=-2)
    valid = np.concatenate([np.ones(lead + (4,), dtype=bool), np.zeros(lead + (P - 4,), dtype=bool)], axis=-1)
    for e in range(4):
        poly, valid = _clip_poly_by_edge(poly, valid, rect2[..., e - 1, :], rect2[..., e, :])
        poly, valid = _compact(poly, valid, P)
    return _shoelace(poly, valid)


def box3d_iou_oriented(corners1, corners2):
    """Oriented 3D IoU between corner sets (..., 8, 3) that broadcast.
    Returns (iou3d, iou2d_bev) as net_utils/box_util.py:90-118."""
    corners1, corners2 = np.asarray(corners1), np.asarray(corners2)
    rect1, rect2 = _bev_rect(corners1), _bev_rect(corners2)
    area1 = _shoelace(rect1, np.ones(rect1.shape[:-1], dtype=bool))
    area2 = _shoelace(rect2, np.ones(rect2.shape[:-1], dtype=bool))
    inter_area = convex_quad_intersection_area(rect1, rect2)
    iou_2d = inter_area / np.maximum(area1 + area2 - inter_area, 1e-12)
    # after the reference reorder slot 0 (corner 7) is on top, slot 4 (corner 4) below
    ymax = np.minimum(corners1[..., 7, 1], corners2[..., 7, 1])
    ymin = np.maximum(corners1[..., 4, 1], corners2[..., 4, 1])
    inter_vol = inter_area * np.maximum(ymax - ymin, 0.0)

    def vol(c):
        a = np.linalg.norm(c[..., 0, :] - c[..., 1, :], axis=-1)
        b = np.linalg.norm(c[..., 1, :] - c[..., 2, :], axis=-1)
        h = np.linalg.norm(c[..., 0, :] - c[..., 4, :], axis=-1)
        return a * b * h

    iou = inter_vol / np.maximum(vol(corners1) + vol(corners2) - inter_vol, 1e-12)
    return iou, iou_2d
