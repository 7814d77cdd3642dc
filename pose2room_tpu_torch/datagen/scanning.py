"""Virtual scanning: cameras, depth back-projection, TSDF fusion.

Port of pose2room_tpu/datagen/scanning.py, numpy on the host as there:
reference utils/virtualhome/read_frames.py:12-196 plus
the camera half of vhome_utils.py (generate_cameras :294-326,
get_cam_intrinsics :328-350, get_cam_extrinsics :352-356,
pc_from_dep_by_frame :358-396, sample_points_in_box :255-272,
filter_cam_locs :285-292), with the reference's external dependencies
(external/tsdf_fusion CUDA fusion, skimage marching-cubes, trimesh voxel
export) replaced by a dependency-free numpy TSDF volume and
surface-point/occupancy extraction that feed the headless viewers
(utils/room_view.py scene_points overlay) and PLY writers (utils/vis.py).

The frame source is pluggable like the stage-2 simulator: anything with the
UnityCommunication camera surface used here —

    camera_data(frame_ids) -> (ok, [{'projection_matrix', 'world_to_camera_matrix'}])
    camera_image(frame_id, mode='depth'|'normal', image_width=, image_height=)
        -> (ok, [HxWx1 depth | HxWx3 rgb])
"""

import math

import numpy as np

from pose2room_tpu_torch.datagen.samples import check_in_box


# ---------------------------------------------------------------------------
# Cameras
# ---------------------------------------------------------------------------

def get_cam_intrinsics(projection_matrix, im_width, im_height):
    """Intrinsics from an OpenGL projection matrix (vhome_utils.py:328-350)."""
    P = np.asarray(projection_matrix, dtype=np.float64)
    z_near = P[2, 3] / (P[2, 2] - 1)
    z_far = P[2, 3] / (P[2, 2] + 1)
    c_x = np.around(im_width * (1 - P[0, 2]) / 2.0).astype(np.uint32)
    c_y = np.around((P[1, 2] + 1) * im_height / 2.0).astype(np.uint32)
    f_x = P[0, 0] / 2 * im_width
    f_y = P[1, 1] / 2 * im_height
    f_xy = P[0, 1] * im_width / -2.0
    cam_K = np.array([[f_x, f_xy, c_x], [0, f_y, c_y], [0, 0, 1]])
    return {
        "z_near": z_near,
        "z_far": z_far,
        "cam_K": cam_K,
        "fov_x": math.atan(0.5 * im_width / f_x) * 2,
        "fov_y": math.atan(0.5 * im_height / f_y) * 2,
    }


def get_cam_extrinsics(world2camera_gl):
    """GL world->camera matrix -> cam->world RT (vhome_utils.py:352-356)."""
    cam2world = np.linalg.inv(np.asarray(world2camera_gl, dtype=np.float64))
    cam2world[:3, :3] *= -1
    cam2world[:, 0] *= -1
    return cam2world


def pc_from_depth(depth_map, cam_K, cam2world_RT, rgb_img=None, far_clip=15.0,
                  sample_rate=1):
    """Back-project one depth map to a world-space point cloud
    (vhome_utils.py:358-396)."""
    h, w = depth_map.shape
    u, v = np.meshgrid(range(0, w, sample_rate), range(0, h, sample_rate))
    u = u.reshape(-1)
    v = v.reshape(-1)
    z = depth_map[v, u]
    keep = np.logical_and(z < far_clip, z > 0.0)
    u, v, z = u[keep], v[keep], z[keep]
    colors = (
        rgb_img[v, u]
        if isinstance(rgb_img, np.ndarray) and rgb_img.shape[:2] == depth_map.shape[:2]
        else np.empty((len(z), 0))
    )
    x = (u - cam_K[0][2]) * z / cam_K[0][0]
    y = (v - cam_K[1][2]) * z / cam_K[1][1]
    pts_cam = np.stack([x, y, z], axis=1)
    pts_world = pts_cam.dot(cam2world_RT[:3, :3].T) + cam2world_RT[:3, 3]
    return pts_world, colors


def sample_points_in_box(box, step_len=1.0, padding=0.0):
    """Regular grid of points inside an oriented box (vhome_utils.py:255-272)."""
    centroid = np.asarray(box["centroid"], dtype=np.float64)
    size = np.asarray(box["size"], dtype=np.float64) + padding
    R = np.asarray(box["R_mat"], dtype=np.float64)
    vectors = np.diag(size / 2.0).dot(R)
    corner = centroid - vectors[0] - vectors[1] - vectors[2]
    axes = [np.arange(step_len, s, step_len) for s in size]
    if any(len(a) == 0 for a in axes):
        return np.zeros((0, 1, 3))
    cx, cy, cz = np.meshgrid(*axes, indexing="ij")
    local = np.stack([cx, cy, cz]).reshape(3, -1).T[:, None]  # (n,1,3)
    return np.matmul(local, np.tile(R, (local.shape[0], 1, 1))) + corner


def filter_cam_locs(cam_locs, boxes):
    """Drop camera locations inside any object bbox (vhome_utils.py:285-292)."""
    inside = np.zeros(cam_locs.shape[:-1], dtype=bool)
    for box in boxes:
        inside |= check_in_box(cam_locs, box)
    return cam_locs[~inside[:, 0]]


def generate_cameras(room_bbox, object_boxes, loc_step=1.5, padding=1.0,
                     angle_step=90):
    """Camera positions (room grid minus object interiors) + pitch/yaw pairs
    (vhome_utils.py:294-326; roll fixed to zero)."""
    cam_locs = sample_points_in_box(room_bbox, loc_step, padding=padding)
    cam_locs = filter_cam_locs(cam_locs, object_boxes)
    pitches = np.linspace(-90, 90, 180 // angle_step + 2)[1:-1]
    yaws = np.arange(-180.0, 180.0, angle_step)
    pairs = np.array(np.meshgrid(pitches, yaws)).reshape(2, -1).T
    pairs = np.vstack([pairs, [[-90.0, 0.0], [90.0, 0.0]]])
    return cam_locs, pairs


# ---------------------------------------------------------------------------
# TSDF fusion (numpy port of external/tsdf_fusion used by read_frames.py)
# ---------------------------------------------------------------------------

def get_view_frustum(depth_map, cam_K, cam2world_RT):
    """(3, 5) world-space frustum corner points of one view."""
    h, w = depth_map.shape
    zmax = float(depth_map.max())
    corners_px = np.array([[0, 0, w, w], [0, h, 0, h]], dtype=np.float64)
    x = (corners_px[0] - cam_K[0][2]) * zmax / cam_K[0][0]
    y = (corners_px[1] - cam_K[1][2]) * zmax / cam_K[1][1]
    pts_cam = np.concatenate(
        [np.zeros((3, 1)), np.stack([x, y, np.full(4, zmax)])], axis=1
    )  # camera origin + 4 far corners
    return cam2world_RT[:3, :3].dot(pts_cam) + cam2world_RT[:3, 3:4]


class TSDFVolume:
    """Truncated signed distance volume with weighted running integration."""

    def __init__(self, vol_bnds, voxel_size, trunc_margin=None):
        vol_bnds = np.asarray(vol_bnds, dtype=np.float64)
        self.voxel_size = float(voxel_size)
        self.trunc = float(trunc_margin or 5 * voxel_size)
        self.origin = vol_bnds[:, 0].copy()
        self.dims = np.ceil(
            (vol_bnds[:, 1] - vol_bnds[:, 0]) / voxel_size
        ).astype(int)
        self.dims = np.maximum(self.dims, 1)
        self.tsdf = np.ones(self.dims, dtype=np.float32)
        self.weight = np.zeros(self.dims, dtype=np.float32)
        self.color = np.zeros(self.dims, dtype=np.float32)
        self._color_const = 256.0 * 256.0

    # big scans (view frusta at far_clip can span tens of meters) produce
    # 1e7..1e8 voxels: voxel centers are NOT persisted (a float64 (n_vox, 3)
    # table would be GBs of host RAM) but derived per chunk from the flat
    # index, in float32, bounding the transient working set
    _CHUNK = 1 << 22

    def _chunk_centers(self, start, stop):
        flat = np.arange(start, stop, dtype=np.int64)
        d1, d2 = int(self.dims[1]), int(self.dims[2])
        i = flat // (d1 * d2)
        rem = flat - i * (d1 * d2)
        idx = np.stack([i, rem // d2, rem % d2], axis=-1)
        return (idx.astype(np.float32) + 0.5) * np.float32(
            self.voxel_size
        ) + self.origin.astype(np.float32)

    def integrate(self, depth_map, cam_K, cam2world_RT, rgb_img=None,
                  obs_weight=1.0):
        """Fuse one depth frame into the volume."""
        n_vox = int(np.prod(self.dims))
        for start in range(0, n_vox, self._CHUNK):
            self._integrate_chunk(
                start, min(start + self._CHUNK, n_vox),
                depth_map, cam_K, cam2world_RT, rgb_img, obs_weight,
            )

    def _integrate_chunk(self, start, stop, depth_map, cam_K, cam2world_RT,
                         rgb_img, obs_weight):
        world2cam = np.linalg.inv(cam2world_RT)
        centers = self._chunk_centers(start, stop)
        pts_cam = centers.dot(
            world2cam[:3, :3].T.astype(np.float32)
        ) + world2cam[:3, 3].astype(np.float32)
        z = pts_cam[:, 2]
        h, w = depth_map.shape
        with np.errstate(divide="ignore", invalid="ignore"):
            u = np.round(pts_cam[:, 0] * cam_K[0][0] / z + cam_K[0][2]).astype(int)
            v = np.round(pts_cam[:, 1] * cam_K[1][1] / z + cam_K[1][2]).astype(int)
        valid = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        depth = np.zeros(len(z), dtype=np.float32)
        depth[valid] = depth_map[v[valid], u[valid]]
        sdf = depth - z
        update = valid & (depth > 0) & (sdf >= -self.trunc)
        tsdf_new = np.minimum(1.0, sdf / self.trunc)

        flat_idx = np.flatnonzero(update) + start
        w_old = self.weight.reshape(-1)[flat_idx]
        w_new = w_old + obs_weight
        t_old = self.tsdf.reshape(-1)[flat_idx]
        self.tsdf.reshape(-1)[flat_idx] = (
            w_old * t_old + obs_weight * tsdf_new[flat_idx - start]
        ) / w_new
        self.weight.reshape(-1)[flat_idx] = w_new
        if isinstance(rgb_img, np.ndarray):
            rgb = rgb_img[v[flat_idx - start], u[flat_idx - start]].astype(np.float64)
            packed = (
                rgb[:, 2] * self._color_const + rgb[:, 1] * 256.0 + rgb[:, 0]
            )
            c_old = self.color.reshape(-1)[flat_idx]
            b = np.floor(c_old / self._color_const)
            g = np.floor((c_old - b * self._color_const) / 256)
            r = c_old - b * self._color_const - g * 256
            nb = np.floor(packed / self._color_const)
            ng = np.floor((packed - nb * self._color_const) / 256)
            nr = packed - nb * self._color_const - ng * 256
            b = np.minimum(255.0, np.round((w_old * b + obs_weight * nb) / w_new))
            g = np.minimum(255.0, np.round((w_old * g + obs_weight * ng) / w_new))
            r = np.minimum(255.0, np.round((w_old * r + obs_weight * nr) / w_new))
            self.color.reshape(-1)[flat_idx] = b * self._color_const + g * 256 + r

    def get_volume(self):
        return self.tsdf, self.color

    def surface_points(self, level=0.6):
        """World-space centers of observed near-surface voxels — the headless
        stand-in for marching-cubes mesh extraction (read_frames.py:14)."""
        mask = (self.weight.reshape(-1) > 0) & (
            np.abs(self.tsdf.reshape(-1)) < level * (self.voxel_size / self.trunc) * 5
        )
        flat = np.flatnonzero(mask)
        d1, d2 = int(self.dims[1]), int(self.dims[2])
        i = flat // (d1 * d2)
        rem = flat - i * (d1 * d2)
        idx = np.stack([i, rem // d2, rem % d2], axis=-1)
        return (idx.astype(np.float64) + 0.5) * self.voxel_size + self.origin


def read_frames(camera_source, frame_ids, *, im_size=(640, 480), far_clip=15.0,
                voxel_size=0.0625, pixel_sample_rate=1):
    """Scan a scene: per-frame camera data + depth -> fused TSDF, scene
    voxels, and world point clouds (read_frames.py:146-193).

    Args:
        camera_source: pluggable Unity-comm camera surface (module docstring).
        frame_ids: frames to fuse.
    Returns:
        dict with tsdf (TSDFVolume), points_world {'pc', 'cam', 'color'},
        scene_vox (bool grid), vol_origin.
    """
    w, h = im_size
    _, cam_data = camera_source.camera_data(frame_ids)
    cam_Ks, cam_RTs, depths, rgbs = [], [], [], []
    vol_bnds = None
    for idx, frame_id in enumerate(frame_ids):
        P = np.asarray(cam_data[idx]["projection_matrix"]).reshape(4, 4, order="F")
        W2C = np.asarray(cam_data[idx]["world_to_camera_matrix"]).reshape(
            4, 4, order="F"
        )
        cam_K = get_cam_intrinsics(P, w, h)["cam_K"]
        cam_RT = get_cam_extrinsics(W2C)
        _, depth = camera_source.camera_image(
            frame_id, mode="depth", image_width=w, image_height=h
        )
        depth = np.asarray(depth[0])[..., 0].copy()
        depth[depth > far_clip] = 0
        if depth.max() <= 0:
            # every pixel beyond far_clip: the frustum would degenerate to a
            # single point and pollute vol_bnds — the frame contributes
            # nothing, skip it entirely
            continue
        frust = get_view_frustum(depth, cam_K, cam_RT)
        lo, hi = frust.min(axis=1), frust.max(axis=1)
        if vol_bnds is None:
            vol_bnds = np.stack([lo, hi], axis=1)
        else:
            vol_bnds[:, 0] = np.minimum(vol_bnds[:, 0], lo)
            vol_bnds[:, 1] = np.maximum(vol_bnds[:, 1], hi)
        try:
            _, rgb = camera_source.camera_image(
                frame_id, mode="normal", image_width=w, image_height=h
            )
            rgb = np.asarray(rgb[0])[..., [2, 1, 0]]
        except Exception:
            rgb = None
        cam_Ks.append(cam_K)
        cam_RTs.append(cam_RT)
        depths.append(depth)
        rgbs.append(rgb)

    if vol_bnds is None:
        raise ValueError(
            "read_frames: no frame has any depth within far_clip="
            f"{far_clip} — nothing to fuse"
        )
    # pad the upper bound so points exactly on the far boundary (e.g. a wall
    # at the max observed depth) still land inside the voxel grid
    vol_bnds[:, 1] += voxel_size
    tsdf = TSDFVolume(vol_bnds, voxel_size)
    for cam_K, cam_RT, depth, rgb in zip(cam_Ks, cam_RTs, depths, rgbs):
        tsdf.integrate(depth, cam_K, cam_RT, rgb_img=rgb)

    scene_vox = np.zeros(tsdf.dims, dtype=bool)
    point_list, cam_list = [], []
    for cam_K, cam_RT, depth in zip(cam_Ks, cam_RTs, depths):
        pts, _ = pc_from_depth(
            depth, cam_K, cam_RT, far_clip=far_clip, sample_rate=pixel_sample_rate
        )
        vox = ((pts - tsdf.origin) / voxel_size).astype(int)
        ok = np.all((vox >= 0) & (vox < tsdf.dims), axis=1)
        vox = vox[ok]
        scene_vox[vox[:, 0], vox[:, 1], vox[:, 2]] = True
        point_list.append(pts)
        cam_list.append({"cam_RT": cam_RT, "cam_K": cam_K})

    return {
        "tsdf": tsdf,
        "points_world": {"pc": point_list, "cam": cam_list},
        "scene_vox": scene_vox,
        "vol_origin": tsdf.origin,
    }
