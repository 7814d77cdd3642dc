"""Headless room viewer: matplotlib renders of rooms, boxes, and skeletons.

Port of pose2room_tpu/utils/room_view.py, numpy float64 on the host;
matplotlib and h5py are imported by the functions that use them.  It renders
what the reference's interactive VTK room viewers show —
utils/virtualhome/vis_vhome.py (VIS_HOME: room bbox, class-colored instance
boxes, time-colored movement trajectory, skeleton snapshots, scene point
cloud), vis_bbox_sk.py (boxes + skeleton), and the scene-overlay half of
vis_results.py:212-249 (GT read from the sample HDF5, predictions from the
dumped ``*_pred_confident_nms_bbox.npz``) — re-targeted at headless
environments: everything renders to a PNG through the Agg backend instead of
a vtkRenderWindow.
"""

import numpy as np

from pose2room_tpu_torch.config.dataset_config import CLASS_LABELS, SKELETON_EDGES
from pose2room_tpu_torch.ops.boxes import box_corners_from_params, rot2head
from pose2room_tpu_torch.utils.vis import BOX_EDGES


def read_sample_scene(path):
    """GT scene content from a sample HDF5 (vis_results.py:read_gt parity).

    Returns (object_nodes, room_bbox, skeleton_joints)."""
    import h5py

    with h5py.File(path, "r") as f:
        room_bbox = {k: f["room_bbox"][k][:] for k in f["room_bbox"].keys()}
        joints = f["skeleton_joints"][:]
        nodes = []
        for key in sorted(f["object_nodes"].keys(), key=int):
            node = f["object_nodes"][key]
            nodes.append(
                {
                    "class_id": int(np.asarray(node["class_id"]).reshape(-1)[0]),
                    "centroid": node["centroid"][:],
                    "size": node["size"][:],
                    "R_mat": node["R_mat"][:],
                }
            )
    return nodes, room_bbox, joints


def get_even_dist_joints(skeleton_joints, skip_rates):
    """Frame ids evenly spaced by MOVEMENT DISTANCE, not time — the pose
    subsampling the reference demo/GT viewers display
    (vis_gt_vh.py:24-31)."""
    frame_num = skeleton_joints.shape[0] // skip_rates + 1
    move = np.linalg.norm(np.diff(skeleton_joints[:, 0], axis=0), axis=1)
    cum = np.cumsum(np.hstack([[0], move]))
    target = np.linspace(0, move.sum(), frame_num)
    return np.argmin(np.abs(cum[:, None] - target), axis=0)


def dist_node2bbox(nodes, joint_coordinates, joint_num):
    """For each object, the frame whose pose is deepest inside (or nearest)
    its bbox — the "interaction frame" picker (vis_gt_vh.py:14-22)."""
    sk_ids = []
    for node in nodes:
        vecs = joint_coordinates - np.asarray(node["centroid"])
        off = np.abs(vecs.dot(np.asarray(node["R_mat"]).T)) - (
            np.asarray(node["size"]) / 2.0
        )
        dists = off.max(axis=-1).reshape(-1, joint_num).max(axis=-1)
        sk_ids.append(int(dists.argmin()))
    return np.sort(sk_ids)


def class_palette(n=len(CLASS_LABELS)):
    """Evenly-spaced hue palette (stand-in for seaborn hls)."""
    import matplotlib.cm as cm

    return cm.hsv(np.linspace(0.0, 0.92, n))


def node_corners(node):
    heading = rot2head(np.asarray(node["R_mat"], dtype=np.float64))
    return box_corners_from_params(
        np.asarray(node["centroid"], dtype=np.float64),
        np.asarray(node["size"], dtype=np.float64),
        heading,
    )


def draw_box_corners(ax, corners, color, label=None, linewidth=1.2):
    for a, b in BOX_EDGES:
        ax.plot(*zip(corners[a], corners[b]), color=color, linewidth=linewidth)
    if label is not None:
        center = corners.mean(0)
        ax.text(*center, label, fontsize=7, color=color)


def draw_room(ax, room_bbox):
    """Room wireframe + shaded floor polygon (vis_vhome.py room_bbox actor)."""
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    centroid = np.asarray(room_bbox["centroid"], dtype=np.float64)
    size = np.asarray(room_bbox["size"], dtype=np.float64)
    R = np.asarray(room_bbox["R_mat"], dtype=np.float64)
    heading = rot2head(R)
    corners = box_corners_from_params(centroid, size, heading)
    draw_box_corners(ax, corners, color="0.6", linewidth=0.8)
    floor = corners[corners[:, 1] < centroid[1]]
    if len(floor) == 4:
        # order the floor quad by angle around its center
        c = floor.mean(0)
        order = np.argsort(np.arctan2(floor[:, 2] - c[2], floor[:, 0] - c[0]))
        ax.add_collection3d(
            Poly3DCollection([floor[order]], facecolor="0.9", alpha=0.4)
        )
    return corners


def draw_trajectory(ax, hips, cmap_name="Spectral_r"):
    """Movement trajectory colored by time (vis_vhome.py traj_palette)."""
    import matplotlib.cm as cm

    hips = np.asarray(hips)
    colors = getattr(cm, cmap_name)(np.linspace(0, 1, max(len(hips) - 1, 1)))
    for i in range(len(hips) - 1):
        ax.plot(*zip(hips[i], hips[i + 1]), color=colors[i], linewidth=1.0)


def draw_skeleton(ax, frame_joints, color, linewidth=0.7):
    """One skeleton pose as its limb segments (vis_bbox_sk.py equivalent)."""
    for a, b in SKELETON_EDGES:
        ax.plot(*zip(frame_joints[a], frame_joints[b]),
                color=color, linewidth=linewidth)


def draw_points(ax, points, max_points=4000, color="0.5", size=0.4):
    """Scene point-cloud overlay, subsampled (vis_vhome.py point_cloud)."""
    points = np.asarray(points).reshape(-1, 3)
    if len(points) > max_points:
        idx = np.linspace(0, len(points) - 1, max_points).astype(int)
        points = points[idx]
    ax.scatter(points[:, 0], points[:, 1], points[:, 2],
               s=size, c=color, alpha=0.5, linewidths=0)


def render_room(
    out_path,
    *,
    room_bbox=None,
    gt_nodes=(),
    pred_obbs=None,
    pred_cls=None,
    joints=None,
    scene_points=None,
    skeleton_every=0,
    title=None,
):
    """One-call headless composition of the reference room viewers.

    Args:
        room_bbox: {centroid,size,R_mat} or None.
        gt_nodes: instance dicts (class_id/centroid/size/R_mat), drawn with
            the per-class palette like VIS_HOME's 'bboxes' mode.
        pred_obbs/pred_cls: (n,7) center/size/heading params + class ids from
            a prediction dump, drawn dashed-red-labelled like vis_results.
        joints: (F,53,3) clip — hip trajectory (time-colored) plus skeleton
            snapshots every ``skeleton_every`` frames (0 = trajectory only).
        scene_points: optional (N,3) scene geometry overlay.
    Returns the Axes3D (after saving to ``out_path``).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.cm as cm
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    palette = class_palette()

    if scene_points is not None:
        draw_points(ax, scene_points)
    if room_bbox is not None:
        draw_room(ax, room_bbox)
    for node in gt_nodes:
        cls = int(node["class_id"])
        draw_box_corners(ax, node_corners(node), palette[cls], CLASS_LABELS[cls])
    if pred_obbs is not None:
        pred_obbs = np.asarray(pred_obbs).reshape(-1, 7)
        for i, obb in enumerate(pred_obbs):
            corners = box_corners_from_params(obb[0:3], obb[3:6], obb[6])
            label = (
                CLASS_LABELS[int(pred_cls[i])] if pred_cls is not None else None
            )
            draw_box_corners(ax, corners, "tab:red", label)
    if joints is not None:
        joints = np.asarray(joints)
        draw_trajectory(ax, joints[:, 0])
        if skeleton_every > 0:
            # evenly spaced by movement distance, like the reference viewers
            frames = get_even_dist_joints(joints, skeleton_every)
            colors = cm.Spectral_r(np.linspace(0, 1, max(len(frames), 1)))
            for c, fidx in zip(colors, frames):
                draw_skeleton(ax, joints[fidx], c)

    if title:
        ax.set_title(title)
    ax.view_init(elev=35, azim=-60)
    try:
        ax.set_aspect("equal")
    except NotImplementedError:
        pass
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path
