"""Voxel-occupancy ("mesh") AP of the port against the JAX package, on the
CPU: ``voxelize_box`` index sets, ``compute_mesh_iou``, ``eval_det_w_mesh``
and ``APCalculator.compute_metrics_w_mesh`` on the cases of
tests/test_voxels.py and on jittered scans, and the ``eval_mesh_ap`` test
runner against the JAX package's voxelized AP path (parse, assembly, each
distinct box voxelized once, ``compute_metrics_w_mesh``) fed the port's
``generate`` outputs of the same batches."""

import numpy as np
import pytest
import torch

from pose2room_tpu.eval import ap as jax_ap
from pose2room_tpu.eval import voxels as jax_voxels
from pose2room_tpu_torch.config.loader import CONFIG
from pose2room_tpu_torch.data import synth
from pose2room_tpu_torch.data.dataset import SceneDataset
from pose2room_tpu_torch.data.loader import collate
from pose2room_tpu_torch.eval import ap, voxels
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
from pose2room_tpu_torch.ops.boxes import get_3d_box
from pose2room_tpu_torch.runners import test as test_runner
from torch_port_util import SMALL, jax_test_metrics, small_test_config, to_numpy

BOXES = [  # (box, voxel size): params (center, size, heading) or corners
    (np.array([1.0, 1.0, 1.0, 0.8, 0.8, 0.8, 0.0]), 0.1),
    (np.array([0, 0, 0, 1, 1, 1, 0.3]), 0.1),
    (np.array([0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0]), 0.05),
    (np.array([0.4, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0]), 0.05),
    (np.array([-1.3, 0.4, 2.2, 1.7, 0.6, 0.9, -2.4]), 0.0625),
    (np.array([0.01, 0.02, 0.03, 0.02, 0.02, 0.02, 0.7]), 0.0625),  # smaller than a voxel
    (get_3d_box([1.2, 0.7, 0.5], 1.1, [0.3, 0.8, -0.6]), 0.0625),
    (get_3d_box([0.4, 1.9, 0.8], -0.4, [2.0, 0.95, 1.0]), 0.1),
]


def _vox_pair(box, size):
    return voxels.voxelize_box(box, size), jax_voxels.voxelize_box(box, size)


@pytest.mark.parametrize("case", range(len(BOXES)))
def test_voxelize_box_matches_jax(case):
    box, size = BOXES[case]
    got, want = _vox_pair(box, size)
    for g, w in zip(got, want):  # internal, surface
        np.testing.assert_array_equal(g._indices, w._indices)
        assert g.voxel_size == w.voxel_size
        np.testing.assert_array_equal(g.points, w.points)
    assert (got[1].filled_count > 0) == (case != 5)


def test_compute_mesh_iou_matches_jax():
    """Identity, disjoint and empty occupancies, the axis-aligned pair of
    test_voxels.py and every pair of BOXES at one voxel size, within 1e-12."""
    empty = (voxels.OccupancyGrid(np.zeros((0, 3)), 0.1),) * 2
    jax_empty = (jax_voxels.OccupancyGrid(np.zeros((0, 3)), 0.1),) * 2
    v1, j1 = _vox_pair(np.array([0, 0, 0, 1, 1, 1, 0.3]), 0.1)
    v2, j2 = _vox_pair(np.array([5, 5, 5, 1, 1, 1, 0.0]), 0.1)
    assert voxels.compute_mesh_iou(v1, v1) == jax_voxels.compute_mesh_iou(j1, j1) == pytest.approx(1.0)
    assert voxels.compute_mesh_iou(v1, v2) == jax_voxels.compute_mesh_iou(j1, j2) == 0.0
    assert voxels.compute_mesh_iou(v1, empty) == jax_voxels.compute_mesh_iou(j1, jax_empty) == 0.0
    grids = [_vox_pair(box, 0.1) for box, _ in BOXES]
    positive = 0
    for a, ja in grids:
        for b, jb in grids:
            got, want = voxels.compute_mesh_iou(a, b), jax_voxels.compute_mesh_iou(ja, jb)
            assert abs(got - want) <= 1e-12
            positive += want > 0
    assert positive > len(grids)  # some pairs overlap besides the diagonal


def _mesh_scans(rng, n_scans=4, size=0.1):
    """Jittered copies of random GT boxes plus false positives, three
    classes, each entry with both packages' voxel payloads."""
    ours, theirs = ({}, {}), ({}, {})
    for scan in range(n_scans):
        preds, gts = [], []
        for _ in range(rng.randint(1, 4)):
            c, s, h = rng.randn(3), rng.rand(3) * 1.2 + 0.3, rng.rand() * 2 * np.pi - np.pi
            cls = rng.randint(0, 3)
            gts.append((cls, get_3d_box(s, h, c)))
            preds.append((cls, get_3d_box(s * rng.uniform(0.9, 1.1, 3), h + rng.randn() * 0.1,
                                          c + rng.randn(3) * 0.1), rng.rand()))
        for _ in range(rng.randint(0, 3)):
            preds.append((rng.randint(0, 3), get_3d_box(rng.rand(3) + 0.3, rng.rand(), rng.randn(3)), rng.rand()))
        for (pred_all, gt_all), vox in zip((ours, theirs), (voxels.voxelize_box, jax_voxels.voxelize_box)):
            pred_all[scan] = [(c, b, sc, vox(b, size)) for c, b, sc in preds]
            gt_all[scan] = [(c, b, vox(b, size)) for c, b in gts]
    return ours, theirs


@pytest.mark.parametrize("ovthresh", [0.1, 0.25, 0.5])
def test_eval_det_w_mesh_matches_jax(ovthresh):
    (pred_all, gt_all), (jpred, jgt) = _mesh_scans(np.random.RandomState(int(ovthresh * 100)))
    got = voxels.eval_det_w_mesh(pred_all, gt_all, ovthresh=ovthresh)
    want = jax_voxels.eval_det_w_mesh(jpred, jgt, ovthresh=ovthresh)
    assert any(v > 0 for v in want[1][2].values())
    for (rec, prec, ap_), (jrec, jprec, jap) in zip(got, want):  # box, mesh
        assert set(ap_) == set(jap)
        for cls in jap:
            np.testing.assert_allclose(rec[cls], jrec[cls], atol=1e-12, rtol=0)
            np.testing.assert_allclose(prec[cls], jprec[cls], atol=1e-12, rtol=0)
            assert abs(ap_[cls] - jap[cls]) <= 1e-12


def test_eval_det_w_mesh_perfect_predictions():
    """test_voxels.py's case: predictions equal to the GT give AP 1 in both
    metrics, in the port as in JAX."""
    rng = np.random.RandomState(0)
    ours, theirs = ({}, {}), ({}, {})
    for scan in range(3):
        boxes = []
        for _ in range(2):
            cls = int(rng.randint(0, 2))
            obb = np.concatenate([rng.randn(3), 0.5 + rng.rand(3), [0.0]])
            boxes.append((cls, get_3d_box(obb[3:6], obb[6], obb[0:3]), obb))
        for (pred_all, gt_all), vox in zip((ours, theirs), (voxels.voxelize_box, jax_voxels.voxelize_box)):
            pred_all[scan] = [(c, b, 0.9, vox(obb, 0.1)) for c, b, obb in boxes]
            gt_all[scan] = [(c, b, vox(obb, 0.1)) for c, b, obb in boxes]
    (_, _, ap_), (_, _, ap_m) = voxels.eval_det_w_mesh(*ours, ovthresh=0.25)
    (_, _, jap), (_, _, jap_m) = jax_voxels.eval_det_w_mesh(*theirs, ovthresh=0.25)
    assert ap_ == jap and ap_m == jap_m
    assert all(v == pytest.approx(1.0) for v in list(ap_.values()) + list(ap_m.values()))


def test_compute_metrics_w_mesh_matches_jax():
    """test_voxels.py's one-box calculator (mAP and mAP_mesh 1) and jittered
    scans: the same keys in the same order, values within 1e-12."""
    names = {0: "sofa", 1: "tv", 2: "bed"}
    obb = np.array([0, 0.5, 0, 1, 1, 1, 0.2])
    corners = get_3d_box(obb[3:6], obb[6], obb[0:3])
    one_box = tuple(({0: [(0, corners, 0.9, vox(obb, 0.1))]}, {0: [(0, corners, vox(obb, 0.1))]})
                    for vox in (voxels.voxelize_box, jax_voxels.voxelize_box))
    for case, (ours, theirs) in enumerate((one_box, _mesh_scans(np.random.RandomState(7), n_scans=5))):
        calc, ref = ap.APCalculator(0.25, names), jax_ap.APCalculator(0.25, names)
        calc.step(list(ours[0].values()), list(ours[1].values()))
        ref.step(list(theirs[0].values()), list(theirs[1].values()))
        got, want = calc.compute_metrics_w_mesh(), ref.compute_metrics_w_mesh()
        assert list(got) == list(want) and "sofa Average Precision_mesh" in got
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-12, k
        if case == 0:
            assert got["mAP"] == pytest.approx(1.0) and got["mAP_mesh"] == pytest.approx(1.0)


def test_eval_mesh_ap_runner_matches_jax(tmp_path):
    """The port's ``eval_mesh_ap`` sparse test run (remove_far_box off,
    metre-sized boxes, a 0.25 m lattice) against the JAX package's voxelized
    AP path on the port's ``generate`` outputs of the same batches: every
    key, the ``_mesh`` ones included, within 1e-6; the voxel and metric
    stages timed."""
    thresholds = [0.05, 0.25]
    model = P2RNet(P2RNetConfig(**SMALL, sparse_eval=True), device="cpu", generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        mu = model.detection.gmm_size.mdn.mu
        mu.fill_(2 * np.log(1.5) / mu.shape[0])
    weight = str(tmp_path / "model.pth")
    torch.save({"net": model.state_dict()}, weight)
    rng = np.random.RandomState(4)
    dataset = SceneDataset([synth.as_stored(*synth.make_scene(rng, n_objects=int(rng.randint(2, 5)), n_frames=120))
                            for _ in range(4)], num_frames=SMALL["num_frames"])
    config = small_test_config(str(tmp_path), None, thresholds, weight=weight, remove_far_box=False,
                               eval_mesh_ap=True, mesh_voxel_size=0.25)
    cfg = CONFIG(config, mode="test")
    try:
        got = test_runner.run(cfg, device="cpu", dataset=dataset)
        summary = cfg.test_summary
    finally:
        cfg.close()

    folded = model.fold_eval()
    outputs = []
    for start in (0, 2):
        batch = collate([dataset[i] for i in (start, start + 1)])
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        ep = to_numpy(model.generate(torch.from_numpy(arrays["input_joints"]), folded=folded))
        outputs.append((arrays, ep, {}))
    want, _, n_pred = jax_test_metrics(outputs, thresholds, {"remove_far_box": False}, mesh_voxel_size=0.25)
    assert n_pred > 0 and want[0.05]["mAP_mesh"] > 0
    for t in thresholds:
        assert list(got[t]) == list(want[t]) and "AR_mesh" in got[t]
        for k, v in want[t].items():
            assert abs(got[t][k] - v) <= 1e-6, (t, k, got[t][k], v)
    assert summary["voxel_seconds"] > 0 and summary["metrics_seconds"] > 0
