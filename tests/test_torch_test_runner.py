"""The port's AP stack and test runner against the JAX package, on the CPU:
oriented IoU (numpy and native), AP matching, GT parsing, and
``runners/test.run`` with ``sparse_eval`` against the JAX test path composed
from ``generate``, the parse, the loss and ``APCalculator`` on one synthetic
split with the same weights."""

import glob
import os

import numpy as np
import pytest
import torch
import yaml

import jax

from pose2room_tpu import native as jax_native
from pose2room_tpu.config.dataset_config import DatasetConfig as JaxDatasetConfig
from pose2room_tpu.data import P2RNetDataset as JaxP2RNetDataset
from pose2room_tpu.data.loader import collate as jax_collate
from pose2room_tpu.eval import ap as jax_ap
from pose2room_tpu.eval import parse as jax_parse
from pose2room_tpu.eval import voxels as jax_voxels
from pose2room_tpu.models import P2RNet as JaxP2RNet
from pose2room_tpu.models.loss import detection_loss as jax_detection_loss
from pose2room_tpu.ops import boxes as jax_boxes
from pose2room_tpu_torch import __main__ as cli
from pose2room_tpu_torch import native
from pose2room_tpu_torch.config.loader import CONFIG
from pose2room_tpu_torch.convert import state_dict_from_flax
from pose2room_tpu_torch.data.synth import write_synthetic_dataset
from pose2room_tpu_torch.eval import ap, parse, voxels
from pose2room_tpu_torch.ops import boxes
from pose2room_tpu_torch.runners import test as test_runner
from torch_port_util import SMALL, flax_payload, jax_model, jax_test_metrics, small_test_config

THRESHOLDS = [0.05, 0.25, 0.5]


def _random_box(rng, spread=2.0):
    size = rng.rand(3) * 1.5 + 0.3
    heading = rng.rand() * 2 * np.pi - np.pi
    center = rng.randn(3) * spread
    return boxes.get_3d_box(size, heading, center), (center, size, heading)


def _random_corners(rng, n, spread=1.0):
    return np.stack([_random_box(rng, spread)[0] for _ in range(n)])


def test_get_3d_box_matches_jax(rng):
    for _ in range(5):
        size, heading, center = rng.rand(3) + 0.2, rng.rand() * 6 - 3, rng.randn(3)
        np.testing.assert_array_equal(boxes.get_3d_box(size, heading, center),
                                      jax_boxes.get_3d_box(size, heading, center))


def test_box3d_iou_oriented_matches_jax(rng):
    a = _random_corners(rng, 12, spread=0.8)
    b = _random_corners(rng, 9, spread=0.8)
    b[:3] = a[:3]  # identical boxes: IoU 1
    iou, iou2d = boxes.box3d_iou_oriented(a[:, None], b[None])
    ref, ref2d = jax_boxes.box3d_iou_oriented(a[:, None], b[None], xp=np)
    assert iou.shape == (12, 9) and 0 < (iou > 0).sum() < iou.size
    np.testing.assert_allclose(iou, ref, atol=1e-9, rtol=0)
    np.testing.assert_allclose(iou2d, ref2d, atol=1e-9, rtol=0)
    np.testing.assert_allclose(np.diag(iou[:3, :3]), 1.0, atol=1e-9)


def test_native_iou_matches_jax(rng):
    dets, gts = _random_corners(rng, 20), _random_corners(rng, 15)
    ref = jax_native.oriented_iou_matrix(dets, gts)
    assert native.path() == ("native" if jax_native.available() else "numpy")
    np.testing.assert_allclose(native.oriented_iou_matrix(dets, gts), ref, atol=1e-9, rtol=0)
    np.testing.assert_allclose(native.oriented_iou_matrix_numpy(dets, gts), ref, atol=1e-9, rtol=0)
    assert native.oriented_iou_matrix(dets[:0], gts).shape == (0, 15)


def _scans(rng, n_scans=4):
    """Jittered-GT scans as tests/test_eval.py:94-129: noisy copies of each GT
    box plus false positives, three classes."""
    pred_all, gt_all = {}, {}
    for scan in range(n_scans):
        gts, preds = [], []
        for _ in range(rng.randint(1, 5)):
            corners, (c, s, h) = _random_box(rng, spread=1.0)
            cls = rng.randint(0, 3)
            gts.append((cls, corners))
            noisy = boxes.get_3d_box(s * rng.uniform(0.8, 1.2, 3), h + rng.randn() * 0.2, c + rng.randn(3) * 0.3)
            preds.append((cls, noisy, rng.rand()))
        for _ in range(rng.randint(0, 3)):
            preds.append((rng.randint(0, 3), _random_box(rng, spread=1.0)[0], rng.rand()))
        pred_all[scan], gt_all[scan] = preds, gts
    return pred_all, gt_all


@pytest.mark.parametrize("ovthresh", [0.1, 0.25, 0.5])
def test_eval_det_matches_jax(ovthresh):
    pred_all, gt_all = _scans(np.random.RandomState(int(ovthresh * 100)))
    rec, prec, ap_ = ap.eval_det(pred_all, gt_all, ovthresh=ovthresh)
    ref_rec, ref_prec, ref_ap = jax_ap.eval_det(pred_all, gt_all, ovthresh=ovthresh)
    assert set(ap_) == set(ref_ap) and any(v > 0 for v in ap_.values())
    for cls in ref_ap:
        np.testing.assert_allclose(rec[cls], ref_rec[cls], atol=1e-12, rtol=0)
        np.testing.assert_allclose(prec[cls], ref_prec[cls], atol=1e-12, rtol=0)
        assert abs(ap_[cls] - ref_ap[cls]) <= 1e-12


def test_ap_calculator_matches_jax():
    pred_all, gt_all = _scans(np.random.RandomState(5), n_scans=6)
    names = JaxDatasetConfig().class2type
    ours, ref = ap.APCalculator(0.25, names), jax_ap.APCalculator(0.25, names)
    for calc in (ours, ref):
        calc.step([pred_all[i] for i in range(3)], [gt_all[i] for i in range(3)])
        calc.step([pred_all[i] for i in range(3, 6)], [gt_all[i] for i in range(3, 6)])
    ours.synchronize_between_processes()  # one process: a no-op
    got, want = ours.compute_metrics(), ref.compute_metrics()
    assert list(got) == list(want) and ours.scan_cnt == 6
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-12, k
    # the mesh path: the same scans with each package's voxel payloads
    ours, ref = ap.APCalculator(0.25, names), jax_ap.APCalculator(0.25, names)
    for calc, vox in ((ours, voxels.voxelize_box), (ref, jax_voxels.voxelize_box)):
        calc.step([[(c, b, s, vox(b, 0.1)) for c, b, s in pred_all[i]] for i in range(6)],
                  [[(c, b, vox(b, 0.1)) for c, b in gt_all[i]] for i in range(6)])
    got, want = ours.compute_metrics_w_mesh(), ref.compute_metrics_w_mesh()
    assert list(got) == list(want) and "mAP_mesh" in got and want["mAP_mesh"] > 0
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-12, k


def test_perfect_predictions_map_one(rng):
    calc = ap.APCalculator(ap_iou_thresh=0.5)
    for _ in range(3):
        gts, preds = [], []
        for _ in range(4):
            corners, _ = _random_box(rng)
            cls = rng.randint(0, 5)
            gts.append((cls, corners))
            preds.append((cls, corners, 0.9))
        calc.step([preds], [gts])
    metrics = calc.compute_metrics()
    assert abs(metrics["mAP"] - 1.0) < 1e-9 and abs(metrics["AR"] - 1.0) < 1e-9


def test_parse_groundtruths_matches_jax(rng):
    B, K2 = 2, 10
    h = rng.rand(B, K2) * 2 - 1
    gt = {
        "center_label": rng.randn(B, K2, 3).astype(np.float32),
        "size": (rng.rand(B, K2, 3) * 0.6 - 0.5).astype(np.float32),
        "heading": np.stack([np.sin(h), np.cos(h)], -1).astype(np.float32),
        "box_label_mask": (np.arange(K2)[None] < np.array([[4], [7]])).astype(np.float32),
        "sem_cls_label": rng.randint(0, 22, (B, K2)),
    }
    ref = jax_parse.parse_groundtruths(gt)
    got = parse.parse_groundtruths(gt)
    np.testing.assert_allclose(got["gt_corners_3d"], ref["gt_corners_3d"], atol=1e-5, rtol=0)
    assert np.all(got["gt_corners_3d"][0, 4:] == 0) and np.all(got["gt_corners_3d"][1, 7:] == 0)
    # the device half dispatched ahead gives the same result
    corners = parse.gt_corners(*(torch.from_numpy(gt[k]) for k in ("center_label", "size", "heading")))
    np.testing.assert_array_equal(parse.parse_groundtruths(gt, corners=corners)["gt_corners_3d"],
                                  got["gt_corners_3d"])
    ours, want = parse.assembly_gt_map_cls(got), jax_parse.assembly_gt_map_cls(ref)
    assert [len(s) for s in ours] == [4, 7]
    assert [[c for c, _ in s] for s in ours] == [[c for c, _ in s] for s in want]


# ---------------------------------------------------------------------------
# The test runner against the JAX test path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("split")
    write_synthetic_dataset(str(root / "dataset"), n_train=1, n_test=4, n_frames=120, seed=3)
    return str(root / "dataset" / "splits" / "script_level")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One seeded flax payload: the JAX variables and the same weights as a
    reference-layout checkpoint for the port's ``finetune``."""
    payload = flax_payload(SMALL["num_gaussian"], seed=11)
    # the size head's mixture means (pi-weighted, pi ~ 0.5) set so that the
    # random model's boxes are ~1.5 m wide and some overlap the GT: AP > 0
    gmm = payload["params"]["detection"]["gmm_size"]
    gmm["mu"] = np.full_like(gmm["mu"], 2 * np.log(1.5) / SMALL["num_gaussian"])
    path = str(tmp_path_factory.mktemp("weights") / "model.pth")
    torch.save({"net": state_dict_from_flax(payload)}, path)
    return {"params": payload["params"], "batch_stats": payload["batch_stats"]}, path


@pytest.fixture(scope="module")
def jax_outputs(split, weights):
    """The JAX package's sparse generate and loss on the test split, batches
    of 2 in split order."""
    variables, _ = weights
    ds = JaxP2RNetDataset(os.path.join(split, "test.json"), num_frames=SMALL["num_frames"])
    model = jax_model(SMALL, sparse_eval=True)
    generate = jax.jit(lambda v, x: model.apply(v, x, method=JaxP2RNet.generate))
    out = []
    for start in (0, 2):
        batch = jax_collate([ds[i] for i in (start, start + 1)])
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        ep = jax.tree_util.tree_map(np.asarray, generate(variables, arrays["input_joints"]))
        losses = jax_detection_loss({k: v for k, v in ep.items() if k != "pi"}, arrays, 0)
        out.append((arrays, ep, {k: float(v) for k, v in losses.items()}))
    return out


@pytest.mark.parametrize("remove_far_box", [True, False])
def test_test_runner_matches_jax(tmp_path, split, weights, jax_outputs, remove_far_box):
    """Per-class AP and recall, mAP and AR equal within 1e-6; mean losses
    within 1e-4 relative.  With remove_far_box off the random weights' boxes
    survive the pruning, so the prediction maps are not empty."""
    config = small_test_config(str(tmp_path), split, THRESHOLDS, weight=weights[1],
                               remove_far_box=remove_far_box)
    config["generation"]["dump_results"] = not remove_far_box
    cfg = CONFIG(config, mode="test")
    try:
        got = test_runner.run(cfg, device="cpu")
        summary = cfg.test_summary
        vis_path = cfg.config["log"]["vis_path"]
    finally:
        cfg.close()
    want, want_losses, n_pred = jax_test_metrics(jax_outputs, THRESHOLDS, {"remove_far_box": remove_far_box})
    if not remove_far_box:
        assert n_pred > 0
        dumps = sorted(glob.glob(os.path.join(vis_path, "test_*")))
        assert len(dumps) == 2
        assert all(os.path.isfile(os.path.join(d, "000000_gt_bbox.npz")) for d in dumps)
    assert set(got) == set(THRESHOLDS) and want[0.05]["mAP"] > 0 and want[0.25]["AR"] > 0
    for t in THRESHOLDS:
        assert list(got[t]) == list(want[t])
        for k, v in want[t].items():
            assert abs(got[t][k] - v) <= 1e-6, (t, k, got[t][k], v)
    assert set(summary["mean_losses"]) == set(want_losses)
    for k, v in want_losses.items():
        assert abs(summary["mean_losses"][k] - v) <= 1e-4 * max(abs(v), 1e-6), k
    assert len(summary["batch_seconds"]) == 2 and summary["iou_path"] == native.path()


def test_runner_unported_options_raise(tmp_path, split):
    """``multi_mode`` and ``eval_mesh_ap`` are ported (test_torch_multimode.py,
    test_torch_voxels.py); the tensor-parallel mode still raises."""
    config = small_test_config(str(tmp_path), split, THRESHOLDS)
    config["device"]["model_parallel"] = 2
    cfg = CONFIG(config, mode="test")
    try:
        with pytest.raises(NotImplementedError, match="model_parallel"):
            test_runner.run(cfg, device="cpu")
    finally:
        cfg.close()


def test_resolve_test_batch_size(monkeypatch):
    assert test_runner.resolve_test_batch_size(1) == 1
    assert test_runner.resolve_test_batch_size("4") == 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert test_runner.resolve_test_batch_size("auto") == 1


def test_cli_test_on_cpu(tmp_path, split):
    yaml_path = tmp_path / "cfg.yaml"
    yaml_path.write_text(yaml.safe_dump(small_test_config(str(tmp_path), split, THRESHOLDS)))
    metrics = cli.main(["--config", str(yaml_path), "--mode", "test", "--device", "cpu"])
    assert set(metrics) == set(THRESHOLDS)
    for m in metrics.values():
        assert np.isfinite(m["mAP"]) and np.isfinite(m["AR"])
