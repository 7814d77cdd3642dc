"""The port's smaller ops against the JAX package on the same seeded numpy
inputs: ``eval_nn_loss``, the three-NN interpolation, ``box3d_iou_aabb``,
``DatasetConfig(split=)`` with its heading-bin helpers, and the CLI's git
stamp of a run."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pose2room_tpu.config.dataset_config import DatasetConfig as JaxDatasetConfig
from pose2room_tpu.models import loss as jax_loss
from pose2room_tpu.ops import boxes as jax_boxes
from pose2room_tpu.ops import interpolate as jax_interp
from pose2room_tpu.ops.nn_distance import huber_loss as jax_huber
from pose2room_tpu_torch import __main__ as cli
from pose2room_tpu_torch.config.dataset_config import DatasetConfig
from pose2room_tpu_torch.config.loader import CONFIG, mount_external_config
from pose2room_tpu_torch.models.loss import eval_nn_assignment, eval_nn_loss
from pose2room_tpu_torch.ops import boxes, interpolate

EVAL_NN_KEYS = {"total", "center_loss", "size_loss", "heading_loss", "sem_cls_loss",
                "centroid_reg_loss1", "centroid_reg_loss2"}


def _eval_nn_inputs(seed, B=2, K=16, K2=10, n_valid=(4, 7)):
    """Proposals and padded GT (a valid prefix per clip).  The padded slots
    hold GT centers ON proposals (their +BIG must keep them unassigned) and
    valid slots 1 and 2 of clip 0 are equal (the first must win the tie)."""
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    ep = {"center": f32(B, K, 3) * 2, "size": f32(B, K, 3), "heading": f32(B, K, 2),
          "sem_cls_scores": f32(B, K, 22)}
    mask = np.zeros((B, K2), np.float32)
    for b, n in enumerate(n_valid):
        mask[b, :n] = 1
    centers = f32(B, K2, 3) * 2
    centers[0, 1] = ep["center"][0, K - 1] + 0.01
    centers[0, 2] = centers[0, 1]
    for b, n in enumerate(n_valid):
        centers[b, n:] = ep["center"][b, : K2 - n]
    gt = {"center_label": centers, "box_label_mask": mask, "size": f32(B, K2, 3),
          "heading": f32(B, K2, 2), "sem_cls_label": rng.randint(0, 22, (B, K2)).astype(np.int64)}
    return ep, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_nn_loss_matches_jax(seed):
    ep, gt = _eval_nn_inputs(seed)
    want = jax_loss.eval_nn_loss({k: jnp.asarray(v) for k, v in ep.items()},
                                 {k: jnp.asarray(v) for k, v in gt.items()})
    tep = {k: torch.from_numpy(v) for k, v in ep.items()}
    tgt = {k: torch.from_numpy(v) for k, v in gt.items()}
    got = eval_nn_loss(tep, tgt)
    assert set(got) == set(want) == EVAL_NN_KEYS
    for k in EVAL_NN_KEYS:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)

    # JAX's assignment, formed with its own primitives as its eval_nn_loss does
    diff = jnp.asarray(ep["center"])[:, :, None, :] - jnp.asarray(gt["center_label"])[:, None, :, :]
    d = jnp.sum(jax_huber(diff, delta=1.0), axis=-1) + (1.0 - jnp.asarray(gt["box_label_mask"]))[:, None, :] * 1e9
    want_assign = np.asarray(jnp.argmin(d, axis=2))
    _, assign = eval_nn_assignment(tep, tgt)
    np.testing.assert_array_equal(assign.numpy(), want_assign)
    mask = gt["box_label_mask"]
    assert all(mask[b, assign[b].numpy()].all() for b in range(2)), "a padded GT box was assigned"
    assert assign[0, -1] == 1 and 2 not in assign[0].tolist(), "the tie of GT 1 and 2 did not go to the first"


def _clouds(seed, B=2, N=40, M=12):
    """Unknowns and knowns with a known point repeated three times, unknown
    0 nearest to it (its three neighbours tie).  No unknown sits ON a known
    point: there d is the square root of a d^2 of rounding size, ~1e-3 in
    either package, so only the port's own identity test takes that case."""
    rng = np.random.RandomState(seed)
    unknown = (rng.rand(B, N, 3) * 4 - 2).astype(np.float32)
    known = (rng.rand(B, M, 3) * 4 - 2).astype(np.float32)
    known[:, 7] = known[:, 3]
    known[:, 10] = known[:, 3]
    unknown[:, 0] = known[:, 3] + 0.1
    feats = rng.randn(B, M, 5).astype(np.float32)
    return unknown, known, feats


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_nn_and_interpolation_match_jax(seed):
    unknown, known, feats = _clouds(seed)
    jd, ji = jax_interp.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    td, ti = interpolate.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    assert ti.dtype == torch.int32 and ti.shape == (2, 40, 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    # the duplicated known points tie: the lowest index first
    assert ti[:, 0].tolist() == [[3, 7, 10]] * 2

    w = np.random.RandomState(seed + 10).rand(2, 40, 3).astype(np.float32)
    got = interpolate.three_interpolate(torch.from_numpy(feats), ti, torch.from_numpy(w))
    want = jax_interp.three_interpolate(jnp.asarray(feats), ji, jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    got = interpolate.interpolate_features(*(torch.from_numpy(a) for a in (unknown, known, feats)))
    want = jax_interp.interpolate_features(*(jnp.asarray(a) for a in (unknown, known, feats)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_interpolate_at_known_points_recovers_their_features():
    _, known, feats = _clouds(0)
    dist, idx = interpolate.three_nn(torch.from_numpy(known), torch.from_numpy(known))
    assert idx[:, :, 0].tolist() == [[0, 1, 2, 3, 4, 5, 6, 3, 8, 9, 3, 11]] * 2  # a repeat ties to its first
    assert (dist[:, :, 0] == 0).all()
    got = interpolate.interpolate_features(torch.from_numpy(known), torch.from_numpy(known), torch.from_numpy(feats))
    want = feats.copy()
    want[:, [3, 7, 10]] = feats[:, [3, 7, 10]].mean(1, keepdims=True)  # three zero distances weigh alike
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_three_interpolate_gradient_matches_jax():
    unknown, known, feats = _clouds(3)
    cot = np.random.RandomState(4).randn(2, 40, 5).astype(np.float32)
    _, ji = jax_interp.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    w = np.random.RandomState(5).rand(2, 40, 3).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(jax_interp.three_interpolate(f, ji, jnp.asarray(w)) * cot))(
        jnp.asarray(feats))
    tf = torch.from_numpy(feats).requires_grad_(True)
    _, ti = interpolate.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    (interpolate.three_interpolate(tf, ti, torch.from_numpy(w)) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the full FP interpolation too, through its weights' indices
    want = jax.grad(lambda f: jnp.sum(jax_interp.interpolate_features(
        jnp.asarray(unknown), jnp.asarray(known), f) * cot))(jnp.asarray(feats))
    tf.grad = None
    (interpolate.interpolate_features(torch.from_numpy(unknown), torch.from_numpy(known), tf)
     * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_box3d_iou_aabb_matches_jax():
    rng = np.random.RandomState(0)
    lo = rng.rand(3, 5, 3) * 2
    a = np.concatenate([lo, lo + rng.rand(3, 5, 3) + 0.1], -1)
    lo = rng.rand(3, 4, 3) * 2
    b = np.concatenate([lo, lo + rng.rand(3, 4, 3) + 0.1], -1)
    b[0, 0] = a[0, 0]  # identical boxes: IoU 1
    b[1, 1] = a[1, 1] + np.array([9.0, 0, 0, 9.0, 0, 0])  # disjoint: IoU 0
    got = boxes.box3d_iou_aabb(a, b)
    np.testing.assert_array_equal(got, jax_boxes.box3d_iou_aabb(a, b, xp=np))
    assert got.shape == (3, 5, 4) and got[0, 0, 0] == 1.0 and got[1, 1, 1] == 0.0


def _assert_same_dataset_config(got, want):
    np.testing.assert_array_equal(got.mean_size_arr, want.mean_size_arr)
    assert got.split_level == want.split_level and str(got.prior_path) == str(want.prior_path)
    assert set(got.type_mean_size) == set(want.type_mean_size)
    for k, v in want.type_mean_size.items():
        np.testing.assert_array_equal(got.type_mean_size[k], v)
    for name in ("class_labels", "class_labels_raw", "class_mapping", "type2class", "class2type",
                 "num_class", "num_heading_bin", "num_size_cluster", "joint_num", "origin_joint_id",
                 "contact_dist_thresh", "skeleton_edges"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("level", ["script_level", "room_level"])
def test_dataset_config_split_prior_matches_jax(tmp_path, monkeypatch, level):
    monkeypatch.chdir(tmp_path)
    prior_dir = tmp_path / "datasets" / "virtualhome_22_classes" / "splits" / level
    prior_dir.mkdir(parents=True)
    rng = np.random.RandomState(len(level))
    prior = {"obj_size_cls_avg": {str(c): (rng.rand(3) + 0.2).tolist() for c in (0, 5, 16, 21)},
             "layout_size_avg": [8.0, 3.0, 8.0]}
    (prior_dir / "avg_data.json").write_text(json.dumps(prior))
    split = f"datasets/virtualhome_22_classes/splits/{level}"
    got, want = DatasetConfig(split=split), JaxDatasetConfig(split=split)
    _assert_same_dataset_config(got, want)
    assert got.mean_size_arr[16].tolist() == prior["obj_size_cls_avg"]["16"]
    # no split: the script level's prior, which this directory holds only for that level
    _assert_same_dataset_config(DatasetConfig(), JaxDatasetConfig())

    for angle in (-3.5, -np.pi, -0.3, 0.0, 0.26, 1.0, np.pi, 5.9, 7.0):
        c, r = got.angle2class(angle)
        wc, wr = want.angle2class(angle)
        assert c == wc and type(c) is type(wc) and r == wr
        assert got.class2angle(c, r) == want.class2angle(wc, wr)
        assert got.class2angle(c, r, to_label_format=False) == want.class2angle(wc, wr, to_label_format=False)
    res = rng.randn(3)
    np.testing.assert_array_equal(got.class2size(16, res), want.class2size(16, res))
    args = (rng.randn(3), 4, 0.1, 16, res)
    np.testing.assert_array_equal(got.param2obb(*args), want.param2obb(*args))

    # the loader passes data.split, so the config's runs read the prior
    cfg = CONFIG({"data": {"split": split}, "log": {"path": str(tmp_path / "out")}}, mode="test")
    try:
        mount_external_config(cfg)
        np.testing.assert_array_equal(cfg.dataset_config.mean_size_arr, want.mean_size_arr)
        assert cfg.eval_config["dataset_config"] is cfg.dataset_config
    finally:
        cfg.close()


def test_get_sha_outside_a_git_tree(tmp_path, monkeypatch):
    monkeypatch.setenv("GIT_DIR", str(tmp_path / "no-git"))
    assert cli.get_sha() == "sha: N/A, status: clean, branch: N/A"


SHA_LINE = re.compile(r"sha: ([0-9a-f]{40}|N/A), status: (clean|has uncommitted changes), branch: \S+$")


@pytest.mark.parametrize("git", [True, False])
def test_cli_logs_the_git_stamp(tmp_path, monkeypatch, git):
    """Rank 0's log.txt holds the stamp right after "Loading configurations."
    (JAX main.py:13-28, 53), with N/A fields where git cannot say."""
    from pose2room_tpu_torch.runners import demo

    if not git:
        monkeypatch.setenv("GIT_DIR", str(tmp_path / "no-git"))
    monkeypatch.setattr(demo, "run", lambda cfg, device=None: None)
    config = {"log": {"path": str(tmp_path / "out")}, "seed": 0}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(config))
    cli.main(["--config", str(path), "--mode", "demo", "--device", "cpu"])
    (run_dir,) = (tmp_path / "out" / "demo").iterdir()
    lines = [line.split(" ", 2)[-1] for line in (run_dir / "log.txt").read_text().splitlines()]
    at = lines.index("Loading configurations.")
    assert SHA_LINE.match(lines[at + 1]), lines[at + 1]
    if not git:
        assert lines[at + 1] == "sha: N/A, status: clean, branch: N/A"
    elif os.path.isdir(os.path.join(cli.REPO, ".git")):
        assert lines[at + 1] != "sha: N/A, status: clean, branch: N/A"
