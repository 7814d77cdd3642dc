"""Multi-mode generation and evaluation of the port against the JAX package,
on the CPU at the SMALL shape: ``generate(multi_mode=True)`` (Bernoulli
mixture weights, dense and sparse in f32, dense in bf16) on the JAX
package's own draws, the run salt and sample count against a JAX test run's
``out_config.yaml``, the multi-mode test runner against the JAX test path
fed the same draws through the runner's noise seam, and the multi-modal
metrics (max mAP over runs, TMD) on fake runs and on the run dirs that
scripts/torch_run_multimodal.py writes.

The draws are JAX's: each MDN head's rng key is recorded as it enters
``generate_multi`` and its normal and uniform draws repeated.  A weight's
Bernoulli mask ``u < pi`` flips where ``u`` lies within rounding of pi, so
the masks are compared and counted, and the box outputs held on the
proposals whose masks agree in every head.
"""

import glob
import importlib.util
import os

import numpy as np
import pytest
import torch
import yaml

import jax

from pose2room_tpu.config.loader import CONFIG as JaxCONFIG
from pose2room_tpu.data import P2RNetDataset as JaxP2RNetDataset
from pose2room_tpu.data.loader import collate as jax_collate
from pose2room_tpu.eval import multi_modal as jax_multi_modal
from pose2room_tpu.models.loss import detection_loss as jax_detection_loss
from pose2room_tpu.runners import test as jax_test_runner
from pose2room_tpu_torch.config.loader import CONFIG
from pose2room_tpu_torch.convert import state_dict_from_flax
from pose2room_tpu_torch.data.synth import write_synthetic_dataset
from pose2room_tpu_torch.eval import multi_modal
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
from pose2room_tpu_torch.runners import test as test_runner
from torch_golden import goldens  # noqa: F401  (a fixture)
from torch_port_util import (
    REPO,
    SMALL,
    assert_generate_close,
    f32,
    jax_generate_multi,
    jax_multi_draws,
    jax_test_metrics,
    mask_agreement,
    port_model,
    small_test_config,
    to_numpy,
    torch_noise,
    walking_clip,
)

THRESHOLDS = [0.05, 0.25]
MASK_BAND = 1e-4  # flipped share of the Bernoulli weights


@pytest.fixture(scope="module")
def payload(goldens):
    return goldens.flax_payload(SMALL["num_gaussian"], seed=3)


@pytest.fixture(scope="module")
def clip():
    # the clip test_torch_bf16.py uses: the bf16 chain picks JAX's proposals on it
    return walking_clip(np.random.RandomState(2), 2, SMALL["num_frames"])


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("split")
    write_synthetic_dataset(str(root / "dataset"), n_train=1, n_test=4, n_frames=120, seed=3)
    return str(root / "dataset" / "splits" / "script_level")


@pytest.fixture(scope="module")
def ap_weights(payload, tmp_path_factory):
    """The payload with the size head's mixture means set for ~1.5 m boxes
    (AP > 0 on random weights, as test_torch_test_runner.py does), and the
    same weights as a checkpoint for the port's ``finetune``."""
    params = jax.tree_util.tree_map(np.copy, payload["params"])
    gmm = params["detection"]["gmm_size"]
    gmm["mu"] = np.full_like(gmm["mu"], 2 * np.log(1.5) / SMALL["num_gaussian"])
    variables = {"params": params, "batch_stats": payload["batch_stats"]}
    path = str(tmp_path_factory.mktemp("weights") / "model.pth")
    torch.save({"net": state_dict_from_flax(variables)}, path)
    return variables, path


@pytest.mark.parametrize("kw", [dict(), dict(sparse_eval=True), dict(compute_dtype="bfloat16")],
                         ids=["dense", "sparse", "bf16"])
def test_generate_multi_matches_jax(payload, clip, kw):
    """The port's multi-mode generate on JAX's draws: JAX's Bernoulli is
    ``uniform < pi``; the port's masks flip on at most 1e-4 of the weights;
    indices equal; f32 outputs within ``assert_generate_close``'s bands,
    bf16 ones within test_torch_bf16.py's, the box outputs on the proposals
    whose masks agree in every head."""
    n = 7
    variables = {"params": payload["params"], "batch_stats": payload["batch_stats"]}
    ref, keys = jax_generate_multi(SMALL, n, **kw)(variables, clip, jax.random.PRNGKey(5))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    draws = jax_multi_draws(keys, clip.shape[0], n)
    for name, (_, u) in draws.items():  # the draws are JAX's own
        _, k_pi = jax.random.split(keys[name])
        bern = jax.random.bernoulli(k_pi, ref["pi"][name][..., None], u.shape)
        np.testing.assert_array_equal(np.asarray(bern), u < ref["pi"][name][..., None])

    model = port_model(SMALL, payload, **kw)
    got = to_numpy(model.generate(torch.from_numpy(clip), multi_mode=True, n_samples=n,
                                  folded=model.fold_eval(), noise=torch_noise(draws)))
    flips, total, rows = mask_agreement(draws, got["pi"], ref["pi"])
    print(f"{kw}: {flips} of {total} Bernoulli weights flipped; {rows.sum()} of {rows.size} proposals agree")
    assert flips <= MASK_BAND * total
    if "compute_dtype" not in kw:
        assert_generate_close(got, ref, rows=rows)
        return
    np.testing.assert_array_equal(got["seed_inds"], ref["seed_inds"])
    np.testing.assert_array_equal(got["aggregated_vote_inds"], ref["aggregated_vote_inds"])
    pairs = {k: (got[k], ref[k]) for k in ("seed_features", "vote_xyz", "objectness_scores", "sem_cls_scores")}
    pairs.update({k: (got[k][rows], ref[k][rows]) for k in ("center", "size", "heading")})
    pairs.update({f"pi/{k}": (got["pi"][k], ref["pi"][k]) for k in ("center", "size", "heading")})
    for key, (g, r) in pairs.items():
        g, r = f32(g), np.asarray(r, np.float32)
        band = 1e-2 if key == "seed_features" else 0.05
        assert np.abs(g - r).max() <= band * np.abs(r).max(), key


def test_multi_mode_draws_match_jax_runner(tmp_path, split):
    """The run salt and sample count of the port's ``multi_mode_draws`` equal
    those a JAX multi-mode test run writes to its out_config.yaml."""
    config = small_test_config(str(tmp_path), split, [0.25], multi_mode=True)
    config["device"]["num_workers"] = 0
    cfg = JaxCONFIG(config=config, args={"mode": "test"})
    jax_test_runner.run(cfg)
    with open(os.path.join(cfg.save_path, "out_config.yaml")) as f:
        written = yaml.safe_load(f)["test"]
    salt, n = test_runner.multi_mode_draws(cfg.save_path, 42)
    assert (written["drawn_run_salt"], written["drawn_n_samples"]) == (salt, n)
    assert 1 <= n <= 99 and salt == written["drawn_run_salt"] > 0


def test_multi_mode_runner_matches_jax(tmp_path, monkeypatch, split, ap_weights):
    """The port's multi-mode sparse test run, handed the JAX runner's draws
    for each batch (its keys: fold_in(fold_in(fold_in(PRNGKey(seed), salt),
    process 0), batch)) through ``multi_mode_noise``, against the JAX test
    path composed from multi-mode ``generate``, the parse, the loss and
    ``APCalculator``: AP and recall within 1e-6, mean losses within 1e-4
    relative; out_config.yaml holds the drawn salt and sample count; the
    dumps read back through ``multi_modal``."""
    variables, weight = ap_weights
    config = small_test_config(str(tmp_path), split, THRESHOLDS, weight=weight, multi_mode=True,
                               remove_far_box=False)
    config["generation"].update(dump_results=True, dump_threshold=0.05)
    cfg = CONFIG(config, mode="test")
    salt, n = test_runner.multi_mode_draws(cfg.save_path, 42)

    ds = JaxP2RNetDataset(os.path.join(split, "test.json"), num_frames=SMALL["num_frames"])
    generate = jax_generate_multi(SMALL, n, sparse_eval=True)
    gen_key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(42), salt), 0)
    loss = jax.jit(lambda ep, arrays: jax_detection_loss(ep, arrays, 0))
    outputs, noise = [], []
    for it, start in enumerate((0, 2)):
        batch = jax_collate([ds[i] for i in (start, start + 1)])
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        ep, keys = generate(variables, arrays["input_joints"], jax.random.fold_in(gen_key, it))
        ep = jax.tree_util.tree_map(np.asarray, ep)
        losses = loss({k: v for k, v in ep.items() if k != "pi"}, arrays)
        outputs.append((arrays, ep, {k: float(v) for k, v in losses.items()}))
        noise.append(jax_multi_draws(keys, 2, n))
    want, want_losses, n_pred = jax_test_metrics(outputs, THRESHOLDS, {"remove_far_box": False})

    seen = []

    def jax_noise(model, it, batch_size, n_samples, generator):
        assert (batch_size, n_samples) == (2, n) and generator.device.type == "cpu"
        seen.append(it)
        return torch_noise(noise[it])

    monkeypatch.setattr(test_runner, "multi_mode_noise", jax_noise)
    try:
        got = test_runner.run(cfg, device="cpu")
        summary = cfg.test_summary
    finally:
        cfg.close()
    assert seen == [0, 1] and summary["n_samples"] == n and n_pred > 0
    with open(os.path.join(cfg.save_path, "out_config.yaml")) as f:
        written = yaml.safe_load(f)["test"]
    assert (written["drawn_run_salt"], written["drawn_n_samples"]) == (salt, n)
    assert want[0.05]["mAP"] > 0
    for t in THRESHOLDS:
        assert list(got[t]) == list(want[t])
        for k, v in want[t].items():
            assert abs(got[t][k] - v) <= 1e-6, (t, k, got[t][k], v)
    for k, v in want_losses.items():
        assert abs(summary["mean_losses"][k] - v) <= 1e-4 * max(abs(v), 1e-6), k
    assert multi_modal.scrape_map_scores(cfg.save_path) == jax_multi_modal.scrape_map_scores(cfg.save_path)
    assert len(multi_modal.scrape_map_scores(cfg.save_path)) == len(THRESHOLDS)


def _write_fake_run(root, name, boxes_by_sample, map_score):
    """A run dir as tests/test_multimodal.py:_write_fake_run writes it."""
    run = os.path.join(root, name)
    for sample, boxes in boxes_by_sample.items():
        d = os.path.join(run, "visualization", sample)
        os.makedirs(d, exist_ok=True)
        inst_idx = np.zeros(16, dtype=bool)
        inst_idx[[b[2] for b in boxes]] = True
        np.savez(os.path.join(d, "000000_pred_confident_nms_bbox.npz"),
                 obbs=np.array([b[0] for b in boxes]), cls=np.array([b[1] for b in boxes]), inst_idx=inst_idx)
    with open(os.path.join(run, "log.txt"), "w") as f:
        f.write(f"eval mAP: {map_score:.6f}\n")
    return run


def _assert_metrics_match(run_dirs):
    got, want = multi_modal.multi_modal_metrics(run_dirs), jax_multi_modal.multi_modal_metrics(run_dirs)
    np.testing.assert_allclose(got[0], want[0], atol=1e-12, rtol=0)
    assert abs(got[1] - want[1]) <= 1e-12
    return got


def test_multi_modal_metrics_match_jax_on_fake_runs(tmp_path):
    """tests/test_multimodal.py's cases (identical boxes: TMD 1; another class
    and position: TMD > 1.5) and a three-run mix, within 1e-12 of JAX."""
    box = (np.array([0, 0, 0, 1, 1, 1, 0.3]), 4, 2)
    box2 = (np.array([0.5, 0, 0, 1, 1, 1, 0.3]), 7, 2)
    box3 = (np.array([0.2, 0.1, -0.3, 1.2, 0.8, 1, -1.1]), 4, 5)
    root = str(tmp_path)
    same = [_write_fake_run(root, "A", {"s1": [box]}, 0.25), _write_fake_run(root, "B", {"s1": [box]}, 0.35)]
    max_map, tmd = _assert_metrics_match(same)
    np.testing.assert_allclose(max_map, [0.35])
    assert abs(tmd - 1.0) < 1e-9
    other = [_write_fake_run(root, "C", {"s1": [box]}, 0.2), _write_fake_run(root, "D", {"s1": [box2]}, 0.2)]
    assert _assert_metrics_match(other)[1] > 1.5
    mix = [_write_fake_run(root, "E", {"s1": [box, box3], "s2": [box2]}, 0.1),
           _write_fake_run(root, "F", {"s1": [box2], "s2": [box3]}, 0.3),
           _write_fake_run(root, "G", {"s1": [box3, box]}, 0.2)]
    _assert_metrics_match(mix)
    npz = os.path.join(mix[0], "visualization", "s1", "000000_pred_confident_nms_bbox.npz")
    got, want = multi_modal.read_pred_npz(npz), jax_multi_modal.read_pred_npz(npz)
    assert [(g["inst_id"], g["class_id"]) for g in got] == [(w["inst_id"], w["class_id"]) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["corners"], w["corners"], atol=1e-12, rtol=0)


def test_scrape_map_scores_reads_the_logged_repr(tmp_path):
    """The runners log ``eval mAP: {v}`` with Python's repr, which writes an
    mAP below 1e-4 in exponent form: the port reads the whole number; JAX
    ``scrape_map_scores`` (``\\d+\\.\\d+``) reads 9.137427e-05 as 9.137427, so
    its max mAP over runs takes it (ROADMAP §3).  Other values agree; the
    mesh twins are not read."""
    values = [9.137427e-05, 0.25, 0.0]
    with open(tmp_path / "log.txt", "w") as f:
        for v in values:
            f.write(f"eval mAP: {v}\neval mAP_mesh: {v / 2}\n")
    assert multi_modal.scrape_map_scores(str(tmp_path)) == values
    assert jax_multi_modal.scrape_map_scores(str(tmp_path)) == [9.137427, 0.25, 0.0]


def test_torch_run_multimodal_script_on_cpu(tmp_path, monkeypatch):
    """scripts/torch_run_multimodal.py with ``--skip-train --device cpu`` at
    the SMALL sizes (its shipped configs shrunk, remove_far_box off) on a
    checkpoint with metre-sized boxes: it writes the synthetic split, runs
    two multi-mode ``python -m pose2room_tpu_torch --mode test``
    subprocesses, each with its own drawn salt and sample count in its
    out_config.yaml and dumps at threshold 0.05, and scores them; the
    multi-modal metrics over those run dirs are within 1e-12 of the JAX
    package's, max mAP finite, TMD finite and >= 1."""
    spec = importlib.util.spec_from_file_location(
        "torch_run_multimodal", os.path.join(REPO, "scripts", "torch_run_multimodal.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    shipped = script.shipped_config

    def small(name):
        config = shipped(name)
        config["data"].update(num_frames=SMALL["num_frames"], num_seeds=SMALL["num_seeds"],
                              num_target=SMALL["num_proposals"], num_gaussian=SMALL["num_gaussian"])
        if "test" in config:
            config["test"]["remove_far_box"] = False
        return config

    monkeypatch.setattr(script, "shipped_config", small)
    model = P2RNet(P2RNetConfig(**SMALL), device="cpu")
    with torch.no_grad():
        model.detection.gmm_size.mdn.mu.fill_(2 * np.log(1.5) / SMALL["num_gaussian"])
    train_dir = tmp_path / "out" / "train" / "run"
    os.makedirs(train_dir)
    torch.save({"net": model.state_dict()}, train_dir / "model_final.pth")
    rc = script.main(["--root", str(tmp_path), "--runs", "2", "--skip-train", "--n-train", "1", "--n-test", "2",
                      "--dtype", "float32", "--device", "cpu"])
    assert rc == 0
    runs = sorted(glob.glob(str(tmp_path / "out" / "test" / "*")))
    assert len(runs) == 2
    for run in runs:
        with open(os.path.join(run, "out_config.yaml")) as f:
            written = yaml.safe_load(f)["test"]
        assert written["multi_mode"] and (written["drawn_run_salt"], written["drawn_n_samples"]) == \
            test_runner.multi_mode_draws(run, 42)
    max_map, tmd = _assert_metrics_match(runs)
    assert len(max_map) == 2 and np.all(np.isfinite(max_map))
    assert np.isfinite(tmd) and tmd >= 1.0
