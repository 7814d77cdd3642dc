"""Serving path of the port: parse against the JAX package, the demo runner
and CLI on the CPU, the config keys every runner checks (``method``,
``device.model_parallel``) or takes, the device policy of the entry points,
and the rule that the port imports neither JAX nor the JAX package."""

import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from pose2room_tpu.config.dataset_config import DatasetConfig as JaxDatasetConfig
from pose2room_tpu.eval import parse as jax_parse
from pose2room_tpu_torch import __main__ as cli
from pose2room_tpu_torch.config.dataset_config import DatasetConfig
from pose2room_tpu_torch.config.loader import CONFIG
from pose2room_tpu_torch.data import synth
from pose2room_tpu_torch.data.dataset import SceneDataset
from pose2room_tpu_torch.eval import parse
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
from pose2room_tpu_torch.runners import common, demo
from pose2room_tpu_torch.runners import test as test_runner
from pose2room_tpu_torch.runners import train as train_runner
from torch_port_util import SMALL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_CLIP = os.path.join(REPO, "demo", "inputs", "input_joints_1.npy")
TEST_YAML = os.path.join(REPO, "configs", "config_files", "p2rnet_test.yaml")


def _end_points(rng, B=2, K=48, T=40):
    joints = (rng.randn(B, T, 53, 3) * 0.3).astype(np.float32)
    joints[..., 0] += np.linspace(-2, 2, T, dtype=np.float32)[None, :, None]
    hips = joints[:, :, 0]
    center = hips[:, rng.randint(0, T, K)] + rng.randn(B, K, 3).astype(np.float32) * 0.8
    return {
        "center": center.astype(np.float32),
        "size": (rng.randn(B, K, 3) * 0.6 - 0.5).astype(np.float32),
        "heading": rng.randn(B, K, 2).astype(np.float32),
        "sem_cls_scores": rng.randn(B, K, 22).astype(np.float32),
        "objectness_scores": rng.randn(B, K, 2).astype(np.float32),
    }, joints


@pytest.mark.parametrize("knobs", [
    dict(),
    dict(use_3d_nms=False),
    dict(cls_nms=True, nms_iou=0.25),
    dict(remove_far_box=False, use_old_type_nms=True),
])
def test_parse_matches_jax(rng, knobs):
    ep, joints = _end_points(rng)
    jax_eval, jax_parsed = jax_parse.parse_predictions(
        ep, {"input_joints": joints}, {"dataset_config": JaxDatasetConfig(), **knobs}
    )
    cfg = {"dataset_config": DatasetConfig(), **knobs}
    eval_dict, parsed = parse.parse_predictions(
        {k: torch.from_numpy(v) for k, v in ep.items()},
        {"input_joints": torch.from_numpy(joints)}, cfg,
    )
    np.testing.assert_array_equal(eval_dict["pred_mask"], jax_eval["pred_mask"])
    assert 0 < eval_dict["pred_mask"].sum() < eval_dict["pred_mask"].size
    np.testing.assert_allclose(parsed["pred_corners_3d"], jax_parsed["pred_corners_3d"], atol=1e-5)
    np.testing.assert_allclose(parsed["obj_prob"], jax_parsed["obj_prob"], atol=1e-6)
    np.testing.assert_allclose(parsed["sem_cls_probs"], jax_parsed["sem_cls_probs"], atol=1e-6)
    np.testing.assert_array_equal(parsed["pred_sem_cls"], jax_parsed["pred_sem_cls"])
    cfg["conf_thresh"] = 0.05
    jax_cfg = {"dataset_config": JaxDatasetConfig(), **knobs, "conf_thresh": 0.05}
    ours = parse.assembly_pred_map_cls(eval_dict, parsed, cfg)["batch_pred_map_cls"]
    ref = jax_parse.assembly_pred_map_cls(jax_eval, jax_parsed, jax_cfg)["batch_pred_map_cls"]
    assert [[(c, round(float(s), 5)) for c, _, s in b] for b in ours] == \
        [[(c, round(float(s), 5)) for c, _, s in b] for b in ref]


def test_parse_sample_cls_matches_jax(rng):
    """sample_cls draws the class from sem_cls_probs with the caller's rng."""
    ep, joints = _end_points(rng)
    _, jax_parsed = jax_parse.parse_predictions(
        ep, {"input_joints": joints}, {"dataset_config": JaxDatasetConfig(), "sample_cls": True},
        rng=np.random.RandomState(7),
    )
    _, parsed = parse.parse_predictions(
        {k: torch.from_numpy(v) for k, v in ep.items()}, {"input_joints": torch.from_numpy(joints)},
        {"dataset_config": DatasetConfig(), "sample_cls": True}, rng=np.random.RandomState(7),
    )
    np.testing.assert_array_equal(parsed["pred_sem_cls"], jax_parsed["pred_sem_cls"])


def _small_config(tmp_path, **extra):
    config = yaml.safe_load(open(TEST_YAML))
    config["data"].update(num_frames=SMALL["num_frames"], num_seeds=SMALL["num_seeds"],
                          num_target=SMALL["num_proposals"], num_gaussian=SMALL["num_gaussian"])
    config.update(finetune=False, seed=42, log={**config["log"], "path": str(tmp_path / "out")})
    config.update(extra)
    return config


def _demo_dir(tmp_path):
    d = tmp_path / "demo"
    os.makedirs(d / "inputs")
    shutil.copy(DEMO_CLIP, d / "inputs" / "input_joints_1.npy")
    return str(d)


def test_demo_runner_on_cpu_writes_dumps(tmp_path):
    cfg = CONFIG(_small_config(tmp_path, demo_path=_demo_dir(tmp_path)), mode="demo")
    try:
        results = demo.run(cfg, device="cpu")
    finally:
        cfg.close()
    assert len(results) == 1
    path, dump_dir, n_boxes, seconds = results[0]
    assert path.endswith("input_joints_1.npy") and seconds > 0 and n_boxes >= 0
    assert os.path.isfile(os.path.join(dump_dir, "skeleton_points.ply"))
    with open(os.path.join(dump_dir, "000000_pi_dict.json")) as f:
        pi = json.load(f)
    assert set(pi) == {"center", "size", "heading"}
    assert (os.path.isfile(os.path.join(dump_dir, "000000_pred_confident_nms_bbox.npz"))
            == (n_boxes > 0))


def test_demo_ignores_multi_mode(tmp_path):
    """As the JAX demo runner, which always serves MDN ``get_mean``
    (runners/demo.py:60-85): a demo run with ``test.multi_mode: True``
    writes the same dumps as one with False."""
    dumps = {}
    for multi_mode in (False, True):
        config = _small_config(tmp_path / str(multi_mode), demo_path=_demo_dir(tmp_path / str(multi_mode)))
        config["test"].update(multi_mode=multi_mode, remove_far_box=False)
        config["generation"]["dump_threshold"] = 0.0
        cfg = CONFIG(config, mode="demo")
        try:
            (result,) = demo.run(cfg, device="cpu")
        finally:
            cfg.close()
        dump_dir = result[1]
        dumps[multi_mode] = {name: open(os.path.join(dump_dir, name), "rb").read()
                             for name in sorted(os.listdir(dump_dir))}
    assert "000000_pred_confident_nms_bbox.npz" in dumps[False]
    assert dumps[True] == dumps[False]


def test_demo_finetune_loads_reference_layout_weights(tmp_path):
    src = P2RNet(P2RNetConfig(**SMALL), device="cpu", generator=torch.Generator().manual_seed(9))
    ckpt = str(tmp_path / "model.pth")
    torch.save({"net": {f"module.{k}": v for k, v in src.state_dict().items()}}, ckpt)
    cfg = CONFIG(_small_config(tmp_path, finetune=True, weight=[ckpt]), mode="demo")
    try:
        model = common.setup(cfg, device="cpu")[0]
    finally:
        cfg.close()
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_demo_finetune_load_is_partial(tmp_path, monkeypatch):
    """As the JAX package's load_weights (train/checkpoint.py:73-102): a
    checkpoint whose class head has another shape, and a tensor the model
    does not have, loads every other tensor and logs each skip and the
    partial count."""
    src = P2RNet(P2RNetConfig(**SMALL), device="cpu", generator=torch.Generator().manual_seed(9))
    sd = dict(src.state_dict())
    head = "detection.conv_sem_obj.2.conv.weight"
    sd[head] = torch.randn(2 + 30, sd[head].shape[1])  # a 30-class head
    sd["detection.extra.weight"] = torch.zeros(3)
    ckpt = str(tmp_path / "model.pth")
    torch.save({"net": {f"module.{k}": v for k, v in sd.items()}}, ckpt)
    cfg = CONFIG(_small_config(tmp_path, finetune=True, weight=[ckpt]), mode="demo")
    logged = []
    monkeypatch.setattr(cfg, "log_string", lambda msg: logged.append(str(msg)))
    try:
        model = common.setup(cfg, device="cpu")[0]
    finally:
        cfg.close()
    fresh = P2RNet(P2RNetConfig(**SMALL), device="cpu", generator=torch.Generator().manual_seed(42))
    own = model.state_dict()
    for k, v in src.state_dict().items():
        assert torch.equal(own[k], fresh.state_dict()[k] if k == head else v), k
    assert f"skip weight {head} (missing or shape mismatch)" in logged
    assert "skip weight detection.extra.weight (missing or shape mismatch)" in logged
    assert f"partial weight load: {len(own) - 1}/{len(own)} tensors" in logged


@pytest.mark.parametrize("section", [
    {"device": {"model_parallel": 2}},
    {"train": {"h2d_dtype": "float16"}},
    {"log": {"profile_steps": 3}},
])
@pytest.mark.parametrize("runner", ["demo", "test", "train"])
def test_unported_keys_raise_in_every_runner(tmp_path, monkeypatch, section, runner):
    """device.model_parallel, which the JAX package acts on, raises in every
    runner instead of being ignored.  train.h2d_dtype and log.profile_steps
    are ported: the demo and test runners ignore them, as the JAX package's
    do, and the train runner takes them (its profile window traces train
    steps [3, 3 + n) under the run dir)."""
    monkeypatch.chdir(tmp_path)  # the TensorBoard board writes to ./runs
    if "device" in section:
        with pytest.raises(NotImplementedError):
            _run_runner(tmp_path, runner, **section)
        return
    cfg, result = _run_runner(tmp_path, runner, **section)
    traces = glob.glob(os.path.join(cfg.save_path, "profile", "*.pt.trace.json"))
    assert len(traces) == (runner == "train" and "log" in section)


@pytest.mark.parametrize("method", ["Foo", "P2RNet"])
@pytest.mark.parametrize("runner", ["demo", "test", "train"])
def test_method_is_checked_in_every_runner(tmp_path, monkeypatch, method, runner):
    """The top-level ``method:`` names the model class, as the JAX
    package's METHODS registry does: a name it does not know raises
    KeyError in every runner, and P2RNet runs."""
    monkeypatch.chdir(tmp_path)
    if method == "Foo":
        with pytest.raises(KeyError, match="'Foo' not found in registry 'methods'"):
            _run_runner(tmp_path, runner, method=method)
        return
    _run_runner(tmp_path, runner, method=method)


def _run_runner(tmp_path, runner, **sections):
    """Run the demo (one clip), test (one scene) or train (1 epoch of 2
    steps, 4 with a profile window, which opens at step 3) runner at the
    SMALL sizes on the CPU, with ``sections`` merged into the config.
    Returns (cfg, the runner's result), checked."""
    config = _small_config(tmp_path, demo_path=_demo_dir(tmp_path))
    for key, value in sections.items():
        config[key] = {**(config.get(key) or {}), **value} if isinstance(value, dict) else value
    config["train"] = {**(config.get("train") or {}), "epochs": 1, "batch_size": 1}
    config["val"] = {"batch_size": 2}
    config["device"] = {**(config.get("device") or {}), "num_workers": 0}
    n_train = 4 if "profile_steps" in config["log"] else 2
    rng = np.random.RandomState(0)
    scenes = [synth.as_stored(*synth.make_scene(rng, n_objects=3, n_frames=120)) for _ in range(n_train + 2)]
    cfg = CONFIG(config, mode=runner)
    try:
        if runner == "demo":
            result = demo.run(cfg, device="cpu")
            assert len(result) == 1
        elif runner == "test":
            result = test_runner.run(cfg, device="cpu",
                                     dataset=SceneDataset(scenes[:1], num_frames=SMALL["num_frames"]))
            assert set(result) == {0.25, 0.5}
        else:
            result = train_runner.run(cfg, device="cpu", datasets={
                "train": SceneDataset(scenes[:n_train], num_frames=SMALL["num_frames"], augment=True),
                "val": SceneDataset(scenes[n_train:], num_frames=SMALL["num_frames"])})
            assert len(result[1]) == 1 and np.isfinite(result[1][0]["train"]["total"])
    finally:
        cfg.close()
    return cfg, result


def test_cli_demo_on_cpu(tmp_path):
    yaml_path = tmp_path / "cfg.yaml"
    yaml_path.write_text(yaml.safe_dump(_small_config(tmp_path)))
    results = cli.main(["--config", str(yaml_path), "--mode", "demo",
                        "--demo_path", _demo_dir(tmp_path), "--device", "cpu"])
    assert len(results) == 1 and os.path.isdir(results[0][1])
    # --mode test runs the test runner, which needs the config's test split
    with pytest.raises(FileNotFoundError):
        cli.main(["--config", str(yaml_path), "--mode", "test", "--device", "cpu"])


def test_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P2RNet(P2RNetConfig(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA"):
        P2RNet(P2RNetConfig(**SMALL), device="cuda")
    cfg = CONFIG(_small_config(tmp_path, demo_path=_demo_dir(tmp_path)), mode="demo")
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            demo.run(cfg)
    finally:
        cfg.close()
    yaml_path = tmp_path / "cfg.yaml"
    yaml_path.write_text(yaml.safe_dump(_small_config(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--config", str(yaml_path), "--mode", "demo"])
    # the CPU is used only when asked for
    assert P2RNet(P2RNetConfig(**SMALL), device="cpu").device.type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pose2room_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'pose2room_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'scripts')\n"
        "for s in ('torch_generate_samples', 'torch_split_samples', 'torch_render_sample', "
        "'torch_render_results'): importlib.import_module(s)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pose2room_tpu'))\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
