"""Resume and finetune of a training run in the port, on the CPU.

* 1 epoch, then a resumed run of 1 more, equals 2 uninterrupted epochs bit
  for bit (state_dict, optimizer state, history, checkpoints), with the lr
  (a milestone) and the BN momentum (``bnscheduler``) changing at the
  boundary, weight decay and clipping on;
* ``find_resume_checkpoint`` on the four directory layouts of
  tests/test_checkpoint.py, named as the JAX package's Orbax checkpoints
  (held against its CheckpointIO) and as the port's ``.pth`` files;
* ``finetune`` in the train runner loads ``weight:`` partially, and
  ``resume`` takes precedence over it, as in the JAX package;
* an http(s) ``weight:`` raises: nothing is downloaded.
"""

import os
import re

import numpy as np
import pytest
import torch
import yaml

from pose2room_tpu.train.checkpoint import CheckpointIO as JaxCheckpointIO
from pose2room_tpu_torch.config.loader import CONFIG
from pose2room_tpu_torch.data import synth
from pose2room_tpu_torch.data.dataset import SceneDataset
from pose2room_tpu_torch.runners import train as train_runner
from pose2room_tpu_torch.train.checkpoint import CheckpointIO
from torch_port_util import SMALL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_YAML = os.path.join(REPO, "configs", "config_files", "p2rnet_train.yaml")
BNS = {"bn_momentum_init": 0.5, "bn_decay_rate": 0.5, "bn_decay_step": 1, "bn_momentum_max": 0.001}


def _config(log_path, epochs, **extra):
    """p2rnet_train.yaml at the SMALL sizes: 1 train step of 2 and 1 val
    step an epoch; the lr drops and the BN momentum halves at epoch 2."""
    config = yaml.safe_load(open(TRAIN_YAML))
    config["data"].update(num_frames=SMALL["num_frames"], num_seeds=SMALL["num_seeds"],
                          num_target=SMALL["num_proposals"], num_gaussian=SMALL["num_gaussian"])
    config["train"].update(epochs=epochs, batch_size=2)
    config["val"]["batch_size"] = 2
    config["device"]["num_workers"] = 2
    config["optimizer"].update(weight_decay=0.01, clip_norm=1.0)
    config["scheduler"]["milestones"] = [1]
    config["bnscheduler"] = dict(BNS)
    config["log"].update(path=str(log_path), print_step=1, save_weight_step=1)
    config.update(extra)
    return config


def _datasets():
    rng = np.random.RandomState(6)
    scenes = [synth.as_stored(*synth.make_scene(rng, n_objects=int(rng.randint(2, 6)), n_frames=120))
              for _ in range(4)]
    return {"train": SceneDataset(scenes[:2], num_frames=SMALL["num_frames"], augment=True),
            "val": SceneDataset(scenes[2:], num_frames=SMALL["num_frames"])}


def _train(config):
    cfg = CONFIG(config, mode="train")
    try:
        model, history = train_runner.run(cfg, device="cpu", datasets=_datasets())
    finally:
        cfg.close()
    with open(os.path.join(cfg.save_path, "log.txt")) as f:
        log = f.read()
    return model, history, cfg.save_path, log


def _load(run_dir, suffix):
    return torch.load(os.path.join(run_dir, f"model_{suffix}.pth"), map_location="cpu", weights_only=True)


def _assert_same_tree(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same_tree(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{where}[{i}]")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def test_resume_equals_uninterrupted_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the TensorBoard board writes to ./runs
    model_a, hist_a, dir_a, log_a = _train(_config(tmp_path / "a", epochs=2))
    _, hist_b1, dir_b1, _ = _train(_config(tmp_path / "b", epochs=1))
    model_b, hist_b, dir_b, log_b = _train(_config(tmp_path / "b", epochs=2, resume=True))

    assert os.path.dirname(dir_b) == os.path.dirname(dir_b1) and dir_b != dir_b1
    resumed_from = os.path.join(os.path.abspath(dir_b1), "model_last_1.pth")
    assert f"Resuming from {resumed_from}" in log_b
    assert "-- Epoch 1/2" not in log_b and "-- Epoch 2/2; lr = 0.0001 --" in log_b
    # the momentum of each epoch, torch convention: 0.5, then 0.25
    assert re.findall(r"Current BN decay momentum :([0-9.]+)\.", log_a) == ["0.500000", "0.250000"]
    assert re.findall(r"Current BN decay momentum :([0-9.]+)\.", log_b) == ["0.250000"]

    assert hist_b1 == hist_a[:1] and hist_b == hist_a[1:]
    _assert_same_tree(model_b.state_dict(), model_a.state_dict(), "net")
    # each checkpoint of the uninterrupted run, against the latest of the
    # same name over the two halves
    names = sorted(f for f in os.listdir(dir_a) if f.endswith(".pth"))
    assert names == ["model_best.pth", "model_final.pth", "model_last_1.pth", "model_last_2.pth"]
    for name in names:
        suffix = name[len("model_"):-len(".pth")]
        run_b = dir_b if os.path.isfile(os.path.join(dir_b, name)) else dir_b1
        _assert_same_tree(_load(run_b, suffix), _load(dir_a, suffix), suffix)
    final = _load(dir_a, "final")
    groups = final["optimizer"]["param_groups"]
    assert [g["name"] for g in groups] == ["backbone", "centervoting", "detection"]
    assert all(g["lr"] == pytest.approx(1e-4, rel=1e-12) and g["weight_decay"] == 0.01 for g in groups)
    steps = {float(s["step"]) for s in final["optimizer"]["state"].values()}
    assert steps == {2.0}  # AdamW's per-parameter count: 1 step an epoch
    assert final["min_loss"] == min(h["val"]["total"] for h in hist_a)
    # The one field where the port's checkpoints differ from the JAX
    # package's on the same run: model_last_<e> holds the min_loss with epoch
    # e's val loss counted.  JAX train/engine.py:243-248 saves model_last_<e>
    # before that loss is counted (inf after epoch 1 here), so a run resumed
    # from it can overwrite model_best with a worse model.
    assert _load(dir_a, "last_1")["min_loss"] == hist_a[0]["val"]["total"]
    assert {m.momentum for m in model_b.modules() if type(m).__name__ == "BatchNorm"} == {0.75}


LAYOUTS = {
    # {run dir: [names]}, the dir CheckpointIO writes into, the expected pick
    "highest_epoch_within_run_dir": (
        {"2026-01-01T00-00-00": ["model_last_2", "model_last_10", "model_best"], "2026-01-02T00-00-00": []},
        "2026-01-02T00-00-00", ("2026-01-01T00-00-00", "model_last_10")),
    "newest_run_dir": (
        {"2026-01-01T00-00-00": ["model_last_99"], "2026-01-03T00-00-00": ["model_last_1"],
         "2026-01-04T00-00-00": []},
        "2026-01-04T00-00-00", ("2026-01-03T00-00-00", "model_last_1")),
    "bare_model_last_loses_to_numbered": (
        {"2026-01-01T00-00-00": ["model_last", "model_last_5"], "2026-01-02T00-00-00": []},
        "2026-01-02T00-00-00", ("2026-01-01T00-00-00", "model_last_5")),
    "none_when_no_checkpoints": ({"2026-01-01T00-00-00": []}, "2026-01-01T00-00-00", None),
}


@pytest.mark.parametrize("suffix", ["", ".pth"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_find_resume_checkpoint(tmp_path, layout, suffix):
    """Without a suffix the names are the JAX package's (Orbax directories)
    and its CheckpointIO must pick the same; with ``.pth`` they are the
    port's files, which the JAX regex ``model_last_(\\d+)$`` would rank as a
    bare ``model_last``."""
    dirs, run, expect = LAYOUTS[layout]
    parent = tmp_path / "train"
    for d, names in dirs.items():
        os.makedirs(parent / d)
        for name in names:
            if suffix:
                (parent / d / f"{name}{suffix}").write_bytes(b"")
            else:
                os.makedirs(parent / d / name)
    found = CheckpointIO(str(parent / run)).find_resume_checkpoint()
    assert found == (None if expect is None else str(parent / expect[0] / f"{expect[1]}{suffix}"))
    if not suffix:
        assert found == JaxCheckpointIO(str(parent / run)).find_resume_checkpoint()


def test_train_finetune_is_partial_and_resume_takes_precedence(tmp_path, monkeypatch):
    """``finetune`` loads each ``weight:`` partially into the train run's
    model (the skip logged); with ``resume`` too, the resume wins and no
    weight is loaded (JAX runners/common.py:78-87)."""
    monkeypatch.chdir(tmp_path)
    model_a, _, dir_a, _ = _train(_config(tmp_path / "a", epochs=1))
    sd = _load(dir_a, "best")["net"]
    head = "detection.conv_sem_obj.2.conv.weight"
    partial = {k: v for k, v in sd.items() if k != head}
    weight = str(tmp_path / "partial.pth")
    torch.save({"net": partial}, weight)

    config = _config(tmp_path / "ft", epochs=0, finetune=True, weight=[weight])
    model, history, _, log = _train(config)
    assert history == []
    assert f"Loading weights from {weight}" in log
    assert f"partial weight load: {len(sd) - 1}/{len(sd)} tensors" in log
    for k, v in sd.items():
        assert torch.equal(model.state_dict()[k], v) != (k == head), k

    model, _, _, log = _train(_config(tmp_path / "a", epochs=1, finetune=True, weight=[weight], resume=True))
    assert "Resuming from" in log and "Loading weights" not in log
    for k, v in model_a.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_weight_url_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="downloading weights is not ported"):
        CheckpointIO(str(tmp_path)).load_weights("https://example.com/model.pth", None)
