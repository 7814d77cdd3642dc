"""The train options of the port against the JAX package, on the CPU.

* ``train.freeze`` and per-module ``optim_spec``: the port's
  ``make_optimizer`` + ``apply_lr_schedule`` against JAX ``make_optimizer``
  + ``apply_lr_schedule`` on the same SMALL P2RNet parameters and the same
  seeded gradients, 3 steps across a milestone, with clipping and weight
  decay; frozen tensors exactly unchanged;
* ``bnscheduler``: ``bnm_momentum`` against JAX's, and the running
  statistics after a train step at another momentum, on the module path
  and the fused train chain;
* ``device.worker_mode: process``: batches bit-equal to thread mode's and
  to the JAX loader's in process mode;
* ``train.h2d_dtype``: the tensors the step sees against JAX
  ``device_prefetch``'s compressed arrays, widened as its step widens them;
* ``LogBoard``: the same scalars, tags and steps as JAX's, read back with
  tensorboard's event reader;
* one CPU train run with process workers, h2d_dtype, a profile window and
  the board: the step's targets, the trace, and the board's steps;
* a ``ProfileWindow`` around a block writes one trace holding its
  ``annotate`` span.
"""

import glob
import os

import numpy as np
import optax
import pytest
import torch
import yaml

import jax

from pose2room_tpu.data import synth as jax_synth
from pose2room_tpu.data.dataset import P2RNetDataset as JaxP2RNetDataset
from pose2room_tpu.data.loader import DataLoader as JaxDataLoader
from pose2room_tpu.parallel import make_mesh
from pose2room_tpu.train import state as jax_state
from pose2room_tpu.train.engine import device_prefetch
from pose2room_tpu.train.step import _decompress
from pose2room_tpu.utils.logger import LogBoard as JaxLogBoard
from pose2room_tpu_torch.config.loader import CONFIG
from pose2room_tpu_torch.convert import state_dict_from_flax
from pose2room_tpu_torch.data import synth
from pose2room_tpu_torch.data.dataset import P2RNetDataset, SceneDataset
from pose2room_tpu_torch.data.loader import DataLoader
from pose2room_tpu_torch.runners import train as train_runner
from pose2room_tpu_torch.train import engine, state
from pose2room_tpu_torch.train.step import GT_KEYS, batch_to_device, train_step
from pose2room_tpu_torch.utils.logger import LogBoard
from pose2room_tpu_torch.utils.profiling import ProfileWindow, annotate
from torch_port_util import SMALL, flax_payload, port_model, scene_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_YAML = os.path.join(REPO, "configs", "config_files", "p2rnet_train.yaml")


@pytest.fixture(scope="module")
def payload():
    return flax_payload(SMALL["num_gaussian"], seed=2)


def _port_params(params, stats):
    sd = state_dict_from_flax({"params": params, "batch_stats": stats})
    return {k: v for k, v in sd.items() if not k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("freeze,specs", [
    (["backbone"], {"detection": {"lr": 1e-4}}),
    (["detection", "centervoting"], {"backbone": {"lr": 2e-3, "weight_decay": 0.05, "betas": [0.8, 0.99]}}),
    ([], {"centervoting": {"lr": 5e-4, "eps": 1e-6}}),
    (["centervoting"], {}),
])
def test_freeze_and_optim_spec_match_optax(payload, freeze, specs):
    """3 steps on identical gradients, the lr dropping by gamma at epoch 1;
    the band of test_torch_train_step.py::test_optimizer_matches_optax."""
    optim_cfg = {"lr": 1e-3, "weight_decay": 0.01, "clip_norm": 1.0}
    milestones, gamma = [1], 0.1
    params, stats = payload["params"], payload["batch_stats"]
    rng = np.random.RandomState(3)
    grads = [jax.tree_util.tree_map(lambda p: (rng.randn(*np.shape(p)) * 3).astype(np.float32), params)
             for _ in range(3)]

    tx, info = jax_state.make_optimizer(optim_cfg, freeze=tuple(freeze), phase_specs=specs)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(g, opt_state, jparams):
        updates, opt_state = tx.update(g, opt_state, jparams)
        return optax.apply_updates(jparams, updates), opt_state

    jparams = params
    model = port_model(SMALL, payload)
    named = dict(model.named_parameters())
    initial = {k: p.detach().clone() for k, p in named.items()}
    optimizer, base_lrs, clip_norm = state.make_optimizer(model, optim_cfg, tuple(freeze), specs)
    assert sorted(base_lrs) == sorted({"backbone", "centervoting", "detection"} - set(freeze))
    for epoch, g in enumerate(grads):
        factor = gamma ** sum(1 for m in milestones if epoch >= m)
        opt_state = jax_state.apply_lr_schedule(opt_state, factor, info)
        jparams, opt_state = jax_step(g, opt_state, jparams)

        state.apply_lr_schedule(optimizer, base_lrs, state.lr_factor(milestones, gamma, epoch))
        for group in optimizer.param_groups:
            base = specs.get(group["name"], {}).get("lr", optim_cfg["lr"])
            assert group["lr"] == pytest.approx(base * factor, rel=1e-12), group["name"]
        port_grads = _port_params(g, stats)
        for k, p in named.items():
            p.grad = port_grads[k].clone()
        grad_list = [p.grad for p in named.values()]
        norm = state.global_norm(grad_list)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        state.clip_by_global_norm(grad_list, clip_norm, norm)
        optimizer.step()

        want = _port_params(jax.tree_util.tree_map(np.asarray, jparams), stats)
        for k, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), atol=1e-6, rtol=0,
                                       err_msg=f"step {epoch} {k}")
            if k.split(".")[0] in freeze:
                assert torch.equal(p.detach(), initial[k]), k
                assert torch.equal(want[k], initial[k]), f"JAX {k}"
            else:
                assert not torch.equal(p.detach(), initial[k]), k


BNS = {"bn_momentum_init": 0.5, "bn_decay_rate": 0.5, "bn_decay_step": 20, "bn_momentum_max": 0.001}


@pytest.mark.parametrize("epoch", [0, 1, 19, 20, 39, 40, 100, 500])
def test_bnm_momentum_matches_jax(epoch):
    assert state.bnm_momentum(BNS, epoch) == jax_state.bnm_momentum(BNS, epoch)


@pytest.mark.parametrize("fused_train", [True, False])
def test_running_stats_follow_bn_momentum(payload, fused_train):
    """One train step from the same state at keep-rate 0.9 and at 0.6:
    every running statistic moves by (1 - m) (batch stat - running), so the
    move at 0.6 is 4x the move at 0.9, on the fused train chain's BNs (read
    through ``update_running_stats``) and on the module path's."""
    batch = batch_to_device(scene_batch(5, 2, SMALL["num_frames"]), "cpu")
    moved = {}
    for m in (0.9, 0.6):
        model = port_model(SMALL, payload, fused_train=fused_train)
        before = {k: b.clone() for k, b in model.named_buffers() if k.endswith(("running_mean", "running_var"))}
        model.set_bn_momentum(m)
        optimizer, _, _ = state.make_optimizer(model, {"lr": 1e-3})
        eps = model.mdn_eps(2, torch.Generator().manual_seed(1))
        train_step(model, optimizer, batch, eps=eps)
        moved[m] = {k: dict(model.named_buffers())[k] - v for k, v in before.items()}
    assert any(".st_gcn_networks." in k for k in moved[0.9])
    for k, d in moved[0.9].items():
        scale = d.abs().max().item()
        assert scale > 0, k
        torch.testing.assert_close(moved[0.6][k], 4 * d, atol=1e-5 * scale + 1e-7, rtol=0, msg=k)


def test_process_loader_matches_thread_and_jax(tmp_path):
    jax_synth.write_synthetic_dataset(str(tmp_path / "ds"), n_train=5, n_test=2, seed=4, n_frames=90)
    split = str(tmp_path / "ds" / "splits" / "script_level" / "train.json")
    kw = dict(num_frames=64, augment=True)
    loaders = [
        DataLoader(P2RNetDataset(split, **kw), batch_size=2, shuffle=True, seed=3, num_workers=2,
                   worker_mode="process"),
        DataLoader(P2RNetDataset(split, **kw), batch_size=2, shuffle=True, seed=3, num_workers=2),
        JaxDataLoader(JaxP2RNetDataset(split, **kw), batch_size=2, shuffle=True, seed=3, num_workers=2,
                      worker_mode="process"),
    ]
    try:
        for epoch in (0, 1):
            for loader in loaders:
                loader.set_epoch(epoch)
            batches = list(zip(*loaders))
            assert len(batches) == 3
            for proc, thread, ref in batches:
                assert proc["sample_idx"] == thread["sample_idx"] == ref["sample_idx"]
                for k in proc:
                    if k != "sample_idx":
                        assert proc[k].dtype == ref[k].dtype, k
                        np.testing.assert_array_equal(proc[k], thread[k], err_msg=k)
                        np.testing.assert_array_equal(proc[k], ref[k], err_msg=f"JAX {k}")
    finally:
        loaders[0].close()
        loaders[1].close()
        loaders[2]._pool.shutdown()


@pytest.mark.parametrize("h2d_dtype", ["float16", None])
def test_h2d_dtype_matches_jax_device_prefetch(h2d_dtype):
    batch = scene_batch(3, 2, SMALL["num_frames"])
    mesh = make_mesh(jax.devices()[:1])
    (compressed,) = list(device_prefetch(iter([batch]), mesh, h2d_dtype=h2d_dtype))
    widened = _decompress(compressed)
    got = batch_to_device(batch, "cpu", h2d_dtype)
    assert set(got) == {"input_joints", *GT_KEYS}
    for k, v in got.items():
        ref = np.asarray(widened[k])
        if batch[k].dtype == np.float32:
            want = np.float16 if h2d_dtype and k != "input_joints" else np.float32
            assert compressed[k].dtype == want and v.dtype == torch.float32 and ref.dtype == np.float32, k
        np.testing.assert_array_equal(v.numpy(), ref, err_msg=k)  # ints: JAX holds them in int32
    np.testing.assert_array_equal(got["input_joints"].numpy(), batch["input_joints"])


def _scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_logboard_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    updates = [({"total": rng.rand() * 10, "vote_loss": rng.rand(), "grad_norm": rng.rand() * 100}, step, "train")
               for step in (1, 2, 3)]
    updates.append(({"total": rng.rand() * 10, "vote_loss": rng.rand()}, 3, "val"))
    for cls, d in ((LogBoard, "port"), (JaxLogBoard, "jax")):
        board = cls(str(tmp_path / d))
        for values, step, phase in updates:
            board.update(values, step, phase)
        board.close()
    got = _scalars(tmp_path / "port")
    assert got == _scalars(tmp_path / "jax")
    assert sorted(got) == ["grad_norm/train", "total/train", "total/val", "vote_loss/train", "vote_loss/val"]
    assert [s for s, _ in got["total/train"]] == [1, 2, 3] and [s for s, _ in got["total/val"]] == [3]
    np.testing.assert_allclose([v for _, v in got["total/val"]], [updates[-1][0]["total"]], rtol=1e-7)


def test_train_run_with_options(tmp_path, monkeypatch):
    """One epoch of 4 train steps (batch 1) and 1 val step with process
    workers, ``h2d_dtype: float16`` and ``profile_steps: 1``: every step
    sees the float16-rounded targets of the loader's batches and the
    unrounded input; the trace of step 3 is written under
    ``<save_path>/profile/``; the board logs train steps 1-4 and the val
    step at 4 under ./runs."""
    monkeypatch.chdir(tmp_path)
    config = yaml.safe_load(open(TRAIN_YAML))
    config["data"].update(num_frames=SMALL["num_frames"], num_seeds=SMALL["num_seeds"],
                          num_target=SMALL["num_proposals"], num_gaussian=SMALL["num_gaussian"])
    config["train"].update(epochs=1, batch_size=1, h2d_dtype="float16")
    config["val"]["batch_size"] = 2
    config["device"].update(num_workers=1, worker_mode="process")
    config["log"].update(path=str(tmp_path / "out"), print_step=1, profile_steps=1)
    rng = np.random.RandomState(2)
    scenes = [synth.as_stored(*synth.make_scene(rng, n_objects=3, n_frames=120)) for _ in range(6)]
    datasets = {"train": SceneDataset(scenes[:4], num_frames=SMALL["num_frames"], augment=True),
                "val": SceneDataset(scenes[4:], num_frames=SMALL["num_frames"])}
    seen = []

    def recording_step(model, optimizer, batch, **kw):
        seen.append({k: v.clone() for k, v in batch.items()})
        return train_step(model, optimizer, batch, **kw)

    monkeypatch.setattr(engine, "train_step", recording_step)
    cfg = CONFIG(config, mode="train")
    try:
        _, history = train_runner.run(cfg, device="cpu", datasets=datasets)
    finally:
        cfg.close()
    assert np.isfinite(history[0]["train"]["total"])

    host = DataLoader(datasets["train"], batch_size=1, shuffle=True, seed=42, num_workers=0)
    host.set_epoch(0)
    host_batches = list(host)
    assert len(seen) == len(host_batches) == 4
    for got, batch in zip(seen, host_batches):
        assert torch.equal(got["input_joints"], torch.from_numpy(batch["input_joints"]))
        for k in GT_KEYS:
            want = batch[k].astype(np.float16).astype(np.float32) if batch[k].dtype == np.float32 else batch[k]
            np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)

    traces = glob.glob(os.path.join(cfg.save_path, "profile", "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert '"p2r/train/step"' in f.read()
    (events,) = glob.glob(str(tmp_path / "runs"))
    scalars = _scalars(events)
    assert [s for s, _ in scalars["total/train"]] == [1, 2, 3, 4]
    assert [s for s, _ in scalars["total/val"]] == [4]
    np.testing.assert_allclose(np.mean([v for _, v in scalars["total/train"]]), history[0]["train"]["total"],
                               rtol=1e-6)


def test_trace_writes_the_block_with_its_spans(tmp_path):
    window = ProfileWindow(tmp_path / "trace", start_step=0, n_steps=1)
    window.maybe_start(0)
    with annotate("scaled_sum"):
        (torch.arange(8.0) * 2.0).sum()
    window.maybe_stop(1)
    (path,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    with open(path) as f:
        assert '"p2r/scaled_sum"' in f.read()
