"""The port's tensor-parallel mode (``device.model_parallel``) on the CPU.

* the placement plan at the SMALL sizes against JAX ``shard_params`` on
  ``make_mesh(model_parallel=2 / 4)`` (the 8 virtual CPU devices of
  conftest.py), mapped through the port's key map, and the 22 leaves it
  must name; the grid against ``make_mesh``'s device layout, and the
  ValueError of a tp that does not divide the processes;
* two spawned gloo ranks (``tests/torch_ddp_worker.py``) at tp = 2, one
  model group of two, global batch 4: two AdamW steps with clipping on the
  fused train chain and the module path in float64 against one process at
  batch 4 (test_torch_ddp.py's bands), their step-1 gradients gathered
  against JAX's tensor-parallel f32 step, each rank's half of each planned
  weight and of its moments, the replicated tensors bit-equal on both
  ranks; the train runner resuming a one-process checkpoint under tp = 2
  against one process resuming it (lr 0, ROADMAP §3), its final checkpoint
  loaded strict into one process; the sparse_eval test runner's merged AP
  and losses and the demo's dumps against one process;
* two more ranks in bf16, started once the first two have finished: two
  steps on both train paths, whose reduced
  sums equal one process's sums of the same terms within f32 rounding and
  whose losses, gradients and running statistics are held against JAX's
  tensor-parallel bf16 step by the spread of JAX's own single-device and
  tensor-parallel steps (test_torch_ddp.py's ``reduced_sums_gaps`` and
  ``hold_bf16_step``), the replicated tensors bit-equal on both ranks; the
  bf16 train runner against one process; sharded multi-mode and mesh-AP
  test runs (f32 and bf16) against one process fed the group's draws.  The
  train runs here write no TensorBoard board (``torch_ddp_worker.quiet_board``): on
  this host its import loads TensorFlow, ~17 s a process.
"""

import glob
import os

import flax.linen as nn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose2room_tpu.models.loss import detection_loss as jax_detection_loss
from pose2room_tpu.parallel import make_mesh, shard_batch, shard_params
from pose2room_tpu_torch import parallel
from pose2room_tpu_torch.config.loader import CONFIG
from pose2room_tpu_torch.convert import state_dict_from_flax
from pose2room_tpu_torch.data.dataset import SceneDataset
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
from pose2room_tpu_torch.parallel.tensor import MIN_SIZE, model_plan, shard_state_dict, tensor_plan
from pose2room_tpu_torch.runners import demo as demo_runner
from pose2room_tpu_torch.runners import test as test_runner
from pose2room_tpu_torch.runners import train as train_runner
from pose2room_tpu_torch.runners.common import setup
from pose2room_tpu_torch.train import engine
from pose2room_tpu_torch.train.state import make_optimizer
from pose2room_tpu_torch.train.step import GT_KEYS, batch_to_device, train_step
from test_torch_ddp import (
    COUNT_LOSSES,
    OPTIMIZER,
    _flax_payload,
    _jax_eps,
    _jax_step,
    _rel,
    _scenes,
    _single_steps,
    _test_config,
    _train_config,
    bf16_one_process,
    forced_sequence,
    hold_bf16_step,
    hold_sharded_test_runs,
    jax_bf16_step,
    mesh_test_config,
    reduced_sums_gaps,
)
from torch_ddp_worker import BF16_RANK_THREADS, RANK_THREADS, Ranks, quiet_board
from torch_port_util import SMALL, jax_model, scene_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_CLIP = os.path.join(REPO, "demo", "inputs", "input_joints_1.npy")

# the leaves JAX shards at the port's widths (ISSUE table), as port keys
PLANNED = (
    [f"backbone.st_gcn_networks.{i}.gcn.conv.weight" for i in range(6)]
    + ["backbone.conv_joint.weight", "centervoting.conv_input.0.conv.weight", "centervoting.conv_input.1.conv.weight",
       "detection.vote_aggregation.mlp_module.0.weight", "detection.vote_aggregation.mlp_module.2.weight"]
    + [f"detection.conv_{h}.{i}.conv.weight" for h in ("center", "size", "heading", "sem_obj") for i in (0, 1)]
    + [f"detection.gmm_{h}.backbone.conv.weight" for h in ("center", "size", "heading")]
)


# ---------------------------------------------------------------------------
# the plan and the grid, in one process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flax_variables():
    """A flax init at the SMALL sizes (numpy leaves)."""
    return _flax_payload(5)


@pytest.mark.parametrize("tp", [2, 4])
def test_plan_matches_jax_shard_params(flax_variables, tp):
    """The port's plan names exactly the tensors whose flax leaves JAX
    ``shard_params`` places on the model axis (each leaf marked and carried
    through ``state_dict_from_flax``), the 22 weights of the table, 1646592
    of the parameters."""
    mesh = make_mesh(model_parallel=tp)
    placed = shard_params(flax_variables["params"], mesh)
    marks = jax.tree_util.tree_map(
        lambda x: np.full(x.shape, float("model" in (x.sharding.spec or ())), np.float32), placed)
    zeros = jax.tree_util.tree_map(np.zeros_like, flax_variables["batch_stats"])
    jax_keys = {k for k, v in state_dict_from_flax({"params": marks, "batch_stats": zeros}).items() if v.any()}
    model = P2RNet(P2RNetConfig(**SMALL), device="cpu")
    plan = model_plan(model, tp)
    assert set(plan) == jax_keys == set(PLANNED) and len(plan) == 22
    assert sum(model.get_parameter(k).numel() for k in plan) == 1646592
    # the rule on the flax shapes: a kernel's output dim is the port's dim 0
    assert tensor_plan({"a.weight": (64, 512), "b.weight": (63, 512), "edge": (11, 53, 53)}, 2) == ["a.weight"]
    assert tensor_plan({"a.weight": (64, MIN_SIZE // 64 - 1)}, 2) == []


@pytest.mark.parametrize("world, tp", [(2, 2), (4, 2), (8, 4)])
def test_grid_matches_make_mesh(world, tp):
    """Rank r at (r // tp, r % tp), JAX make_mesh's device layout; a tp that
    does not divide the world raises, as JAX asserts."""
    mesh = make_mesh(jax.devices()[:world], model_parallel=tp)
    assert mesh.axis_names == ("data", "model")
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    first = jax.devices()[0].id
    np.testing.assert_array_equal(parallel.grid_layout(world, tp), ids - first)
    with pytest.raises(ValueError, match="model_parallel"):
        parallel.grid_layout(world, tp + 1 if world % (tp + 1) else 3)
    with pytest.raises(AssertionError):
        make_mesh(jax.devices()[:world], model_parallel=world + 1)


def test_one_process_with_tp_raises(monkeypatch):
    """No process group (one process) and tp 2: ValueError, no fallback to
    tp 1; tp 1 installs no grid."""
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="1 % 2"):
        parallel.make_grid(parallel.model_parallel_of({"device": {"model_parallel": 2}}))
    assert parallel.make_grid(1) is None and parallel.model_parallel() == 1
    assert parallel.batch_shard() == (0, 1) and parallel.data_count() == 1


def test_weight_bridge_round_trip(flax_variables):
    """A flax tree reaches a tensor-parallel rank: ``shard_state_dict`` of
    its state_dict is each rank's block of dim 0 of the planned tensors;
    the blocks concatenated in rank order are the whole tensor."""
    full = state_dict_from_flax(flax_variables)
    plan = tensor_plan({k: v.shape for k, v in full.items()}, 2)
    shards = [shard_state_dict(full, plan, r, 2) for r in range(2)]
    for k, v in full.items():
        if k in plan:
            assert shards[0][k].shape[0] == v.shape[0] // 2
            assert torch.equal(torch.cat([s[k] for s in shards]), v), k
        else:
            assert shards[1][k] is v


# ---------------------------------------------------------------------------
# two ranks at tp = 2 against one process
# ---------------------------------------------------------------------------

def _resume_checkpoint(root, config):
    """A one-process checkpoint after one train step at the config's lr,
    as ``model_last_1`` of a run dir under the config's log path."""
    cfg = CONFIG(config, mode="train")
    try:
        model, optimizer, _, clip_norm, checkpoint, _, _ = setup(cfg, "cpu")
        batch = batch_to_device(scene_batch(45, 4, SMALL["num_frames"]), "cpu")
        train_step(model, optimizer, batch, generator=torch.Generator().manual_seed(1), clip_norm=clip_norm)
        return checkpoint.save("last_1", model, optimizer, 1, float("inf"))
    finally:
        cfg.close()


def _demo_config(root, weight, model_parallel=1):
    config = _test_config(root, weight)
    config["device"]["model_parallel"] = model_parallel
    demo_dir = os.path.join(root, "demo")
    os.makedirs(os.path.join(demo_dir, "inputs"), exist_ok=True)
    clip = np.load(DEMO_CLIP)
    np.save(os.path.join(demo_dir, "inputs", "clip_a.npy"), clip)
    np.save(os.path.join(demo_dir, "inputs", "clip_b.npy"), clip[::-1].copy())
    config.update(demo_path=demo_dir)
    return config


def _jax_tp_step(payload, batch, key, tp=2):
    """JAX's f32 step on a global batch with ``shard_params`` on
    ``make_mesh(model_parallel=tp)`` and the batch on its data axis: losses
    and gradients, the gradients as a state_dict."""
    model = jax_model(SMALL)
    mesh = make_mesh(model_parallel=tp)
    params = shard_params(payload["params"], mesh)
    stats = shard_params(payload["batch_stats"], mesh)
    jbatch = shard_batch(batch, mesh)

    @jax.jit
    def loss_and_grad(params, jbatch):
        def loss_fn(p):
            out, _ = model.apply({"params": p, "batch_stats": stats}, jbatch["input_joints"], train=True,
                                 rngs={"mdn": key}, mutable=["batch_stats"])
            losses = jax_detection_loss(out, {k: jbatch[k] for k in GT_KEYS})
            return losses["total"], losses

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, losses), grads = loss_and_grad(params, jbatch)
    grads = jax.tree_util.tree_map(np.asarray, grads)
    return {k: float(v) for k, v in losses.items()}, state_dict_from_flax(
        {"params": grads, "batch_stats": payload["batch_stats"]})


def _dense_case():
    """A bf16 column-parallel layer's operands at tp 2: x (64, 512) f32, w
    (256, 512), bias and the output gradient, from a seed."""
    rng = np.random.RandomState(9)
    return {"tp": 2, "x": torch.from_numpy(rng.randn(64, 512).astype(np.float32)),
            "w": torch.from_numpy((rng.randn(256, 512) / 16).astype(np.float32)),
            "b": torch.from_numpy((rng.randn(256) * 0.1).astype(np.float32)),
            "dy": torch.from_numpy(rng.randn(64, 256).astype(np.float32))}


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory, flax_variables):
    """Starts two ranks at tp = 2 on every scenario, then computes JAX's
    tensor-parallel step while they run.  Yields (the case, the ranks)."""
    root = tmp_path_factory.mktemp("tp")
    payload = flax_variables
    batch = scene_batch(44, 4, SMALL["num_frames"])  # test_torch_ddp.py's global batch
    key = jax.random.PRNGKey(11)
    eps = _jax_eps(jax_model(SMALL), payload, jnp.asarray(batch["input_joints"]), key)
    weights = P2RNet(P2RNetConfig(**SMALL), device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    weights["detection.gmm_size.mdn.mu"].fill_(2 * np.log(1.5) / SMALL["num_gaussian"])  # ~1.5 m boxes: AP > 0
    weight_path = str(root / "weights.pth")
    torch.save({"net": weights}, weight_path)
    scenes = _scenes(6, 12)
    resume_root = str(root / "resume")
    resume_checkpoint = _resume_checkpoint(resume_root, _train_config(resume_root, batch=4, lr=OPTIMIZER["lr"]))

    def resume_config(batch, model_parallel):
        config = _train_config(resume_root, batch=batch)  # lr 0: see test_torch_ddp.py
        config["train"]["epochs"] = 2
        config["device"]["model_parallel"] = model_parallel
        config.update(resume=True)
        return config

    test_config = _test_config(str(root / "tp_test"), weight_path)
    test_config["device"]["model_parallel"] = 2
    inputs = {
        "tp_steps": {"sizes": SMALL, "state_dict": state_dict_from_flax(payload), "batch": batch, "eps": eps,
                     "optimizer": OPTIMIZER, "tp": 2, "paths": [True, False]},
        "tp_train_run": {"config": resume_config(2, 2), "num_frames": SMALL["num_frames"],
                         "scenes": {"train": scenes[:4], "val": scenes[4:8]}},
        "tp_test_run": {"config": test_config, "num_frames": SMALL["num_frames"], "scenes": scenes[8:12]},
        "demo_run": {"config": _demo_config(str(root / "tp_demo"), weight_path, model_parallel=2)},
    }
    ranks = Ranks(2, inputs, root / "ranks")
    try:
        yield {"inputs": inputs, "root": root, "weight_path": weight_path, "resume_config": resume_config(4, 1),
               "resume_checkpoint": resume_checkpoint, "scenes": scenes, "key": key, "payload": payload,
               "jax_step": _jax_tp_step(payload, batch, key), "jax_single": _jax_step(payload, batch, key)}, ranks
    finally:
        ranks.close()


@pytest.fixture(scope="module")
def tp_bf16(tp_ranks):
    """The bf16 scenarios at tp = 2 on two new ranks, started once
    ``tp_ranks``' have finished (as test_torch_ddp.py's ``ddp_bf16``): the
    bf16 steps of ``tp_ranks``' batch, the bf16 train runner, the sharded
    test runs and a column-parallel bf16 layer; JAX's single-device and
    tensor-parallel bf16 steps are computed while they run.  Yields (the
    case, the ranks)."""
    case, first = tp_ranks
    first.results()
    root, payload, key, scenes = case["root"], case["payload"], case["key"], case["scenes"]
    steps = case["inputs"]["tp_steps"]
    bf16_run = _train_config(str(root / "tp_bf16_train"), batch=2)
    bf16_run["model"] = {**(bf16_run.get("model") or {}), "compute_dtype": "bfloat16"}
    bf16_run["device"]["model_parallel"] = 2
    test_runs = [mesh_test_config(str(root / f"tp_test_{k}"), case["weight_path"], dtype, multi_mode,
                                  model_parallel=2)
                 for k, (dtype, multi_mode) in enumerate([("float32", True)] * 2 + [("bfloat16", True)] * 2
                                                         + [("bfloat16", False)])]
    inputs = {
        "tp_bf16_steps": steps,
        "tp_bf16_train_run": {"config": bf16_run, "num_frames": SMALL["num_frames"],
                              "scenes": {"train": scenes[:4], "val": scenes[4:8]}},
        "tp_test_runs": {"configs": test_runs, "num_frames": SMALL["num_frames"], "scenes": scenes[8:12]},
        "tp_dense_grad": _dense_case(),
    }
    ranks = Ranks(2, inputs, root / "bf16_ranks", threads=BF16_RANK_THREADS)
    try:
        mesh = make_mesh(model_parallel=2)
        jax_bf16 = {(kind, fused): jax_bf16_step(payload, steps["batch"], key, fused, mesh if kind == "tp" else None,
                                                 tp=kind == "tp")
                    for fused in (True, False) for kind in ("single", "tp")}
        yield {"inputs": inputs, "weight_path": case["weight_path"], "jax_bf16": jax_bf16}, ranks
    finally:
        ranks.close()


def test_tp_steps_match_one_process(tp_ranks):
    """Both train paths, float64: the two ranks' (gathered) state after two
    AdamW steps with weight decay and clipping, and their losses, against one
    process at batch 4, in test_torch_ddp.py's bands (1e-5 relative for the
    state, 1e-6 for the losses; the module path's conv biases get a gradient
    of rounding size, held to its size and the two steps of <= lr it takes)."""
    case, ranks = tp_ranks
    got = [r["tp_steps"] for r in ranks.results()]
    for fused in (True, False):
        losses, state = _single_steps(case["inputs"]["tp_steps"], fused)
        res = got[0][fused]
        for step in range(2):
            for k, v in losses[step].items():
                assert abs(res["losses"][step][k] - v) <= 1e-6 * max(abs(v), 1.0), (fused, step, k)
        for k, v in state.items():
            if not v.is_floating_point():
                continue
            assert torch.equal(got[1][fused]["state"][1][k], res["state"][1][k]), k
            if k.endswith("tcn.2.bias") and not fused:
                scale = res["grads"][k[:-6] + "3.bias"].abs().max()
                assert res["grads"][k].abs().max() <= 1e-9 * scale, k
                assert (res["state"][1][k] - v).abs().max() <= 4 * OPTIMIZER["lr"], k
                continue
            assert _rel(res["state"][1][k], v) <= 1e-5, (fused, k, _rel(res["state"][1][k], v))


@pytest.mark.parametrize("fused", [True, False], ids=["fused_chain", "module_path"])
def test_tp_step_matches_jax_tensor_parallel(tp_ranks, fused):
    """The ranks' first step (float64, gradients reduced and gathered)
    against JAX's f32 step under ``shard_params`` on a (data 4, model 2)
    mesh, on the same batch and noise, in test_torch_ddp.py's bands: losses
    within 1e-4 relative, every gradient within 1e-3 of its max of JAX's
    single-device step, and of JAX's tensor-parallel one or within three
    times that step's own distance from the single-device one.  GSPMD's f32
    reductions round otherwise, and the f32 train gradients are
    ill-conditioned (ROADMAP §3): on this batch JAX's two steps part by up
    to 3.1e-3 of max|g| (gcn4's kernel), while the port's float64 gradients
    are within 1.6e-5 of JAX's single-device ones."""
    case, ranks = tp_ranks
    want_losses, want_grads = case["jax_step"]
    _, single_grads = case["jax_single"]
    got = ranks.results()[0]["tp_steps"][fused]
    assert got["losses"][0]["pos_ratio"] > 0
    for k, v in want_losses.items():
        assert abs(got["losses"][0][k] - v) <= 1e-4 * max(abs(v), 1e-3), (k, got["losses"][0][k], v)
    for k, g in got["grads"].items():
        if k.endswith("tcn.2.bias"):
            continue  # analytically zero (BN2 absorbs it): rounding noise on both sides
        want, single = want_grads[k].double(), single_grads[k].double()
        assert _rel(g, single) <= 1e-3, (k, _rel(g, single))
        assert _rel(g, want) <= max(1e-3, 3 * _rel(want, single)), (k, _rel(g, want), _rel(want, single))


def test_tp_ranks_hold_their_shards(tp_ranks):
    """Each rank holds half of each planned weight and of its two AdamW
    moments, and the whole of every other tensor, which is bit-equal on both
    ranks after two steps; the bytes of parameters and moments drop by half
    of the planned ones; 0 kernel launches on the CPU."""
    _, ranks = tp_ranks
    got = [r["tp_steps"] for r in ranks.results()]
    full = {k: v.shape for k, v in ranks.results()[0]["tp_steps"][True]["state"][0].items()}
    n_all = sum(int(np.prod(s)) for k, s in full.items() if not k.endswith(("running_mean", "running_var")))
    n_planned = sum(int(np.prod(full[k])) for k in PLANNED)
    for fused in (True, False):
        for res in (got[0][fused], got[1][fused]):
            for k, shape in res["shapes"].items():
                want = (full[k][0] // 2, *full[k][1:]) if k in PLANNED else tuple(full[k])
                assert shape == want and res["moment_shapes"][k] == want, k
            assert res["bytes"] == 8 * 3 * (n_all - n_planned // 2)
            assert res["launches"] == {}
        for k, v in got[0][fused]["replicated"].items():
            assert torch.equal(got[1][fused]["replicated"][k], v), k
        for k in PLANNED:  # the gathered state is one shard after the other
            assert torch.equal(got[0][fused]["state"][1][k], got[1][fused]["state"][1][k]), k


def test_tp_train_runner_resumes_one_process_checkpoint(tp_ranks, tmp_path, monkeypatch):
    """The train runner under tp = 2 (batch 2 a rank) resumes a one-process
    checkpoint (whole, then sharded with its AdamW moments) and runs epoch
    2 as one process resuming it at batch 4 does: the epoch's mean losses,
    the running statistics and the moments within 1e-5 relative,
    parameters equal (lr 0); its model_final.pth, written by rank 0 from
    the gathered shards, loads strict into one process and equals the
    ranks' gathered state, optimizer state included."""
    case, ranks = tp_ranks
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(engine, "LogBoard", quiet_board)
    cfg = CONFIG(case["resume_config"], mode="train")
    try:
        datasets = {k: SceneDataset(v, num_frames=SMALL["num_frames"], augment=False)
                    for k, v in case["inputs"]["tp_train_run"]["scenes"].items()}
        model, history = train_runner.run(cfg, device="cpu", datasets=datasets)
        one_final = torch.load(os.path.join(cfg.save_path, "model_final.pth"), weights_only=True)
    finally:
        cfg.close()
    got = [r["tp_train_run"] for r in ranks.results()]
    assert got[0]["save_path"] == got[1]["save_path"] and got[0]["sharded"] == PLANNED
    assert len(history) == len(got[0]["history"]) == 1
    for phase in ("train", "val"):
        for k, v in history[0][phase].items():
            assert abs(got[0]["history"][0][phase][k] - v) <= 1e-5 * max(abs(v), 1e-3), (phase, k)
    ckpt = torch.load(os.path.join(got[0]["save_path"], "model_final.pth"), weights_only=True)
    one = P2RNet(P2RNetConfig(**SMALL), device="cpu")
    one.load_state_dict(ckpt["net"], strict=True)
    optimizer, _, _ = make_optimizer(one, cfg.config["optimizer"])
    optimizer.load_state_dict(ckpt["optimizer"])
    for k, v in got[0]["full_state"].items():
        assert torch.equal(ckpt["net"][k], v), k
        want = one_final["net"][k]
        if k.endswith(("running_mean", "running_var")):
            assert _rel(v, want) <= 1e-5, k
        else:
            assert torch.equal(v, want), k  # lr 0
    # epoch 2's one step moved each moment by (1 - beta) g or (1 - beta) g^2
    # from the loaded one: the two runs' increments agree within the f32
    # train gradients' rounding (ROADMAP §3); a moment that was not sharded
    # with its weight would carry another block of the loaded moment
    start = torch.load(case["resume_checkpoint"], weights_only=True)["optimizer"]["state"]
    for i, state in one_final["optimizer"]["state"].items():
        for name, beta in (("exp_avg", 0.9), ("exp_avg_sq", 0.999)):
            got_inc = ckpt["optimizer"]["state"][i][name] - beta * start[i][name]
            want_inc = state[name] - beta * start[i][name]
            assert ckpt["optimizer"]["state"][i][name].shape == state[name].shape
            assert _rel(got_inc, want_inc) <= 1e-2, (i, name, _rel(got_inc, want_inc))
    assert ckpt["epoch"] == one_final["epoch"] == 2


def test_tp_test_runner_matches_one_process(tp_ranks, tmp_path):
    """The sparse_eval test runner under the model group of two (batch 1 a
    rank, 2 the group) against one process at batch 2: per-class AP,
    recall, mAP and AR within 1e-6, the mean losses within 1e-6 relative."""
    case, ranks = tp_ranks
    inputs = case["inputs"]["tp_test_run"]
    config = _test_config(str(tmp_path), case["weight_path"])
    config["test"]["batch_size"] = 2
    cfg = CONFIG(config, mode="test")
    try:
        want = test_runner.run(cfg, device="cpu",
                               dataset=SceneDataset(inputs["scenes"], num_frames=SMALL["num_frames"]))
        want_losses = cfg.test_summary["mean_losses"]
    finally:
        cfg.close()
    assert want[0.05]["mAP"] > 0
    for r in [r["tp_test_run"] for r in ranks.results()]:
        for t, metrics in want.items():
            assert list(r["metrics"][t]) == list(metrics)
            for k, v in metrics.items():
                assert abs(r["metrics"][t][k] - v) <= 1e-6, (t, k)
        for k, v in want_losses.items():
            assert abs(r["mean_losses"][k] - v) <= 1e-6 * max(abs(v), 1.0), k


def test_tp_demo_matches_one_process(tp_ranks, tmp_path):
    """The demo under the model group of two serves every clip; rank 0's
    dumps equal one process's byte for byte, and rank 1 writes none."""
    case, ranks = tp_ranks
    cfg = CONFIG(_demo_config(str(tmp_path), case["weight_path"]), mode="demo")
    threads = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)  # the ranks': the CPU's matmuls round by their thread count
    try:
        want = demo_runner.run(cfg, device="cpu")
        want_dir = cfg.config["log"]["vis_path"]
    finally:
        torch.set_num_threads(threads)
        cfg.close()
    got = [r["demo_run"] for r in ranks.results()]
    assert [r["results"] for r in got] == [[(os.path.basename(p), n) for p, _, n, _ in want]] * 2
    assert got[1]["writes"] == [] and len(got[0]["writes"]) >= 2 * len(want)
    files = sorted(os.path.relpath(f, want_dir) for f in glob.glob(os.path.join(want_dir, "**", "*"), recursive=True)
                   if os.path.isfile(f))
    assert files and files == sorted(
        os.path.relpath(f, got[0]["vis_path"]) for f in glob.glob(os.path.join(got[0]["vis_path"], "**", "*"),
                                                                 recursive=True) if os.path.isfile(f))
    for f in files:
        with open(os.path.join(want_dir, f), "rb") as a, open(os.path.join(got[0]["vis_path"], f), "rb") as b:
            assert a.read() == b.read(), f


# ---------------------------------------------------------------------------
# bf16 and the sharded test runs at tp = 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused_chain", "module_path"])
def test_tp_bf16_reduced_sums_match_one_process(tp_bf16, fused):
    """The bf16 step 1 at tp = 2 (one model group, so each rank's data
    group is itself): every sum the step reduces is the rank's own,
    bit-equal on both ranks, and within f32 rounding of each entry's sum of
    |terms| of one process's sums over the same terms (test_torch_ddp.py's
    ``test_ddp_bf16_reduced_sums_match_one_process``); the group holds rows
    0, 2, 1, 3 of the batch."""
    case, ranks = tp_bf16
    logs = [r["tp_bf16_steps"][fused]["sums"] for r in ranks.results()]
    one = bf16_one_process(case["inputs"]["tp_bf16_steps"], fused, forced_sequence(logs[:1], [[0, 2, 1, 3]], 1))
    worst = reduced_sums_gaps(logs, one["sums"], group=[0], data_count=1)
    assert set(worst) == ({"bn", "BN1", "kernel 3", "BN2 backward", "kernel 4"} if fused else {"bn"})
    assert max(worst.values()) <= 1, worst


@pytest.mark.parametrize("fused", [True, False], ids=["fused_chain", "module_path"])
def test_tp_bf16_step_matches_jax_tensor_parallel(tp_bf16, fused):
    """The bf16 step at tp = 2 against JAX's bf16 step under
    ``shard_params`` on a (data 4, model 2) mesh and against the port's one
    process, by test_torch_ddp.py's ``hold_bf16_step`` (the band three times
    the distance of JAX's single-device and tensor-parallel steps); the seeds
    equal one process's (the proposals may not, as in test_torch_ddp.py);
    after two steps each rank holds half
    of each planned weight and of its moments, the gathered states are
    bit-equal on both ranks and so is every replicated tensor, AdamW
    moments included.  The bf16 input gradients of the column-parallel
    layers are summed over the model group in f32 and rounded to bf16 once,
    as JAX's lowered tensor-parallel step sums them (ROADMAP §3)."""
    case, ranks = tp_bf16
    got = [r["tp_bf16_steps"][fused] for r in ranks.results()]
    one = bf16_one_process(case["inputs"]["tp_bf16_steps"], fused)
    assert torch.equal(got[0]["picks"]["seed_inds"], one["picks"]["seed_inds"][[0, 2, 1, 3]])
    print("proposals picked as one process picks them:",
          (got[0]["picks"]["aggregated_vote_inds"] == one["picks"]["aggregated_vote_inds"][[0, 2, 1, 3]])
          .double().mean().item())
    assert got[0]["sharded"] == got[1]["sharded"] == PLANNED
    full = got[0]["state"][0]
    for step in range(2):
        for k, v in got[0]["state"][step].items():
            assert torch.equal(got[1]["state"][step][k], v), (step, k)
    for k in got[0]["own"]:
        name = k.split("/")[0]
        if name in PLANNED:
            assert got[0]["own"][k].shape[0] == full[name].shape[0] // 2, k
        else:
            assert torch.equal(got[1]["own"][k], got[0]["own"][k]), k
    other = bf16_one_process(case["inputs"]["tp_bf16_steps"], fused, order=[3, 1, 0, 2])
    hold_bf16_step(got[0], one, other, case["jax_bf16"][("single", fused)], case["jax_bf16"][("tp", fused)])


def test_tp_bf16_train_runner_matches_one_process(tp_bf16, tmp_path, monkeypatch):
    """The bf16 train runner at tp = 2 (batch 2 a rank, the group's 4; lr 0)
    against one process at batch 4, held as test_torch_ddp.py's
    ``test_ddp_bf16_train_runner_matches_one_process`` holds the data-parallel
    run: the ranks' gathered states and histories equal, parameters equal
    one process's, the vote loss, the val losses and the running statistics
    before FPS in JAX's sharded bf16 bands."""
    case, ranks = tp_bf16
    inputs = case["inputs"]["tp_bf16_train_run"]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(engine, "LogBoard", quiet_board)
    config = _train_config(str(tmp_path), batch=4)
    config["model"] = inputs["config"]["model"]
    cfg = CONFIG(config, mode="train")
    try:
        datasets = {k: SceneDataset(v, num_frames=SMALL["num_frames"], augment=False)
                    for k, v in inputs["scenes"].items()}
        model, history = train_runner.run(cfg, device="cpu", datasets=datasets)
    finally:
        cfg.close()
    got = [r["tp_bf16_train_run"] for r in ranks.results()]
    assert got[0]["history"] == got[1]["history"] and got[0]["sharded"] == PLANNED
    for k, v in got[0]["full_state"].items():
        assert torch.equal(got[1]["full_state"][k], v), k
    held = [("train", "vote_loss")] + [("val", k) for k in history[0]["val"] if k not in COUNT_LOSSES]
    for phase, k in held:
        v = history[0][phase][k]
        assert abs(got[0]["history"][0][phase][k] - v) <= 0.15 * max(abs(v), 1e-3), (phase, k)
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            if k.startswith(("backbone.", "centervoting.")):
                np.testing.assert_allclose(got[0]["full_state"][k].numpy(), v.numpy(), atol=5e-2, rtol=5e-2,
                                           err_msg=k)
        elif v.is_floating_point():
            assert torch.equal(got[0]["full_state"][k], v), k


def test_tp_multi_mode_and_mesh_ap_match_one_process(tp_bf16, tmp_path, monkeypatch):
    """Sharded sparse_eval test runs at tp = 2 (one scene a rank, the
    group's 2 a batch): two multi-mode runs with mesh AP in f32 and two in
    bf16, and a bf16 mesh-AP run without multi-mode; both ranks of the group
    draw the same noise, and one process at batch 2 fed it matches
    (test_torch_ddp.py's ``hold_sharded_test_runs``)."""
    case, ranks = tp_bf16
    inputs = case["inputs"]["tp_test_runs"]
    runs = [r["tp_test_runs"] for r in ranks.results()]
    for i, run in enumerate(runs[0]):
        for a, b in zip(run["noise"], runs[1][i]["noise"]):
            assert all(torch.equal(x, y) for k in a for x, y in zip(a[k], b[k])), i
    hold_sharded_test_runs(runs, inputs["configs"], tmp_path, inputs["scenes"], 2,
                           lambda i, it: runs[0][i]["noise"][it], monkeypatch)


def test_tp_bf16_dense_gradient_sums_in_f32(tp_bf16):
    """The bf16 input gradient of a column-parallel layer at tp 2 is the two
    ranks' f32 products summed in f32 and rounded to bf16 once, bit for bit
    on both ranks, as one process's product rounds once; rounding each
    rank's product first would move 0.37 of its entries.  JAX's bf16
    ``nn.Dense`` with its kernel on the model axis of a (1, 2) mesh sums
    them so too (its lowered HLO on the CPU: the f32 dot's all-reduce,
    promoted from bf16): its outputs and input gradient within one bf16 ulp
    (their f32 products may sum in another order first; ROADMAP §3)."""
    case, ranks = tp_bf16
    inputs = case["inputs"]["tp_dense_grad"]
    got = [r["tp_dense_grad"] for r in ranks.results()]
    want = (got[0]["own"] + got[1]["own"]).to(torch.bfloat16).float()
    rounded_first = (got[0]["own"].to(torch.bfloat16).float() + got[1]["own"].to(torch.bfloat16).float())
    for g in got:
        assert torch.equal(g["dx"], want) and torch.equal(g["y"], got[0]["y"])
    assert (rounded_first.to(torch.bfloat16).float() != want).float().mean() > 0.1

    mesh = make_mesh(jax.devices()[:2], model_parallel=2)
    layer = nn.Dense(256, dtype=jnp.bfloat16)
    params = shard_params({"params": {"kernel": inputs["w"].t().numpy(), "bias": inputs["b"].numpy()}}, mesh,
                          min_size=1)
    x = jnp.asarray(inputs["x"].numpy())

    @jax.jit
    def run(params, x):
        y, vjp = jax.vjp(lambda x: layer.apply(params, x), x)
        return y, vjp(jnp.asarray(inputs["dy"].numpy(), jnp.bfloat16))[0]

    for ours, ref in zip((got[0]["y"].float().numpy(), got[0]["dx"].numpy()),
                         (np.asarray(a, np.float32) for a in run(params, x))):
        assert np.all(np.abs(ours - ref) <= 2.0 ** -7 * np.maximum(np.abs(ref), np.abs(ours)))
