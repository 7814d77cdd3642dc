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
The same steps in bf16, the bf16 train runner, the sharded multi-mode and
mesh-AP test runs and a column-parallel bf16 layer are
tests/test_torch_tp_bf16.py's.  The train runs here write no TensorBoard
board (``torch_ddp_worker.quiet_board``): its import can load TensorFlow,
~17 s a process.  JAX's steps, its noise and the port's
float64 one process come from tests/torch_golden.py (computed once a run,
shared with tests/test_torch_ddp.py).
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax

from pose2room_tpu.parallel import make_mesh, shard_params
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
from pose2room_tpu_torch.train.step import batch_to_device, train_step
from torch_ddp_worker import RANK_THREADS, Ranks, quiet_board
from torch_golden import OPTIMIZER, goldens  # noqa: F401  (goldens is a fixture)
from torch_parallel_cases import PLANNED, make_scenes, metre_box_weights, rel, sparse_test_config, train_config
from torch_port_util import SMALL, scene_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_CLIP = os.path.join(REPO, "demo", "inputs", "input_joints_1.npy")

# ---------------------------------------------------------------------------
# the plan and the grid, in one process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flax_variables(goldens):
    """A flax init at the SMALL sizes (numpy leaves)."""
    return goldens.payload()


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
    config = sparse_test_config(root, weight)
    config["device"]["model_parallel"] = model_parallel
    demo_dir = os.path.join(root, "demo")
    os.makedirs(os.path.join(demo_dir, "inputs"), exist_ok=True)
    clip = np.load(DEMO_CLIP)
    np.save(os.path.join(demo_dir, "inputs", "clip_a.npy"), clip)
    np.save(os.path.join(demo_dir, "inputs", "clip_b.npy"), clip[::-1].copy())
    config.update(demo_path=demo_dir)
    return config


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory, goldens):
    """Starts two ranks at tp = 2 on every scenario, then fetches JAX's
    tensor-parallel and single-device steps while they run.  Yields (the
    case, the ranks)."""
    root = tmp_path_factory.mktemp("tp")
    weight_path = metre_box_weights(str(root / "weights.pth"))
    scenes = make_scenes(6, 12)
    resume_root = str(root / "resume")
    resume_checkpoint = _resume_checkpoint(resume_root, train_config(resume_root, batch=4, lr=OPTIMIZER["lr"]))

    def resume_config(batch, model_parallel):
        config = train_config(resume_root, batch=batch)  # lr 0: see test_torch_ddp.py
        config["train"]["epochs"] = 2
        config["device"]["model_parallel"] = model_parallel
        config.update(resume=True)
        return config

    test_config = sparse_test_config(str(root / "tp_test"), weight_path)
    test_config["device"]["model_parallel"] = 2
    inputs = {
        # test_torch_ddp.py's global batch, weights and noise
        "tp_steps": dict(goldens.step_inputs(), tp=2, paths=[True, False]),
        "tp_train_run": {"config": resume_config(2, 2), "num_frames": SMALL["num_frames"],
                         "scenes": {"train": scenes[:4], "val": scenes[4:8]}},
        "tp_test_run": {"config": test_config, "num_frames": SMALL["num_frames"], "scenes": scenes[8:12]},
        "demo_run": {"config": _demo_config(str(root / "tp_demo"), weight_path, model_parallel=2)},
    }
    ranks = Ranks(2, inputs, root / "ranks")
    try:
        yield {"inputs": inputs, "weight_path": weight_path, "resume_config": resume_config(4, 1),
               "resume_checkpoint": resume_checkpoint, "jax_step": goldens.jax_tp_step(),
               "jax_single": goldens.jax_step()}, ranks
    finally:
        ranks.close()


def test_tp_steps_match_one_process(tp_ranks, goldens):
    """Both train paths, float64: the two ranks' (gathered) state after two
    AdamW steps with weight decay and clipping, and their losses, against one
    process at batch 4, in test_torch_ddp.py's bands (1e-5 relative for the
    state, 1e-6 for the losses; the module path's conv biases get a gradient
    of rounding size, held to its size and the two steps of <= lr it takes)."""
    _, ranks = tp_ranks
    got = [r["tp_steps"] for r in ranks.results()]
    for fused in (True, False):
        losses, state = goldens.single_steps(fused)
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
            assert rel(res["state"][1][k], v) <= 1e-5, (fused, k, rel(res["state"][1][k], v))


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
        assert rel(g, single) <= 1e-3, (k, rel(g, single))
        assert rel(g, want) <= max(1e-3, 3 * rel(want, single)), (k, rel(g, want), rel(want, single))


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
            assert rel(v, want) <= 1e-5, k
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
            assert rel(got_inc, want_inc) <= 1e-2, (i, name, rel(got_inc, want_inc))
    assert ckpt["epoch"] == one_final["epoch"] == 2


def test_tp_test_runner_matches_one_process(tp_ranks, tmp_path):
    """The sparse_eval test runner under the model group of two (batch 1 a
    rank, 2 the group) against one process at batch 2: per-class AP,
    recall, mAP and AR within 1e-6, the mean losses within 1e-6 relative."""
    case, ranks = tp_ranks
    inputs = case["inputs"]["tp_test_run"]
    config = sparse_test_config(str(tmp_path), case["weight_path"])
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
