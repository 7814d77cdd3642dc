"""The port's data parallelism on the CPU: one process a rank, gloo.

* ``DataLoader(process_index, process_count)``: each rank's batches equal
  the JAX loader's, bit for bit (wrap-padding, strided shards, the
  augmentation seed of a padded duplicate);
* ``LossRecorder`` and ``APCalculator`` merges against the JAX package's on
  the same injected allgather (voxel payloads included), and the
  collectives' one-process identities;
* two ranks (``tests/torch_ddp_worker.py``, spawned, joined through the
  torchrun environment) at a global batch of 4: two AdamW steps with
  clipping through DDP, on the fused train chain and the module path, held
  against the port's single process at batch 4 and against JAX's step on
  the same global batch (test_torch_train_step.py's bands), in float64, so
  that the test sees the math and not the f32 conditioning; the train
  runner (one epoch, augmentation off) against one process at twice the
  batch, with one run dir and rank 0's files only; the test runner's merged
  AP and losses against one process;
* ``Ranks``' error past its guard names each rank's scenario and state.

The same steps in bf16, the bf16 train runner and the sharded multi-mode
and mesh-AP test runs are tests/test_torch_ddp_bf16.py's.  JAX's step, its
noise and the port's float64 one process come from tests/torch_golden.py
(computed once a run, shared with tests/test_torch_tp.py).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from pose2room_tpu.data.loader import DataLoader as JaxDataLoader
from pose2room_tpu.eval import ap as jax_ap
from pose2room_tpu.eval.voxels import voxelize_box as jax_voxelize_box
from pose2room_tpu.utils.logger import LossRecorder as JaxLossRecorder
from pose2room_tpu_torch import parallel
from pose2room_tpu_torch.config.dataset_config import DatasetConfig
from pose2room_tpu_torch.config.loader import CONFIG
from pose2room_tpu_torch.data import synth
from pose2room_tpu_torch.data.dataset import SceneDataset
from pose2room_tpu_torch.data.loader import DataLoader
from pose2room_tpu_torch.eval.ap import APCalculator
from pose2room_tpu_torch.eval.voxels import voxelize_box
from pose2room_tpu_torch.ops.boxes import get_3d_box
from pose2room_tpu_torch.runners import test as test_runner
from pose2room_tpu_torch.runners import train as train_runner
from pose2room_tpu_torch.utils.logger import LossRecorder
from torch_ddp_worker import Ranks, free_port
from torch_golden import OPTIMIZER, goldens  # noqa: F401  (goldens is a fixture)
from torch_parallel_cases import make_scenes, metre_box_weights, rel, sparse_test_config, train_config
from torch_port_util import SMALL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# loader shards, merges, collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, count, batch", [
    (10, 2, 4),  # padded to 16: shard 0 holds one sample twice
    (16, 2, 4),
])
def test_loader_shards_match_jax(n, count, batch):
    """Thread workers, shuffled and augmented, epochs 0 and 1."""
    dataset = SceneDataset(make_scenes(2, n, n_frames=80), num_frames=48, augment=True)
    for rank in range(count):
        kw = dict(batch_size=batch, shuffle=True, seed=3, num_workers=2, process_index=rank,
                  process_count=count)
        ours, ref = DataLoader(dataset, **kw), JaxDataLoader(dataset, **kw)
        try:
            for epoch in (0, 1):
                ours.set_epoch(epoch)
                ref.set_epoch(epoch)
                batches = list(zip(ours, ref))
                assert len(batches) == len(ours) == len(ref) == -(-n // (count * batch))
                seen = []
                for a, b in batches:
                    assert a["sample_idx"] == b["sample_idx"] and len(a["sample_idx"]) == batch
                    seen += a["sample_idx"]
                    for k in a:
                        if k != "sample_idx":
                            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                if n % (count * batch):
                    assert len(set(seen)) < len(seen) or rank == count - 1
        finally:
            ours.close()
            ref._pool.shutdown()
            ref._prefetcher.shutdown()


def test_loader_shards_cover_the_epoch():
    """The shards of one epoch: disjoint up to the wrap-padding, together
    every sample, and rank i's rows of global batch k are rows i::N of one
    process's batch k at N times the batch size."""
    dataset = SceneDataset(make_scenes(4, 8, n_frames=80), num_frames=48, augment=False)
    one = list(DataLoader(dataset, 4, shuffle=True, seed=5, num_workers=0))
    shards = [list(DataLoader(dataset, 2, shuffle=True, seed=5, num_workers=0, process_index=r,
                              process_count=2)) for r in range(2)]
    for k, whole in enumerate(one):
        for r in range(2):
            assert shards[r][k]["sample_idx"] == whole["sample_idx"][r::2]
            np.testing.assert_array_equal(shards[r][k]["input_joints"], whole["input_joints"][r::2])
    with pytest.raises(ValueError, match="process_index"):
        DataLoader(dataset, 2, process_index=2, process_count=2)


def test_loss_recorder_merge_matches_jax():
    shards = [[{"total": 1.0, "center": 0.5}, {"total": 3.0, "center": 0.1}], [{"total": 2.0, "center": 0.2}]]
    ours = [LossRecorder(2) for _ in shards]
    refs = [JaxLossRecorder(2) for _ in shards]
    for recs in (ours, refs):
        for rec, shard in zip(recs, shards):
            for losses in shard:
                rec.update_loss(losses)
    states = [{k: (m.sum, m.count) for k, m in r.loss_recorder.items()} for r in ours]
    ours[0].synchronize_between_processes(allgather=lambda obj: states)
    refs[0].synchronize_between_processes(allgather=lambda obj: states)
    assert ours[0].means().keys() == refs[0].means().keys()
    for k, v in refs[0].means().items():
        assert abs(ours[0].means()[k] - v) <= 1e-12, k
    assert ours[0].loss_recorder["total"].count == 6
    before = ours[1].means()
    ours[1].synchronize_between_processes()  # one process: a no-op
    assert ours[1].means() == before


def _shard_scans(rng, n_scans, voxel):
    scans = []
    for _ in range(n_scans):
        preds, gts = [], []
        for _ in range(rng.randint(1, 4)):
            cls = int(rng.randint(0, 3))
            center, size = rng.randn(3) * 2, 0.5 + rng.rand(3)
            gt = get_3d_box(size, float(rng.rand() * np.pi), center)
            gts.append((cls, gt))
            preds.append((cls, get_3d_box(size, 0.0, center + 0.05), float(rng.rand())))
            preds.append((cls, get_3d_box(size, 0.0, center + 5.0), float(rng.rand())))
        if voxel is not None:
            preds = [(c, b, s, voxel(b, 0.25)) for c, b, s in preds]
            gts = [(c, b, voxel(b, 0.25)) for c, b in gts]
        scans.append((preds, gts))
    return scans


@pytest.mark.parametrize("mesh", [False, True])
def test_ap_merge_matches_jax(mesh):
    """Two fake shards of scans (with each package's voxel payloads on the
    mesh path): the merged metrics equal JAX's merge and one calculator over
    every scan, at 1e-12."""
    names = DatasetConfig().class2type
    out = {}
    for pkg, calc_cls, vox in (("ours", APCalculator, voxelize_box), ("jax", jax_ap.APCalculator, jax_voxelize_box)):
        scans = _shard_scans(np.random.RandomState(7), 6, vox if mesh else None)
        calcs = [calc_cls(0.25, names) for _ in range(2)]
        whole = calc_cls(0.25, names)
        for i, (preds, gts) in enumerate(scans):
            calcs[i % 2].step([preds], [gts])
            whole.step([preds], [gts])
        states = [(c.pred_map_cls, c.gt_map_cls) for c in calcs]
        calcs[0].synchronize_between_processes(allgather=lambda obj: states)
        assert calcs[0].scan_cnt == 6
        compute = "compute_metrics_w_mesh" if mesh else "compute_metrics"
        out[pkg] = getattr(calcs[0], compute)(), getattr(whole, compute)()
    (ours, ours_whole), (ref, _) = out["ours"], out["jax"]
    assert list(ours) == list(ref) and ref["mAP"] > 0 and (not mesh or ref["mAP_mesh"] > 0)
    for k, v in ref.items():
        assert abs(ours[k] - v) <= 1e-12 and abs(ours_whole[k] - v) <= 1e-12, k


def test_collectives_outside_a_group(monkeypatch):
    """One process: the identities, and no group without torchrun's
    environment; the backend choice."""
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert parallel.init_distributed("cpu") is None and not parallel.in_group()
    obj = {"a": np.arange(3)}
    assert parallel.allgather_object(obj)[0] is obj and parallel.broadcast_object(obj) is obj
    assert (parallel.process_index(), parallel.process_count()) == (0, 1)
    t = torch.arange(4.0, requires_grad=True)
    assert parallel.all_reduce_sum(t) is t and parallel.all_reduce_sum_(t) is t
    assert parallel.fold_rank(42) == 42
    model = torch.nn.Linear(2, 2)
    assert parallel.wrap_model(model) is model and parallel.unwrap(model) is model
    assert parallel.pick_backend(True, 0, 2) == "gloo"
    assert parallel.pick_backend(False, 4, 4) == "nccl"
    assert parallel.pick_backend(False, 1, 2) == "gloo"  # two ranks share one card
    parallel.shutdown()


def test_config_raises_under_torchrun_without_a_group(monkeypatch, tmp_path):
    """Under torchrun's environment a CONFIG built before the process joins
    the group raises (each rank would take itself for rank 0 and write its
    own run dir), and makes no directory."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="init_distributed"):
        CONFIG({"log": {"path": str(tmp_path / "out")}}, mode="train")
    assert not (tmp_path / "out").exists()


def test_ranks_name_the_state_of_each_rank(tmp_path):
    """Ranks past their guard, one that exited without its results and one
    still in its scenario: ``results()`` says so of each (not only that
    time ran out), and a later call raises the same error."""
    ranks = Ranks(2, {"stall": {"exit": [0], "seconds": 300}}, tmp_path, timeout=20)
    try:
        deadline = time.monotonic() + 240  # spawned ranks take a while to start on a loaded host
        while not all((tmp_path / f"rank{r}.at").exists() for r in range(2)) and time.monotonic() < deadline:
            time.sleep(0.5)
        with pytest.raises(TimeoutError) as first:
            ranks.results()
        message = str(first.value)
        assert "did not finish in 20 s" in message, message
        assert "rank 0: exit code 0, in scenario 'stall'" in message, message
        assert "rank 1: alive, in scenario 'stall'" in message, message
        with pytest.raises(TimeoutError) as again:
            ranks.results()
        assert again.value is first.value
    finally:
        ranks.close()


# ---------------------------------------------------------------------------
# two ranks against one process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ddp(tmp_path_factory, goldens):
    """Starts two ranks on every scenario, then fetches JAX's step while
    they run (and the tests their one-process references).  Yields (the
    case: its inputs and JAX's losses and gradients, the ranks' handle)."""
    root = tmp_path_factory.mktemp("ddp")
    weight_path = metre_box_weights(str(root / "weights.pth"))
    scenes = make_scenes(6, 16)
    inputs = {
        "train_steps": goldens.step_inputs(),
        "train_run": {"config": train_config(str(root / "ddp_train"), batch=2), "num_frames": SMALL["num_frames"],
                      "scenes": {"train": scenes[:8], "val": scenes[8:12]}},
        "train_run_lr": {"config": train_config(str(root / "ddp_train_lr"), batch=2, lr=OPTIMIZER["lr"]),
                         "num_frames": SMALL["num_frames"], "scenes": {"train": scenes[:8], "val": scenes[8:12]}},
        "test_run": {"config": sparse_test_config(str(root / "ddp_test"), weight_path),
                     "num_frames": SMALL["num_frames"], "scenes": scenes[12:16]},
    }
    ranks = Ranks(2, inputs, root / "ranks")
    try:
        yield {"inputs": inputs, "jax_step": goldens.jax_step()}, ranks
    finally:
        ranks.close()


def test_ddp_train_runner_matches_one_process(ddp, tmp_path, monkeypatch):
    """The train runner under two ranks at batch 2 (augmentation off), one
    epoch of 2 train steps and a val step: its per-epoch history equals one
    process's at batch 4 within 1e-5 relative, and so do the BatchNorm
    running statistics; every rank used rank 0's run dir, which holds rank
    0's files only, and only rank 0's working directory has the board.

    At lr 0: at random init an f32 AdamW step amplifies rounding (a 1e-7
    relative change of the initial weights moves the next step's loss by
    ~30% in one process, ROADMAP §3), so after a real update two runs that
    round differently cannot agree; the update through DDP is held in
    float64 by test_ddp_train_steps_match_one_process."""
    case, ranks = ddp
    inputs = case["inputs"]["train_run"]
    monkeypatch.chdir(tmp_path)
    cfg = CONFIG(train_config(str(tmp_path), batch=4), mode="train")
    try:
        datasets = {k: SceneDataset(v, num_frames=SMALL["num_frames"], augment=False)
                    for k, v in inputs["scenes"].items()}
        model, history = train_runner.run(cfg, device="cpu", datasets=datasets)
    finally:
        cfg.close()
    got = [r["train_run"] for r in ranks.results()]
    assert got[0]["save_path"] == got[1]["save_path"]
    run_root = os.path.dirname(got[0]["save_path"])
    assert os.listdir(run_root) == [os.path.basename(got[0]["save_path"])]
    assert sorted(os.listdir(got[0]["save_path"])) == ["log.txt", "model_best.pth", "model_final.pth",
                                                        "visualization"]
    assert "runs" in got[0]["cwd"] and got[1]["cwd"] == []
    assert len(got[0]["history"]) == len(history) == 1
    for phase in ("train", "val"):
        for k, v in history[0][phase].items():
            for r in got:
                assert abs(r["history"][0][phase][k] - v) <= 1e-5 * max(abs(v), 1e-3), (phase, k, r["history"][0][phase], history[0][phase])
    final = model.state_dict()
    for k, v in final.items():
        assert torch.equal(got[0]["state"][k], got[1]["state"][k]), k
        if v.is_floating_point():
            assert rel(got[0]["state"][k], v) <= 1e-5, k


def test_ddp_train_runner_ranks_agree_at_real_lr(ddp):
    """The train runner under two ranks at lr 1e-3: after the epoch both
    ranks hold the same state bit for bit, and it moved from the lr-0 run's
    (the start).  Without the reduction of the gradients across the ranks
    each would step on its own half of the batch and the two would part."""
    _, ranks = ddp
    got = [r["train_run_lr"]["state"] for r in ranks.results()]
    start = ranks.results()[0]["train_run"]["state"]
    params = [k for k in got[0] if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    for k, v in got[0].items():
        assert torch.equal(v, got[1][k]), k
    moved = [k for k in params if not torch.equal(got[0][k], start[k])]
    assert len(moved) > len(params) // 2, (len(moved), len(params))


def test_ddp_test_runner_matches_one_process(ddp, tmp_path):
    """The test runner under two ranks (2 of the 4 scenes each): AP, recall,
    mAP and AR of the merged scans within 1e-6 of one process's, the merged
    mean losses within 1e-6 relative, one run dir for both."""
    case, ranks = ddp
    inputs = case["inputs"]["test_run"]
    cfg = CONFIG(sparse_test_config(str(tmp_path), inputs["config"]["weight"][0]), mode="test")
    try:
        want = test_runner.run(cfg, device="cpu",
                               dataset=SceneDataset(inputs["scenes"], num_frames=SMALL["num_frames"]))
        want_losses = cfg.test_summary["mean_losses"]
    finally:
        cfg.close()
    got = [r["test_run"] for r in ranks.results()]
    assert got[0]["save_path"] == got[1]["save_path"]
    assert want[0.05]["mAP"] > 0
    for r in got:
        for t, metrics in want.items():
            assert list(r["metrics"][t]) == list(metrics)
            for k, v in metrics.items():
                assert abs(r["metrics"][t][k] - v) <= 1e-6, (t, k)
        for k, v in want_losses.items():
            assert abs(r["mean_losses"][k] - v) <= 1e-6 * max(abs(v), 1.0), k


@pytest.mark.parametrize("fused", [True, False], ids=["fused_chain", "module_path"])
def test_ddp_train_step_matches_jax(ddp, fused):
    """The two ranks' first step (float64) against JAX's single-process
    float32 step on the same global batch and noise, in
    test_torch_train_step.py's bands: losses within 1e-4 relative, every
    gradient (summed over the ranks by DDP) within 1e-3 of its max.  On this
    batch JAX's f32 gradient is within 1.6e-5 of max|g| of the port's float64
    one, so the bands see the math (f32 train gradients are ill-conditioned
    on most batches, ROADMAP §3)."""
    case, ranks = ddp
    want_losses, want_grads = case["jax_step"]
    got = ranks.results()[0]["train_steps"][fused]
    assert got["losses"][0]["pos_ratio"] > 0  # the box terms see positive proposals
    for k, v in want_losses.items():
        assert abs(got["losses"][0][k] - v) <= 1e-4 * max(abs(v), 1e-3), (k, got["losses"][0][k], v)
    for k, g in got["grads"].items():
        if k.endswith("tcn.2.bias"):
            continue  # analytically zero (BN2 absorbs it): rounding noise on both sides
        want = want_grads[k].double()
        assert rel(g, want) <= 1e-3, (k, rel(g, want))


@pytest.mark.parametrize("fused", [True, False], ids=["fused_chain", "module_path"])
def test_ddp_train_steps_match_one_process(ddp, goldens, fused):
    """Two ranks of 2 against one process of 4, in float64: parameters and
    running statistics after two AdamW steps (weight decay, clipping)
    within 1e-5 relative, the losses too; both ranks' states
    bit-equal (the objectness statistics are float32 in every run: within
    1e-6).  The module path's conv biases have an analytically zero
    gradient (BN2 absorbs them) of rounding size, whose AdamW step is the
    sign of that noise: they are held to that (the fused chain's is exactly
    0)."""
    case, ranks = ddp
    losses, state = goldens.single_steps(fused)
    got = [r["train_steps"][fused] for r in ranks.results()]
    for k, v in state.items():
        assert torch.equal(got[0]["state"][k], got[1]["state"][k]), k
    for step in range(2):
        for k, v in losses[step].items():
            assert abs(got[0]["losses"][step][k] - v) <= 1e-6 * max(abs(v), 1.0), (step, k, got[0]["losses"][step][k], v)
    for k, v in state.items():
        if not v.is_floating_point():
            continue
        if k.endswith("tcn.2.bias") and not fused:
            scale = got[0]["grads"][k[:-6] + "3.bias"].abs().max()
            assert got[0]["grads"][k].abs().max() <= 1e-9 * scale, k
            assert (got[0]["state"][k] - v).abs().max() <= 4 * OPTIMIZER["lr"], k  # two steps of <= lr each
            continue
        assert rel(got[0]["state"][k], v) <= 1e-5, (k, rel(got[0]["state"][k], v))


def test_cli_under_torchrun_on_cpu(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    pose2room_tpu_torch --mode test --device cpu`` on a synthetic split:
    both ranks join a gloo group, one run dir with one out_config.yaml."""
    synth.write_synthetic_dataset(str(tmp_path / "ds"), n_train=1, n_test=4, seed=3, n_frames=120)
    config = sparse_test_config(str(tmp_path), None)
    config.update(finetune=False, weight=[])
    config["data"]["split"] = str(tmp_path / "ds" / "splits" / "script_level")
    yaml_path = tmp_path / "test.yaml"
    yaml_path.write_text(yaml.safe_dump(config))
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                          "--master_port", str(free_port()), "-m", "pose2room_tpu_torch",
                          "--config", str(yaml_path), "--mode", "test", "--device", "cpu"],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "backend gloo" in out.stdout + out.stderr
    runs = os.listdir(tmp_path / "out" / "test")
    assert len(runs) == 1
    assert os.path.isfile(tmp_path / "out" / "test" / runs[0] / "out_config.yaml")
    assert "eval mAP" in open(tmp_path / "out" / "test" / runs[0] / "log.txt").read()

