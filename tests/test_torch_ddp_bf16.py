"""bf16 under the port's data parallelism on the CPU: two spawned gloo ranks
(``tests/torch_ddp_worker.py``) with ``compute_dtype: bfloat16``, at the
global batch of tests/test_torch_ddp.py.

* two steps on both train paths, whose reduced sums (each fused block's
  BN1 column sums, kernel 3's summed parts, the BN2 backward's sums,
  kernel 4's summed parts, each BatchNorm's moments) equal those of one
  process fed the same terms within f32 rounding of each entry's sum of
  |terms|, and whose losses, gradients and running statistics are held
  against JAX's sharded bf16 step by the spread of JAX's own single-device
  and sharded steps and of the port's one process in two batch orders;
* the bf16 train runner against one process;
* sharded multi-mode and mesh-AP test runs (f32 and bf16) against one
  process fed each scene's noise as the rank drew it: mAP, mesh AP, the
  max-mAP inputs and the TMD.

The ranks start with the file's first test, beside whatever else runs;
JAX's bf16 steps and the port's bf16 one process come from
tests/torch_golden.py (shared with tests/test_torch_tp_bf16.py).
"""

import os

import numpy as np
import pytest
import torch

from pose2room_tpu_torch.config.loader import CONFIG
from pose2room_tpu_torch.data.dataset import SceneDataset
from pose2room_tpu_torch.runners import train as train_runner
from pose2room_tpu_torch.train import engine
from torch_ddp_worker import BF16_RANK_THREADS, Ranks, quiet_board
from torch_golden import bf16_one_process, goldens  # noqa: F401  (goldens is a fixture)
from torch_parallel_cases import (
    COUNT_LOSSES,
    forced_sequence,
    hold_bf16_step,
    hold_sharded_test_runs,
    make_scenes,
    mesh_test_config,
    metre_box_weights,
    reduced_sums_gaps,
    train_config,
)
from torch_port_util import SMALL


@pytest.fixture(scope="module")
def ddp_bf16(tmp_path_factory, goldens):
    """The bf16 scenarios on two ranks: the bf16 steps of
    tests/test_torch_ddp.py's batch, the bf16 train runner and the sharded
    test runs on its scenes and weights; JAX's sharded and single-device
    bf16 steps are fetched while they run.  Yields (the case, the ranks)."""
    root = tmp_path_factory.mktemp("ddp_bf16")
    weight_path = metre_box_weights(str(root / "weights.pth"))
    scenes = make_scenes(6, 16)
    bf16_run = train_config(str(root / "ddp_bf16_train"), batch=2)
    bf16_run["model"] = {**(bf16_run.get("model") or {}), "compute_dtype": "bfloat16"}
    test_runs = [mesh_test_config(str(root / f"ddp_test_{k}"), weight_path, dtype, multi_mode)
                 for k, (dtype, multi_mode) in enumerate([("float32", True)] * 2 + [("bfloat16", True)] * 2
                                                         + [("float32", False)])]
    inputs = {
        "bf16_steps": dict(goldens.step_inputs(), paths=[True, False]),
        "bf16_train_run": {"config": bf16_run, "num_frames": SMALL["num_frames"],
                           "scenes": {"train": scenes[:8], "val": scenes[8:12]}},
        "test_runs": {"configs": test_runs, "num_frames": SMALL["num_frames"], "scenes": scenes[12:16]},
    }
    ranks = Ranks(2, inputs, root / "bf16_ranks", threads=BF16_RANK_THREADS)
    try:
        jax_bf16 = {(kind, fused): goldens.jax_bf16(kind, fused)
                    for kind in ("sharded", "single") for fused in (True, False)}
        yield {"inputs": inputs, "jax_bf16": jax_bf16}, ranks
    finally:
        ranks.close()


@pytest.mark.parametrize("fused", [True, False], ids=["fused_chain", "module_path"])
def test_ddp_bf16_reduced_sums_match_one_process(ddp_bf16, fused):
    """Two ranks' bf16 step 1 (2 + 2 of the global 4): every sum reduced
    across the ranks (each fused block's BN1 column sums, kernel 3's
    summed parts, the BN2 backward's channel sums and kernel 4's summed
    parts, four a block; each module-path BatchNorm's moments) is the f32
    sum of the ranks' own, bit-equal on both, and within f32 rounding of
    each entry's sum of |terms| of one process's sums over the same terms:
    the one process is fed the ranks' reduced sums and the gradients
    reaching each fused block, so that past the first statistics it rounds
    its bf16 activations as the ranks do (otherwise a last-bit difference
    in a statistic flips bf16 roundings and the terms part)."""
    case, ranks = ddp_bf16
    logs = [r["bf16_steps"][fused]["sums"] for r in ranks.results()]
    one = bf16_one_process(case["inputs"]["bf16_steps"], fused, forced_sequence(logs, [[0, 2], [1, 3]], 2))
    worst = reduced_sums_gaps(logs, one["sums"], group=[0, 1], data_count=2)
    assert set(worst) == ({"bn", "BN1", "kernel 3", "BN2 backward", "kernel 4"} if fused else {"bn"})
    assert max(worst.values()) <= 1, worst


@pytest.mark.parametrize("fused", [True, False], ids=["fused_chain", "module_path"])
def test_ddp_bf16_step_matches_jax_sharded(ddp_bf16, goldens, fused):
    """Two ranks' bf16 step against JAX's bf16 step with the state
    replicated and the batch on a 2-device data axis (tests/test_parallel.py's
    sharded step) and against the port's one process, by
    ``hold_bf16_step``'s spread rule (the port's one process in another
    batch order its second spread); the seeds equal one process's (FPS's
    proposals may not: a bf16 rounding that moves a vote can move a pick,
    ROADMAP §3), both ranks' states bit-equal after two steps (the fused
    chain's conv-bias gradient the analytic 0, every gradient f32)."""
    case, ranks = ddp_bf16
    got = [r["bf16_steps"][fused] for r in ranks.results()]
    one = goldens.bf16_one_process(fused)
    picks = {k: torch.stack([got[0]["picks"][k], got[1]["picks"][k]], 1).flatten(0, 1) for k in one["picks"]}
    assert torch.equal(picks["seed_inds"], one["picks"]["seed_inds"])
    print("proposals picked as one process picks them:",
          (picks["aggregated_vote_inds"] == one["picks"]["aggregated_vote_inds"]).double().mean().item())
    for step in range(2):
        for k, v in got[0]["state"][step].items():
            assert torch.equal(got[1]["state"][step][k], v), (step, k)
    assert got[0]["losses"][0]["pos_ratio"] > 0
    for k, g in got[0]["grads"].items():
        assert g.dtype == torch.float32 and (not (fused and k.endswith("tcn.2.bias")) or not g.any()), k
    other = goldens.bf16_one_process(fused, order=[3, 1, 0, 2])
    hold_bf16_step(got[0], one, other, case["jax_bf16"][("single", fused)], case["jax_bf16"][("sharded", fused)])


def test_ddp_bf16_train_runner_matches_one_process(ddp_bf16, tmp_path, monkeypatch):
    """The bf16 train runner under two ranks at batch 2 (lr 0, as
    test_ddp_train_runner_matches_one_process) against one process at batch
    4: the ranks' histories and states equal bit for bit, parameters equal
    one process's (f32, as model_final.pth holds them).  What FPS's picks do
    not feed is held in JAX's bands for a sharded bf16 step against one
    device (tests/test_parallel.py): the mean vote loss of the train steps
    and every val loss (one step, on running statistics) within 0.15
    relative, the running statistics of the backbone and the vote head
    within 5e-2.  The train steps' box terms are not held: at random init
    a batch holds one positive proposal or none, and a bf16 rounding that
    moves one FPS pick (ROADMAP §3) moves them by half (here the ranks' mean
    train total is 53.4, one process's 94.8)."""
    case, ranks = ddp_bf16
    inputs = case["inputs"]["bf16_train_run"]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(engine, "LogBoard", quiet_board)
    config = train_config(str(tmp_path), batch=4)
    config["model"] = inputs["config"]["model"]
    cfg = CONFIG(config, mode="train")
    try:
        datasets = {k: SceneDataset(v, num_frames=SMALL["num_frames"], augment=False)
                    for k, v in inputs["scenes"].items()}
        model, history = train_runner.run(cfg, device="cpu", datasets=datasets)
    finally:
        cfg.close()
    got = [r["bf16_train_run"] for r in ranks.results()]
    assert got[0]["history"] == got[1]["history"] and len(history) == len(got[0]["history"]) == 1
    for k, v in got[0]["state"].items():
        assert torch.equal(got[1]["state"][k], v), k
    held = [("train", "vote_loss")] + [("val", k) for k in history[0]["val"] if k not in COUNT_LOSSES]
    for phase, k in held:
        v = history[0][phase][k]
        assert abs(got[0]["history"][0][phase][k] - v) <= 0.15 * max(abs(v), 1e-3), (phase, k)
    ckpt = torch.load(os.path.join(got[0]["save_path"], "model_final.pth"), weights_only=True)["net"]
    for k, v in model.state_dict().items():
        assert torch.equal(ckpt[k], got[0]["state"][k]), k
        if k.endswith(("running_mean", "running_var")):
            if k.startswith(("backbone.", "centervoting.")):
                np.testing.assert_allclose(got[0]["state"][k].numpy(), v.numpy(), atol=5e-2, rtol=5e-2, err_msg=k)
        elif v.is_floating_point():
            assert v.dtype == torch.float32 and torch.equal(got[0]["state"][k], v), k


def test_ddp_multi_mode_and_mesh_ap_match_one_process(ddp_bf16, tmp_path, monkeypatch):
    """Sharded sparse_eval test runs under two ranks (one scene a rank a
    batch): two multi-mode runs with mesh AP in f32 and two in bf16, and a
    mesh-AP run without multi-mode, against one process at batch 1 fed each
    scene's noise as its rank drew it (``hold_sharded_test_runs``), in the
    order the merge lays the scans out."""
    case, ranks = ddp_bf16
    inputs = case["inputs"]["test_runs"]
    runs = [r["test_runs"] for r in ranks.results()]
    # the merge lays the scans out rank by rank (JAX's order): rank 0's
    # scenes 0 and 2, then rank 1's 1 and 3.  The one process steps them in
    # that order, since AP breaks ties of confidence by it (ROADMAP §3)
    scenes = [inputs["scenes"][i] for i in (0, 2, 1, 3)]

    def noise_of(i, it):  # the one process's batch it is rank it // 2's batch it % 2
        return runs[it // 2][i]["noise"][it % 2]

    hold_sharded_test_runs(runs, inputs["configs"], tmp_path, scenes, 1, noise_of, monkeypatch)
