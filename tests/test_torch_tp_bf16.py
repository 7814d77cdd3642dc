"""bf16 under the port's tensor-parallel mode on the CPU: two spawned gloo
ranks (``tests/torch_ddp_worker.py``) at tp = 2 with ``compute_dtype:
bfloat16``, one model group of two, at the global batch of
tests/test_torch_ddp.py.

* two steps on both train paths, whose reduced sums equal one process's
  sums of the same terms within f32 rounding and whose losses, gradients
  and running statistics are held against JAX's tensor-parallel bf16 step
  by the spread of JAX's own single-device and tensor-parallel steps
  (``torch_parallel_cases.reduced_sums_gaps`` and ``hold_bf16_step``), the
  replicated tensors bit-equal on both ranks;
* the bf16 train runner against one process;
* sharded multi-mode and mesh-AP test runs (f32 and bf16) against one
  process fed the group's draws;
* a column-parallel bf16 layer's input gradient, summed in f32 as JAX's
  lowered step sums it.

The ranks start with the file's first test, beside whatever else runs, and
write no TensorBoard board (``torch_ddp_worker.quiet_board``).  JAX's bf16
steps and the port's bf16 one process come from tests/torch_golden.py
(shared with tests/test_torch_ddp_bf16.py).
"""

import flax.linen as nn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose2room_tpu.parallel import make_mesh, shard_params
from pose2room_tpu_torch.config.loader import CONFIG
from pose2room_tpu_torch.data.dataset import SceneDataset
from pose2room_tpu_torch.runners import train as train_runner
from pose2room_tpu_torch.train import engine
from torch_ddp_worker import BF16_RANK_THREADS, Ranks, quiet_board
from torch_golden import bf16_one_process, goldens  # noqa: F401  (goldens is a fixture)
from torch_parallel_cases import (
    COUNT_LOSSES,
    PLANNED,
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


def _dense_case():
    """A bf16 column-parallel layer's operands at tp 2: x (64, 512) f32, w
    (256, 512), bias and the output gradient, from a seed."""
    rng = np.random.RandomState(9)
    return {"tp": 2, "x": torch.from_numpy(rng.randn(64, 512).astype(np.float32)),
            "w": torch.from_numpy((rng.randn(256, 512) / 16).astype(np.float32)),
            "b": torch.from_numpy((rng.randn(256) * 0.1).astype(np.float32)),
            "dy": torch.from_numpy(rng.randn(64, 256).astype(np.float32))}


@pytest.fixture(scope="module")
def tp_bf16(tmp_path_factory, goldens):
    """The bf16 scenarios at tp = 2 on two ranks: the bf16 steps of
    tests/test_torch_tp.py's batch, the bf16 train runner and the sharded
    test runs on its scenes and weights, and a column-parallel bf16 layer;
    JAX's tensor-parallel and single-device bf16 steps are fetched while
    they run.  Yields (the case, the ranks)."""
    root = tmp_path_factory.mktemp("tp_bf16")
    weight_path = metre_box_weights(str(root / "weights.pth"))
    scenes = make_scenes(6, 12)
    bf16_run = train_config(str(root / "tp_bf16_train"), batch=2)
    bf16_run["model"] = {**(bf16_run.get("model") or {}), "compute_dtype": "bfloat16"}
    bf16_run["device"]["model_parallel"] = 2
    test_runs = [mesh_test_config(str(root / f"tp_test_{k}"), weight_path, dtype, multi_mode, model_parallel=2)
                 for k, (dtype, multi_mode) in enumerate([("float32", True)] * 2 + [("bfloat16", True)] * 2
                                                         + [("bfloat16", False)])]
    inputs = {
        "tp_bf16_steps": dict(goldens.step_inputs(), tp=2, paths=[True, False]),
        "tp_bf16_train_run": {"config": bf16_run, "num_frames": SMALL["num_frames"],
                              "scenes": {"train": scenes[:4], "val": scenes[4:8]}},
        "tp_test_runs": {"configs": test_runs, "num_frames": SMALL["num_frames"], "scenes": scenes[8:12]},
        "tp_dense_grad": _dense_case(),
    }
    ranks = Ranks(2, inputs, root / "bf16_ranks", threads=BF16_RANK_THREADS)
    try:
        jax_bf16 = {(kind, fused): goldens.jax_bf16(kind, fused)
                    for kind in ("tp", "single") for fused in (True, False)}
        yield {"inputs": inputs, "jax_bf16": jax_bf16}, ranks
    finally:
        ranks.close()


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
def test_tp_bf16_step_matches_jax_tensor_parallel(tp_bf16, goldens, fused):
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
    one = goldens.bf16_one_process(fused)
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
    other = goldens.bf16_one_process(fused, order=[3, 1, 0, 2])
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
    config = train_config(str(tmp_path), batch=4)
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
