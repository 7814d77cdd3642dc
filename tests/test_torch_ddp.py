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
* two more ranks in bf16 (``compute_dtype: bfloat16``), started once the
  first two have finished: two steps on both train paths, whose reduced
  sums (each fused block's BN1 column sums, kernel 3's summed parts, the
  BN2 backward's sums, kernel 4's summed parts, each BatchNorm's moments)
  equal those of one process fed the same terms within f32 rounding of
  each entry's sum of |terms|, and whose losses, gradients and running
  statistics are held against JAX's sharded bf16 step by the spread of
  JAX's own single-device and sharded steps and of the port's one process
  in two batch orders; the
  bf16 train runner against one process; sharded multi-mode and mesh-AP
  test runs (f32 and bf16) against one process fed each scene's noise as
  the rank drew it: mAP, mesh AP, the max-mAP inputs and the TMD.
"""

import os
import subprocess
import sys

import flax.linen as nn
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from pose2room_tpu.data.loader import DataLoader as JaxDataLoader
from pose2room_tpu.eval import ap as jax_ap
from pose2room_tpu.eval.voxels import voxelize_box as jax_voxelize_box
from pose2room_tpu.models.loss import detection_loss as jax_detection_loss
from pose2room_tpu.models.mdn import MDNHead as JaxMDNHead
from pose2room_tpu.parallel import make_mesh, replicate, shard_batch, shard_params
from pose2room_tpu.utils.logger import LossRecorder as JaxLossRecorder
from pose2room_tpu_torch import parallel
from pose2room_tpu_torch.config.dataset_config import DatasetConfig
from pose2room_tpu_torch.config.loader import CONFIG
from pose2room_tpu_torch.convert import state_dict_from_flax
from pose2room_tpu_torch.data import synth
from pose2room_tpu_torch.data.dataset import SceneDataset
from pose2room_tpu_torch.data.loader import DataLoader
from pose2room_tpu_torch.eval import multi_modal
from pose2room_tpu_torch.eval.ap import APCalculator
from pose2room_tpu_torch.eval.voxels import voxelize_box
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
from pose2room_tpu_torch.ops.boxes import get_3d_box
from pose2room_tpu_torch.runners import test as test_runner
from pose2room_tpu_torch.runners import train as train_runner
from pose2room_tpu_torch.train import engine
from pose2room_tpu_torch.train.state import make_optimizer
from pose2room_tpu_torch.train.step import GT_KEYS, batch_to_device, train_step
from pose2room_tpu_torch.utils.logger import LossRecorder
from torch_ddp_worker import BF16_RANK_THREADS, Ranks, bf16_steps, free_port, quiet_board
from torch_port_util import SMALL, _perturb, jax_model, scene_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_YAML = os.path.join(REPO, "configs", "config_files", "p2rnet_train.yaml")
TEST_YAML = os.path.join(REPO, "configs", "config_files", "p2rnet_test.yaml")
OPTIMIZER = {"lr": 1e-3, "weight_decay": 0.01, "clip_norm": 0.5}


def _scenes(seed, n, n_frames=120):
    rng = np.random.RandomState(seed)
    return [synth.as_stored(*synth.make_scene(rng, n_objects=int(rng.randint(2, 6)), n_frames=n_frames))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# loader shards, merges, collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, count, batch", [
    (10, 2, 4),  # padded to 16: shard 0 holds one sample twice
    (16, 2, 4),
])
def test_loader_shards_match_jax(n, count, batch):
    """Thread workers, shuffled and augmented, epochs 0 and 1."""
    dataset = SceneDataset(_scenes(2, n, n_frames=80), num_frames=48, augment=True)
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
    dataset = SceneDataset(_scenes(4, 8, n_frames=80), num_frames=48, augment=False)
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


# ---------------------------------------------------------------------------
# two ranks against one process
# ---------------------------------------------------------------------------

def _train_config(root, batch, lr=0.0):
    config = yaml.safe_load(open(TRAIN_YAML))
    config["data"].update(num_frames=SMALL["num_frames"], num_seeds=SMALL["num_seeds"],
                          num_target=SMALL["num_proposals"], num_gaussian=SMALL["num_gaussian"])
    config["train"].update(epochs=1, batch_size=batch)
    config["val"]["batch_size"] = batch
    config["device"].update(num_workers=2)
    config["optimizer"].update(OPTIMIZER, lr=lr)  # lr 0: see test_ddp_train_runner_matches_one_process
    config["log"].update(path=os.path.join(root, "out"), print_step=1)
    config.update(seed=42, resume=False, finetune=False)
    return config


def _test_config(root, weight):
    config = yaml.safe_load(open(TEST_YAML))
    config["data"].update(num_frames=SMALL["num_frames"], num_seeds=SMALL["num_seeds"],
                          num_target=SMALL["num_proposals"], num_gaussian=SMALL["num_gaussian"])
    config["model"]["sparse_eval"] = True
    config["test"].update(batch_size=1, ap_iou_thresholds=[0.05, 0.25], remove_far_box=False)
    config["generation"]["dump_results"] = False
    config.update(finetune=True, weight=[weight], seed=42, device={"num_workers": 2},
                  log={**config["log"], "path": os.path.join(root, "out")})
    return config


def _flax_payload(seed):
    """A perturbed flax init at the SMALL sizes (jitted: the eager init takes
    seconds longer), with smaller vote offsets so that some proposals are
    positive and every box term is live (as test_torch_train_step.py)."""
    model = jax_model(SMALL)
    key = jax.random.PRNGKey(seed)
    variables = jax.jit(lambda k: model.init({"params": k, "mdn": k}, jnp.zeros((1, 96, 53, 3), jnp.float32),
                                             train=False))(key)
    rng = np.random.RandomState(seed)
    payload = {k: _perturb(jax.tree_util.tree_map(np.asarray, dict(variables[k])), rng)
               for k in ("params", "batch_stats")}
    vote_head = payload["params"]["centervoting"]["conv_input"]["dense2"]
    vote_head["kernel"] = vote_head["kernel"] * np.float32(0.1)
    return payload


def _jax_step(payload, batch, key):
    """JAX's single-process step on a global batch: losses and gradients
    (f32, jit), the gradients as a state_dict."""
    model = jax_model(SMALL)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    gt = {k: jbatch[k] for k in GT_KEYS}

    @jax.jit
    def loss_and_grad(params):
        def loss_fn(p):
            out, _ = model.apply({"params": p, "batch_stats": payload["batch_stats"]}, jbatch["input_joints"],
                                 train=True, rngs={"mdn": key}, mutable=["batch_stats"])
            losses = jax_detection_loss(out, gt)
            return losses["total"], losses

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, losses), grads = loss_and_grad(payload["params"])
    grads = jax.tree_util.tree_map(np.asarray, grads)
    return {k: float(v) for k, v in losses.items()}, state_dict_from_flax(
        {"params": grads, "batch_stats": payload["batch_stats"]})


def _jax_eps(model, variables, x, key):
    """The noise of the JAX model's three MDN ``predict`` heads under rng
    ``key`` (torch_port_util.mdn_eps_from_jax, the keys recorded under jit)."""
    def keys_of(variables, x, key):
        keys = []

        def record(next_fun, args, kwargs, context):
            if isinstance(context.module, JaxMDNHead) and context.method_name == "predict":
                keys.append(args[1])
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(record):
            model.apply(variables, x, train=True, rngs={"mdn": key}, mutable=["batch_stats"])
        return keys

    keys = jax.jit(keys_of)(variables, x, key)
    B, P, G = x.shape[0], SMALL["num_proposals"], SMALL["num_gaussian"]
    return {name: np.asarray(jax.random.normal(jax.random.split(k)[0], (B, P, G, 1, dim)))
            for name, dim, k in zip(("center", "size", "heading"), (3, 3, 2), keys)}


# ---------------------------------------------------------------------------
# bf16 under data and tensor parallel: the reduced sums, the spread rule
# ---------------------------------------------------------------------------

F32_U = 2.0 ** -24  # float32's unit roundoff
BF16_LOSS_RTOL = 2e-2  # test_torch_bf16_train.py's bf16 loss band
COUNT_LOSSES = ("pos_ratio", "neg_ratio", "obj_acc")


def _chan(v, C):
    """(..., Wp) per-column -> (..., C) per-channel, as the chain folds."""
    return v.reshape(*v.shape[:-1], -1, C).sum(-2)


def forced_sequence(logs, rows, data_count):
    """What a one-process run is fed (``torch_ddp_worker.recorded_sums``'s
    ``forced``) to sum the terms the ranks summed: each site's reduced sums
    (a BatchNorm's divided by the data count, as the layer divides them)
    and each fused block's dout, the rows of ``logs`` (one log per rank
    that holds other rows) put back at ``rows`` (their rows of the batch)."""
    entries = [[e for e in log if e[0] in ("chain", "bn", "dout")] for log in logs]
    out = []
    for items in zip(*entries):
        kind, first, reduced = items[0]
        if kind == "dout":
            full = torch.empty((sum(map(len, rows)), *first.shape[1:]), dtype=first.dtype)
            for (_, t, _), r in zip(items, rows):
                full[r] = t
            out.append(full)
        else:
            out.append(reduced / data_count if kind == "bn" else reduced)
    return out


def one_process_sites(log, C):
    """(kind, sums, bound of their sum of |terms|, number of terms) of each
    reduction site of a forced one-process log, in call order.  Kernel 3's
    and 4's per-clip parts are the terms of theirs (both runs compute them
    alike from the same rows); the BN2 backward's terms dz and dz*y2 are
    bounded by |dout| and |dout*y2|, a BatchNorm's E|x| by sqrt(E[x^2])."""
    sites, y2s, rows, prev = [], [], None, (None, None)
    for j, (kind, a, _) in enumerate(log):
        nxt = log[j + 1] if j + 1 < len(log) else (None, None, None)
        if kind == "rows":
            rows = a
        elif kind == "bn":
            sites.append(("bn", a, torch.stack([a[1].clamp(min=0).sqrt(), a[1]]), rows))
        elif kind == "chain":
            if nxt[0] == "terms" and "y" in nxt[1]:  # BN1's column sums of y
                y = nxt[1]["y"].float()
                sites.append(("BN1", a, torch.stack([y.abs().sum(0), (y * y).sum(0)]), y.shape[0]))
            elif prev[0] == "terms" and "y" in prev[1]:  # kernel 3's summed parts
                parts = prev[1]["parts"]
                y2s.append(prev[1]["y2"].float())
                sites.append(("kernel 3", a, parts.abs().sum(0), parts.shape[0]))
            elif prev[0] == "dout":  # the BN2 backward's [sum dz, sum dz*y2] per channel
                dout = prev[1].reshape(-1, prev[1].shape[-1])
                mag = _chan(torch.stack([dout.abs().sum(0), (dout * y2s.pop()).abs().sum(0)]), C)
                sites.append(("BN2 backward", a, mag, dout.shape[0] * (dout.shape[-1] // C)))
            else:  # kernel 4's summed parts per channel
                parts = prev[1]["parts"]
                sites.append(("kernel 4", a, _chan(parts.abs().sum(0), C), parts.shape[0] * (parts.shape[-1] // C)))
        prev = (kind, a)
    return sites


def reduced_sums_gaps(logs, one_log, group, data_count, C=64):
    """Every rank's reduced sums against one process's sums of the same
    terms (``one_log``, forced by ``forced_sequence``): the largest |gap| /
    (2 n u sum|terms| + 4 u |sum|) by site kind, where n terms summed in any
    order err by at most (n - 1) u sum|terms| (u = 2**-24).  Asserts the
    ranks' results bit-equal, and rank 0's the f32 sum of the local sums of
    the ranks ``group`` (its data group)."""
    sites = one_process_sites(one_log, C)
    ranks = [[e for e in log if e[0] in ("chain", "bn")] for log in logs]
    assert all(len(r) == len(sites) for r in ranks), ([len(r) for r in ranks], len(sites))
    worst = {}
    for i, (kind, want, mag, n) in enumerate(sites):
        reduced = ranks[0][i][2]
        assert all(torch.equal(r[i][2], reduced) for r in ranks), (i, kind)
        local = ranks[group[0]][i][1]
        for g in group[1:]:
            local = local + ranks[g][i][1]
        assert torch.equal(reduced, local), (i, kind)
        got = reduced / data_count if kind == "bn" else reduced
        band = 2 * n * F32_U * mag + 4 * F32_U * want.abs()
        worst[kind] = max(worst.get(kind, 0.0), ((got - want).abs() / band).max().item())
    return worst


def _relative_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def hold_bf16_step(got, one, other, single, sharded):
    """ROADMAP §3's bf16 rule (a run's spread, not elementwise) on a
    sharded bf16 step: ``got`` the ranks' step 1 (losses, gradients,
    running statistics), ``one`` and ``other`` the port's one process on the
    same batch in its order and in another, ``single`` and ``sharded`` JAX's
    single-device and sharded steps ((losses, state_dict)).  The spread of
    each gradient and running statistic (relative L2) is the larger of the
    distance of JAX's two steps and that of the port's two one-process
    runs (both sum the same terms in another order, as a sharded step
    does).  Each is within three times its spread of the port's one
    process, and of JAX's sharded step within three times the larger of
    its spread and the port's one-process distance from JAX's single-device
    step (the port's bf16 step is held against JAX's by
    test_torch_bf16_train.py), +1e-3 each; the losses likewise, with the
    bf16 loss band (2e-2 relative) at least and the proposal counts within
    one proposal.  Returns the largest ratio of a distance to its band."""
    (single_losses, single_sd), (sharded_losses, sharded_sd) = single, sharded
    worst = 0.0
    for k, want in sharded_losses.items():
        spread = max(abs(single_losses[k] - want), abs(other["losses"][0][k] - one["losses"][0][k]))
        slack = (1.0 / 32 if k in COUNT_LOSSES else 0.0) + BF16_LOSS_RTOL * abs(want)
        own = abs(one["losses"][0][k] - single_losses[k])
        for gap, band in ((abs(got["losses"][0][k] - one["losses"][0][k]), 3 * spread + slack),
                          (abs(got["losses"][0][k] - want), 3 * max(spread, own) + slack)):
            assert gap <= band, (k, got["losses"][0][k], one["losses"][0][k], want, single_losses[k])
            worst = max(worst, gap / band)
    stats = [k for k in got["state"][0] if k.endswith(("running_mean", "running_var"))]
    triples = [(k, got["grads"][k], one["grads"][k], other["grads"][k]) for k in got["grads"]
               if not k.endswith("tcn.2.bias")]
    triples += [(k, got["state"][0][k], one["state"][0][k], other["state"][0][k]) for k in stats]
    for k, g, o, o2 in triples:
        spread = max(_relative_l2(single_sd[k], sharded_sd[k]), _relative_l2(o2, o))
        own = _relative_l2(o, single_sd[k])
        for gap, band in ((_relative_l2(g, o), 3 * spread + 1e-3),
                          (_relative_l2(g, sharded_sd[k]), 3 * max(spread, own) + 1e-3)):
            assert gap <= band, (k, gap, band, spread, own)
            worst = max(worst, gap / band)
    return worst


def bf16_one_process(inputs, fused, forced=None, order=None):
    """``torch_ddp_worker.bf16_steps`` in this process on the whole batch
    (its rows in ``order`` when given), at the ranks' thread count (the
    CPU's matmuls round by their thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(BF16_RANK_THREADS)
    try:
        return bf16_steps(dict(inputs, paths=[fused], order=order), one_process=True,
                          forced=None if forced is None else {fused: forced})[fused]
    finally:
        torch.set_num_threads(threads)


def jax_bf16_step(payload, batch, key, fused, mesh=None, tp=False):
    """JAX's bf16 step (jit) on a global batch: on one device, or on
    ``mesh`` with the batch on its data axis and the state replicated (with
    ``tp``: placed by ``shard_params``), as tests/test_parallel.py builds
    its sharded steps.  Returns the losses and, as one state_dict, the
    gradients and the new batch statistics."""
    model = jax_model(SMALL, compute_dtype="bfloat16", fused_train=fused)
    params, stats = payload["params"], payload["batch_stats"]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if mesh is not None:
        place = (lambda t: shard_params(t, mesh)) if tp else (lambda t: replicate(t, mesh))
        params, stats, jbatch = place(params), place(stats), shard_batch(batch, mesh)

    @jax.jit
    def loss_and_grad(params, jbatch):
        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": stats}, jbatch["input_joints"], train=True,
                                   rngs={"mdn": key}, mutable=["batch_stats"])
            losses = jax_detection_loss(out, {k: jbatch[k] for k in GT_KEYS})
            return losses["total"], (losses, mut)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, (losses, mut)), grads = loss_and_grad(params, jbatch)
    f32 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    return {k: float(v) for k, v in losses.items()}, state_dict_from_flax(
        {"params": f32(grads), "batch_stats": f32(mut["batch_stats"])})


def mesh_test_config(root, weight, dtype="float32", multi_mode=True, model_parallel=1):
    """``_test_config`` with mesh AP (0.25 m voxels), ``multi_mode`` and its
    dumps, in ``dtype`` at tensor-parallel degree ``model_parallel``."""
    config = _test_config(root, weight)
    config["model"]["compute_dtype"] = dtype
    config["device"]["model_parallel"] = model_parallel
    config["test"].update(multi_mode=multi_mode, eval_mesh_ap=True, mesh_voxel_size=0.25)
    config["generation"].update(dump_results=multi_mode, dump_threshold=0.05)
    return config


def hold_sharded_test_runs(runs, configs, root, scenes, batch_size, noise_of, monkeypatch):
    """Sharded test runs (``torch_ddp_worker.test_runs``' results of every
    rank, ``runs[rank][i]`` for ``configs[i]``) against one process over the
    same scenes at ``batch_size``, fed each run's drawn salt and sample
    count and each batch's noise ``noise_of(i, it)`` (as the ranks drew
    it): the salt and the sample count equal on every rank; every metric
    (per-class AP and recall, mAP, AR and their mesh twins) within 1e-6;
    the mAP each run's log holds (the max-mAP inputs) within 1e-6; for the
    multi-mode runs, the dumps of every batch, and the max mAP and TMD over
    them within 1e-6."""
    sets, wants = {}, []
    for i, (config, run) in enumerate(zip(configs, runs[0])):
        assert all((r[i]["salt"], r[i]["n_samples"]) == (run["salt"], run["n_samples"]) for r in runs)
        multi_mode = config["test"]["multi_mode"]
        assert (run["salt"] is not None) == multi_mode
        one = yaml.safe_load(yaml.safe_dump(config))
        one["log"]["path"] = str(root / f"one{i}")
        one["test"]["batch_size"] = batch_size
        one["device"]["model_parallel"] = 1
        monkeypatch.setattr(test_runner, "multi_mode_draws",
                            lambda path, seed, run=run: (run["salt"], run["n_samples"]))
        monkeypatch.setattr(test_runner, "multi_mode_noise", lambda model, it, *_, i=i: noise_of(i, it))
        cfg = CONFIG(one, mode="test")
        threads = torch.get_num_threads()
        torch.set_num_threads(BF16_RANK_THREADS)  # the ranks': the CPU's matmuls round by their thread count
        try:
            want = test_runner.run(cfg, device="cpu", dataset=SceneDataset(scenes, num_frames=SMALL["num_frames"]))
        finally:
            torch.set_num_threads(threads)
            cfg.close()
        wants.append(want[0.05])
        for r in runs:
            for t, metrics in want.items():
                assert list(r[i]["metrics"][t]) == list(metrics)
                for k, v in metrics.items():
                    assert abs(r[i]["metrics"][t][k] - v) <= 1e-6, (i, t, k, r[i]["metrics"][t][k], v)
        np.testing.assert_allclose(multi_modal.scrape_map_scores(run["save_path"]),
                                   multi_modal.scrape_map_scores(cfg.save_path), atol=1e-6, rtol=0)
        if multi_mode:
            dumped = sorted(os.listdir(os.path.join(run["save_path"], "visualization")))
            assert len(dumped) == len(scenes) // batch_size == len(os.listdir(cfg.config["log"]["vis_path"]))
            sets.setdefault(config["model"]["compute_dtype"], []).append((run["save_path"], cfg.save_path))
    assert max(w["mAP"] for w in wants) > 0 and max(w["mAP_mesh"] for w in wants) > 0, wants
    for pairs in sets.values():  # the runs of one model
        (got_max, got_tmd), (want_max, want_tmd) = (multi_modal.multi_modal_metrics([p[0] for p in pairs]),
                                                    multi_modal.multi_modal_metrics([p[1] for p in pairs]))
        np.testing.assert_allclose(got_max, want_max, atol=1e-6, rtol=0)
        assert len(pairs) > 1 and abs(got_tmd - want_tmd) <= 1e-6 and want_tmd > 1, (got_tmd, want_tmd)


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """Starts two ranks on every scenario, then computes JAX's step while
    they run (and the tests their one-process references).  Yields (the
    case: its inputs and JAX's losses and gradients, the ranks' handle)."""
    root = tmp_path_factory.mktemp("ddp")
    payload = _flax_payload(5)
    # global batch 4: two ranks of 2.  On this batch JAX's f32 gradient is
    # within 1.6e-5 of max|g| of the port's float64 one (the f32 gradients
    # of both packages are ill-conditioned on most batches, ROADMAP §3)
    batch = scene_batch(44, 4, SMALL["num_frames"])
    key = jax.random.PRNGKey(11)
    eps = _jax_eps(jax_model(SMALL), payload, jnp.asarray(batch["input_joints"]), key)
    state_dict = state_dict_from_flax(payload)
    weights = P2RNet(P2RNetConfig(**SMALL), device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    # the size head's mixture means for ~1.5 m boxes: AP > 0 on random weights
    weights["detection.gmm_size.mdn.mu"].fill_(2 * np.log(1.5) / SMALL["num_gaussian"])
    weight_path = str(root / "weights.pth")
    torch.save({"net": weights}, weight_path)
    scenes = _scenes(6, 16)
    inputs = {
        "train_steps": {"sizes": SMALL, "state_dict": state_dict, "batch": batch, "eps": eps,
                        "optimizer": OPTIMIZER},
        "train_run": {"config": _train_config(str(root / "ddp_train"), batch=2), "num_frames": SMALL["num_frames"],
                      "scenes": {"train": scenes[:8], "val": scenes[8:12]}},
        "train_run_lr": {"config": _train_config(str(root / "ddp_train_lr"), batch=2, lr=OPTIMIZER["lr"]),
                         "num_frames": SMALL["num_frames"], "scenes": {"train": scenes[:8], "val": scenes[8:12]}},
        "test_run": {"config": _test_config(str(root / "ddp_test"), weight_path),
                     "num_frames": SMALL["num_frames"], "scenes": scenes[12:16]},
    }
    ranks = Ranks(2, inputs, root / "ranks")
    try:
        yield {"inputs": inputs, "jax_step": _jax_step(payload, batch, key), "payload": payload, "key": key,
               "scenes": scenes, "weight_path": weight_path, "root": root}, ranks
    finally:
        ranks.close()


@pytest.fixture(scope="module")
def ddp_bf16(ddp):
    """The bf16 scenarios on two new ranks, started once ``ddp``'s have
    finished (two sessions, each well inside the ranks' time limit on a
    loaded host, and JAX's bf16 steps out of the first one's way): the bf16
    steps of ``ddp``'s batch, the bf16 train runner, the sharded test runs;
    JAX's single-device and sharded bf16 steps are computed while they run.
    Yields (the case, the ranks)."""
    case, first = ddp
    first.results()
    root, payload, key, scenes = case["root"], case["payload"], case["key"], case["scenes"]
    steps = case["inputs"]["train_steps"]
    bf16_run = _train_config(str(root / "ddp_bf16_train"), batch=2)
    bf16_run["model"] = {**(bf16_run.get("model") or {}), "compute_dtype": "bfloat16"}
    test_runs = [mesh_test_config(str(root / f"ddp_test_{k}"), case["weight_path"], dtype, multi_mode)
                 for k, (dtype, multi_mode) in enumerate([("float32", True)] * 2 + [("bfloat16", True)] * 2
                                                         + [("float32", False)])]
    inputs = {
        "bf16_steps": dict(steps, paths=[True, False]),
        "bf16_train_run": {"config": bf16_run, "num_frames": SMALL["num_frames"],
                           "scenes": {"train": scenes[:8], "val": scenes[8:12]}},
        "test_runs": {"configs": test_runs, "num_frames": SMALL["num_frames"], "scenes": scenes[12:16]},
    }
    ranks = Ranks(2, inputs, root / "bf16_ranks", threads=BF16_RANK_THREADS)
    try:
        mesh = make_mesh(jax.devices()[:2])
        jax_bf16 = {(kind, fused): jax_bf16_step(payload, steps["batch"], key, fused,
                                                 mesh if kind == "sharded" else None)
                    for fused in (True, False) for kind in ("single", "sharded")}
        yield {"inputs": inputs, "jax_bf16": jax_bf16}, ranks
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
    cfg = CONFIG(_train_config(str(tmp_path), batch=4), mode="train")
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
            assert _rel(got[0]["state"][k], v) <= 1e-5, k


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
    cfg = CONFIG(_test_config(str(tmp_path), inputs["config"]["weight"][0]), mode="test")
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
        assert _rel(g, want) <= 1e-3, (k, _rel(g, want))


def _single_steps(inputs, fused):
    """The port's single process on the whole batch, float64: the same two
    steps; (losses, final state)."""
    model = P2RNet(P2RNetConfig(**SMALL, fused_train=fused), device="cpu")
    model.load_state_dict(inputs["state_dict"])
    model.double()
    optimizer, _, clip_norm = make_optimizer(model, OPTIMIZER)
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch_to_device(inputs["batch"], "cpu").items()}
    eps = {k: torch.from_numpy(v.copy()).double() for k, v in inputs["eps"].items()}
    losses = [{k: float(v) for k, v in train_step(model, optimizer, batch, eps=eps, clip_norm=clip_norm)[0].items()}
              for _ in range(2)]
    return losses, model.state_dict()


def _rel(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


@pytest.mark.parametrize("fused", [True, False], ids=["fused_chain", "module_path"])
def test_ddp_train_steps_match_one_process(ddp, fused):
    """Two ranks of 2 against one process of 4, in float64: parameters and
    running statistics after two AdamW steps (weight decay, clipping)
    within 1e-5 relative, the losses too; both ranks' states
    bit-equal (the objectness statistics are float32 in every run: within
    1e-6).  The module path's conv biases have an analytically zero
    gradient (BN2 absorbs them) of rounding size, whose AdamW step is the
    sign of that noise: they are held to that (the fused chain's is exactly
    0)."""
    case, ranks = ddp
    losses, state = _single_steps(case["inputs"]["train_steps"], fused)
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
        assert _rel(got[0]["state"][k], v) <= 1e-5, (k, _rel(got[0]["state"][k], v))


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
def test_ddp_bf16_step_matches_jax_sharded(ddp_bf16, fused):
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
    one = bf16_one_process(case["inputs"]["bf16_steps"], fused)
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
    other = bf16_one_process(case["inputs"]["bf16_steps"], fused, order=[3, 1, 0, 2])
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
    config = _train_config(str(tmp_path), batch=4)
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


def test_cli_under_torchrun_on_cpu(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    pose2room_tpu_torch --mode test --device cpu`` on a synthetic split:
    both ranks join a gloo group, one run dir with one out_config.yaml."""
    synth.write_synthetic_dataset(str(tmp_path / "ds"), n_train=1, n_test=4, seed=3, n_frames=120)
    config = _test_config(str(tmp_path), None)
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

