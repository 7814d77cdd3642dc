"""Inputs and hold rules that the port's data- and tensor-parallel test files
share (tests/test_torch_ddp.py, tests/test_torch_ddp_bf16.py,
tests/test_torch_tp.py, tests/test_torch_tp_bf16.py): scenes and configs
of the runners, the weights of the test runs, the reduced-sums rule and
the bf16 spread rule of a sharded step, and the one-process hold of
sharded test runs.  Their goldens come from tests/torch_golden.py.
"""

import os

import numpy as np
import torch
import yaml

from pose2room_tpu_torch.config.loader import CONFIG
from pose2room_tpu_torch.data import synth
from pose2room_tpu_torch.data.dataset import SceneDataset
from pose2room_tpu_torch.eval import multi_modal
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
from pose2room_tpu_torch.runners import test as test_runner
from torch_ddp_worker import BF16_RANK_THREADS
from torch_golden import OPTIMIZER
from torch_port_util import SMALL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_YAML = os.path.join(REPO, "configs", "config_files", "p2rnet_train.yaml")
TEST_YAML = os.path.join(REPO, "configs", "config_files", "p2rnet_test.yaml")

# the 22 leaves JAX ``shard_params`` puts on its model axis at the port's widths, as port keys
PLANNED = (
    [f"backbone.st_gcn_networks.{i}.gcn.conv.weight" for i in range(6)]
    + ["backbone.conv_joint.weight", "centervoting.conv_input.0.conv.weight", "centervoting.conv_input.1.conv.weight",
       "detection.vote_aggregation.mlp_module.0.weight", "detection.vote_aggregation.mlp_module.2.weight"]
    + [f"detection.conv_{h}.{i}.conv.weight" for h in ("center", "size", "heading", "sem_obj") for i in (0, 1)]
    + [f"detection.gmm_{h}.backbone.conv.weight" for h in ("center", "size", "heading")]
)


def make_scenes(seed, n, n_frames=120):
    rng = np.random.RandomState(seed)
    return [synth.as_stored(*synth.make_scene(rng, n_objects=int(rng.randint(2, 6)), n_frames=n_frames))
            for _ in range(n)]


def train_config(root, batch, lr=0.0):
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


def sparse_test_config(root, weight):
    """p2rnet_test.yaml at the SMALL sizes, sparse_eval, batches of 1,
    finetuned from ``weight``, logs under ``root``."""
    config = yaml.safe_load(open(TEST_YAML))
    config["data"].update(num_frames=SMALL["num_frames"], num_seeds=SMALL["num_seeds"],
                          num_target=SMALL["num_proposals"], num_gaussian=SMALL["num_gaussian"])
    config["model"]["sparse_eval"] = True
    config["test"].update(batch_size=1, ap_iou_thresholds=[0.05, 0.25], remove_far_box=False)
    config["generation"]["dump_results"] = False
    config.update(finetune=True, weight=[weight], seed=42, device={"num_workers": 2},
                  log={**config["log"], "path": os.path.join(root, "out")})
    return config


def metre_box_weights(path):
    """Random port weights (seed 3) with the size head's mixture means for
    ~1.5 m boxes (AP > 0 on random weights), saved as a checkpoint at
    ``path``; returns ``path``."""
    weights = P2RNet(P2RNetConfig(**SMALL), device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    weights["detection.gmm_size.mdn.mu"].fill_(2 * np.log(1.5) / SMALL["num_gaussian"])
    torch.save({"net": weights}, path)
    return path


def rel(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


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


def mesh_test_config(root, weight, dtype="float32", multi_mode=True, model_parallel=1):
    """``sparse_test_config`` with mesh AP (0.25 m voxels), ``multi_mode``
    and its dumps, in ``dtype`` at tensor-parallel degree ``model_parallel``."""
    config = sparse_test_config(root, weight)
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
