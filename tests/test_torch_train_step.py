"""The port's train path against the JAX package, on the CPU.

* ``detection_loss`` term by term;
* AdamW + epoch MultiStepLR (+ global-norm clipping) against optax on
  identical gradients; the train options the JAX package acts on
  (``freeze``, ``optim_spec``, ``bnscheduler``, ``h2d_dtype``,
  ``profile_steps``) accepted and acting, ``device.model_parallel`` 2
  raising in one process (tests/test_torch_train_options.py holds them
  against the JAX package, tests/test_torch_tp.py the tensor-parallel mode);
* one whole train step at the SMALL sizes against JAX ``make_train_step``'s
  loss and ``value_and_grad``, with the MDN noise taken from the JAX
  package's own rng streams: loss terms, gradients, updated running stats,
  and the discrete choices (seeds, proposals);
* the data path: ``make_scene`` and the DataLoader (augmentation on) bit for
  bit against the JAX package's;
* the CLI's ``--mode train --device cpu`` for one epoch, whose
  ``model_final.pth`` the demo runner then loads;
* imports: no JAX, no JAX package and no h5py in the port or chip_smoke.py.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from pose2room_tpu.data import synth as jax_synth
from pose2room_tpu.data.dataset import P2RNetDataset as JaxP2RNetDataset
from pose2room_tpu.data.loader import DataLoader as JaxDataLoader
from pose2room_tpu.models.loss import detection_loss as jax_detection_loss
from pose2room_tpu.train import state as jax_state
from pose2room_tpu.train.step import make_train_step as jax_make_train_step
from pose2room_tpu_torch import __main__ as cli
from pose2room_tpu_torch.config.loader import CONFIG
from pose2room_tpu_torch.convert import state_dict_from_flax
from pose2room_tpu_torch.data import synth
from pose2room_tpu_torch.data.dataset import P2RNetDataset, SceneDataset
from pose2room_tpu_torch.data.loader import DataLoader
from pose2room_tpu_torch.models.loss import detection_loss
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
from pose2room_tpu_torch.parallel import make_grid, model_parallel_of
from pose2room_tpu_torch.runners import common
from pose2room_tpu_torch.train import state
from pose2room_tpu_torch.train.step import GT_KEYS, batch_to_device, train_step
from pose2room_tpu_torch.utils.profiling import ProfileWindow
from torch_golden import goldens  # noqa: F401  (a fixture)
from torch_port_util import SMALL, jax_model, mdn_eps_from_jax, port_model, scene_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_YAML = os.path.join(REPO, "configs", "config_files", "p2rnet_train.yaml")


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _loss_inputs(rng, B=2, S=48, T=64, P=32):
    joints = (rng.randn(B, S, 53, 3) * 0.3).astype(np.float32)
    joints[..., 0] += 1.0
    centers = (rng.randn(B, 10, 3) * 1.2).astype(np.float32)
    agg = np.concatenate([centers[:, :4] + rng.randn(B, 4, 3).astype(np.float32) * 0.1,
                          (rng.randn(B, P - 4, 3) * 1.5).astype(np.float32)], axis=1)
    end_points = {
        "seed_skeleton": joints,
        "seed_inds": np.sort(rng.choice(T, (B, S)), axis=1).astype(np.int32),
        "vote_xyz": (joints[:, :, 0] + rng.randn(B, S, 3) * 0.3).astype(np.float32),
        "aggregated_vote_xyz": agg,
        "center": (agg + rng.randn(B, P, 3) * 0.1).astype(np.float32),
        "size": (rng.randn(B, P, 3) * 0.8).astype(np.float32),
        "heading": rng.randn(B, P, 2).astype(np.float32),
        "objectness_scores": rng.randn(B, P, 2).astype(np.float32),
        "sem_cls_scores": rng.randn(B, P, 22).astype(np.float32),
    }
    gt = {
        "center_label": centers,
        "box_label_mask": (np.arange(10)[None] < np.array([[4], [7]])).astype(np.float32),
        "size": (rng.randn(B, 10, 3) * 0.5).astype(np.float32),
        "heading": rng.randn(B, 10, 2).astype(np.float32),
        "sem_cls_label": rng.randint(0, 22, (B, 10)).astype(np.int64),
        "vote_label": (rng.randn(B, T, 53, 9) * 0.8).astype(np.float32),
        "vote_label_mask": rng.randint(0, 2, (B, T, 53)).astype(np.int64),
    }
    return end_points, gt


@pytest.mark.parametrize("origin_joint_id", [0, 3])
def test_detection_loss_matches_jax(origin_joint_id):
    end_points, gt = _loss_inputs(np.random.RandomState(origin_joint_id))
    ref = jax_detection_loss(end_points, gt, origin_joint_id)
    got = detection_loss({k: torch.from_numpy(v) for k, v in end_points.items()},
                         {k: torch.from_numpy(v) for k, v in gt.items()}, origin_joint_id)
    assert set(got) == set(ref)
    assert 0 < float(got["pos_ratio"]) < 1
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optim_cfg", [
    {"lr": 1e-3},
    {"lr": 2e-3, "betas": [0.8, 0.99], "eps": 1e-6, "weight_decay": 0.05},
    {"lr": 1e-3, "weight_decay": 0.01, "clip_norm": 0.5},
])
def test_optimizer_matches_optax(optim_cfg):
    """3 steps on identical gradients, the LR dropping by gamma at epoch 2."""
    rng = np.random.RandomState(0)
    shapes = {"a": (4, 5), "b": (7,), "c": (3, 2, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 3).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    grads[1]["b"][:] = 0.0  # a near-zero gradient moves a parameter by up to lr on step 1
    milestones, gamma = [2], 0.1

    tx, info = jax_state.make_optimizer(optim_cfg)
    opt_state = tx.init(params)
    jparams = params
    port_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    optimizer, base_lrs, clip_norm = state.make_optimizer(
        torch.nn.ParameterList(port_params.values()), optim_cfg)
    for epoch, g in enumerate(grads):
        factor = gamma ** sum(1 for m in milestones if epoch >= m)
        opt_state = jax_state.apply_lr_schedule(opt_state, factor, info)
        updates, opt_state = tx.update(g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

        state.apply_lr_schedule(optimizer, base_lrs, state.lr_factor(milestones, gamma, epoch))
        for k, p in port_params.items():
            p.grad = torch.from_numpy(g[k].copy())
        grad_list = [p.grad for p in port_params.values()]
        norm = state.global_norm(grad_list)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        if clip_norm > 0:
            state.clip_by_global_norm(grad_list, clip_norm, norm)
        optimizer.step()
        for k, p in port_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), atol=1e-6, rtol=0,
                                       err_msg=f"step {epoch} {k}")


BNS = {"bn_momentum_init": 0.5, "bn_decay_rate": 0.5, "bn_decay_step": 20, "bn_momentum_max": 0.001}


@pytest.mark.parametrize("section", [
    {"train": {"freeze": ["backbone"]}},
    {"model": {"backbone": {"optim_spec": {"lr": 1e-4}}}},
    {"bnscheduler": {"bn_momentum_init": 0.5}},
    {"device": {"model_parallel": 2}},
    {"train": {"h2d_dtype": "float16"}},
    {"log": {"profile_steps": 3}},
])
def test_unported_train_options_raise(section, tmp_path):
    """Of these train options, which the JAX package acts on,
    device.model_parallel 2 raises in one process (the divisibility
    ValueError: 2 does not divide 1 process; tests/test_torch_tp.py runs it
    on two); each other one is accepted and acts: freeze leaves the module
    out of every param group,
    optim_spec gives its module its own lr (scheduled from its own base),
    bnscheduler sets every BatchNorm's momentum, h2d_dtype rounds the
    targets through float16 on the way to the device, and profile_steps
    traces its window of train steps."""
    if "device" in section:
        with pytest.raises(ValueError, match="model_parallel 2 must divide the 1 processes"):
            make_grid(model_parallel_of(section))
        return
    assert make_grid(model_parallel_of(section)) is None
    model = P2RNet(P2RNetConfig(**SMALL), device="cpu")
    freeze, specs = state.train_options(section)
    optimizer, base_lrs, _ = state.make_optimizer(model, {"lr": 1e-3}, freeze, specs)
    groups = {g["name"]: g for g in optimizer.param_groups}
    if freeze:
        assert set(groups) == {"centervoting", "detection"}
        grouped = {id(p) for g in optimizer.param_groups for p in g["params"]}
        assert not any(id(p) in grouped for p in model.backbone.parameters())
    elif specs:
        state.apply_lr_schedule(optimizer, base_lrs, 0.1)
        assert groups["backbone"]["lr"] == pytest.approx(1e-5, rel=1e-12)
        assert groups["detection"]["lr"] == groups["centervoting"]["lr"] == pytest.approx(1e-4, rel=1e-12)
    elif "bnscheduler" in section:
        m = state.bnm_momentum({**BNS, **section["bnscheduler"]}, 0)
        assert m == pytest.approx(0.5)
        model.set_bn_momentum(m)
        bns = [mod for mod in model.modules() if type(mod).__name__ == "BatchNorm"]
        assert len(bns) > 20 and all(b.momentum == m for b in bns)
    elif "train" in section:
        batch = scene_batch(1, 2, SMALL["num_frames"])
        got = batch_to_device(batch, "cpu", section["train"]["h2d_dtype"])
        assert torch.equal(got["input_joints"], torch.from_numpy(batch["input_joints"]))
        assert got["size"].dtype == torch.float32
        np.testing.assert_array_equal(got["size"].numpy(), batch["size"].astype(np.float16).astype(np.float32))
        assert not np.array_equal(got["vote_label"].numpy(), batch["vote_label"])
    else:
        window = ProfileWindow(tmp_path / "profile", start_step=3, n_steps=section["log"]["profile_steps"])
        x = torch.randn(64, 64)
        for step in range(8):
            window.maybe_start(step)
            x = torch.tanh(x @ x)
            window.maybe_stop(step + 1)
        assert len(glob.glob(str(tmp_path / "profile" / "*.pt.trace.json"))) == 1


# ---------------------------------------------------------------------------
# one whole train step against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_case(goldens):
    """The JAX side of one train step at the SMALL sizes (f32, fused train
    chain on its plain branch): losses, grads, new batch stats, end_points."""
    payload = goldens.flax_payload(SMALL["num_gaussian"], seed=5)
    # smaller vote offsets: votes stay near the hips, which walk through the
    # objects, so some proposals are positive and every box term is live
    vote_head = payload["params"]["centervoting"]["conv_input"]["dense2"]
    vote_head["kernel"] = vote_head["kernel"] * np.float32(0.1)
    variables = {"params": payload["params"], "batch_stats": payload["batch_stats"]}
    # The f32 gradient of the backbone is ill-conditioned on some batches:
    # rounding alone moves it by up to a few 1e-2 of max|g| (JAX jit vs JAX
    # eager, or the port in f32 vs f64; ROADMAP "Faults found").  On this
    # batch the port's f32 gradient is within 5e-4 of its f64 gradient, so
    # the 1e-3 band below tests the port, not the rounding.
    batch = scene_batch(5, 2, SMALL["num_frames"])
    model = jax_model(SMALL)
    key = jax.random.PRNGKey(11)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    eps = mdn_eps_from_jax(model, variables, jbatch["input_joints"], key)
    gt = {k: jbatch[k] for k in GT_KEYS}

    @jax.jit
    def loss_and_grad(params):
        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                   jbatch["input_joints"], train=True, rngs={"mdn": key},
                                   mutable=["batch_stats"])
            return jax_detection_loss(out, gt)["total"], (jax_detection_loss(out, gt), mut, out)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, (losses, mut, out)), grads = loss_and_grad(variables["params"])
    # the packaged step (jit, optax) on the same state gives the same losses and grad norm
    tx, _ = jax_state.make_optimizer({"lr": 1e-3})
    step_state = jax_state.TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                                      opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    _, step_losses = jax_make_train_step(model, tx)(step_state, jbatch, key)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(payload=payload, batch=batch, eps=eps, losses=to_np(losses),
                step_losses=to_np(step_losses), out=to_np(out),
                grads_sd=state_dict_from_flax({"params": to_np(grads), "batch_stats": to_np(mut["batch_stats"])}))


def test_train_step_matches_jax(step_case):
    model = port_model(SMALL, step_case["payload"])
    optimizer, _, _ = state.make_optimizer(model, {"lr": 1e-3})
    batch = batch_to_device(step_case["batch"], "cpu")
    eps = {k: torch.from_numpy(v.copy()) for k, v in step_case["eps"].items()}
    losses, end_points = train_step(model, optimizer, batch, eps=eps)

    for key in ("seed_inds", "aggregated_vote_inds"):
        np.testing.assert_array_equal(end_points[key].numpy(), step_case["out"][key], err_msg=key)
    ref = step_case["losses"]
    for k in ref:
        np.testing.assert_allclose(float(losses[k]), float(ref[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    for k in ("total", "grad_norm"):
        np.testing.assert_allclose(float(losses[k]), float(step_case["step_losses"][k]), rtol=1e-4,
                                   err_msg=f"make_train_step {k}")
    assert float(losses["pos_ratio"]) > 0  # the box terms see positive proposals

    ref_sd = step_case["grads_sd"]
    for name, p in model.named_parameters():
        g, want = p.grad.numpy(), ref_sd[name].numpy()
        np.testing.assert_allclose(g, want, atol=1e-3 * np.abs(want).max(), rtol=0, err_msg=name)
        if name.endswith("tcn.2.bias"):
            assert np.all(g == 0), name  # the fused chain's analytic zero
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), ref_sd[name].numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=name)


def test_train_step_module_path_and_eval_mode(step_case):
    """fused_train off (module path) gives the same gradients, compared in
    float64 so that the test sees the math and not the f32 conditioning; a
    forward in eval mode uses and keeps the running statistics."""
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in batch_to_device(step_case["batch"], "cpu").items()}
    eps = {k: torch.from_numpy(np.array(v)).double() for k, v in step_case["eps"].items()}
    grads = {}
    for fused in (True, False):
        model = port_model(SMALL, step_case["payload"], fused_train=fused).double()
        optimizer, _, _ = state.make_optimizer(model, {"lr": 1e-3})
        train_step(model, optimizer, batch, eps=eps)
        grads[fused] = {k: p.grad for k, p in model.named_parameters()}
    for k, g in grads[True].items():
        ref = grads[False][k]
        if k.endswith("tcn.2.bias"):
            assert torch.all(g == 0) and ref.abs().max() < 1e-9 * grads[False][k[:-6] + "3.bias"].abs().max()
            continue
        torch.testing.assert_close(g, ref, atol=1e-9 * ref.abs().max().item(), rtol=0, msg=k)
    model.eval()
    before = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad():
        out = model(batch["input_joints"], eps=eps)
    assert torch.isfinite(out["center"]).all()
    for k, v in model.named_buffers():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_make_scene_matches_jax():
    a = synth.make_scene(np.random.RandomState(3), n_objects=4, n_frames=50)
    b = jax_synth.make_scene(np.random.RandomState(3), n_objects=4, n_frames=50)
    np.testing.assert_array_equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert x["class_id"] == y["class_id"]
        for k in ("centroid", "R_mat", "size"):
            np.testing.assert_array_equal(x[k], y[k])
    np.testing.assert_array_equal(synth.votes_for_skeleton(*a), jax_synth.votes_for_skeleton(*b))


def test_loader_matches_jax(tmp_path):
    """Augmented, shuffled batches over two epochs, bit for bit; the
    in-memory SceneDataset reads the same items as the HDF5 files."""
    jax_synth.write_synthetic_dataset(str(tmp_path / "ds"), n_train=5, n_test=2, seed=4, n_frames=90)
    split = str(tmp_path / "ds" / "splits" / "script_level" / "train.json")
    kw = dict(num_frames=64, augment=True)
    ours = DataLoader(P2RNetDataset(split, **kw), batch_size=2, shuffle=True, seed=3, num_workers=2)
    ref = JaxDataLoader(JaxP2RNetDataset(split, **kw), batch_size=2, shuffle=True, seed=3, num_workers=2)
    rng = np.random.RandomState(4)
    scenes = [synth.as_stored(*synth.make_scene(rng, n_objects=int(rng.randint(2, 6)), n_frames=90))
              for _ in range(7)]
    mem = DataLoader(SceneDataset(scenes[:5], **kw), batch_size=2, shuffle=True, seed=3, num_workers=0)
    try:
        for epoch in (0, 1):
            for loader in (ours, ref, mem):
                loader.set_epoch(epoch)
            batches = list(zip(ours, ref, mem))
            assert len(batches) == len(ours) == 3
            for a, b, m in batches:
                assert set(a) == set(b)
                assert a["sample_idx"] == b["sample_idx"]
                for k in a:
                    if k != "sample_idx":
                        assert a[k].dtype == b[k].dtype, k
                        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                        np.testing.assert_array_equal(m[k], a[k], err_msg=f"in memory {k}")
    finally:
        ours.close()
        mem.close()


def test_loader_refuses_process_workers():
    """Process workers are ported (tests/test_torch_train_options.py holds
    their batches); a worker mode neither package knows raises ValueError,
    as in the JAX package."""
    with pytest.raises(ValueError, match="worker_mode"):
        DataLoader([], batch_size=1, worker_mode="fork")
    with pytest.raises(ValueError, match="worker_mode"):
        JaxDataLoader([], batch_size=1, worker_mode="fork")


# ---------------------------------------------------------------------------
# CLI and imports
# ---------------------------------------------------------------------------

def test_cli_train_on_cpu_then_demo_loads_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the TensorBoard board writes to ./runs
    synth.write_synthetic_dataset(str(tmp_path / "ds"), n_train=3, n_test=2, seed=1, n_frames=120)
    config = yaml.safe_load(open(TRAIN_YAML))
    config["data"].update(split=str(tmp_path / "ds" / "splits" / "script_level"),
                          num_frames=SMALL["num_frames"], num_seeds=SMALL["num_seeds"],
                          num_target=SMALL["num_proposals"], num_gaussian=SMALL["num_gaussian"])
    config["train"].update(epochs=1, batch_size=2)
    config["val"]["batch_size"] = 2
    config["device"]["num_workers"] = 2
    config["log"].update(path=str(tmp_path / "out"), print_step=1)
    yaml_path = tmp_path / "train.yaml"
    yaml_path.write_text(yaml.safe_dump(config))
    model, history = cli.main(["--config", str(yaml_path), "--mode", "train", "--device", "cpu"])
    assert len(history) == 1
    for phase in ("train", "val"):
        assert all(np.isfinite(v) for v in history[0][phase].values()), phase
    final = glob.glob(str(tmp_path / "out" / "train" / "*" / "model_final.pth"))
    best = glob.glob(str(tmp_path / "out" / "train" / "*" / "model_best.pth"))
    assert len(final) == 1 and len(best) == 1
    ckpt = torch.load(final[0], map_location="cpu", weights_only=True)
    assert set(ckpt) == {"net", "optimizer", "epoch", "min_loss"} and ckpt["epoch"] == 1

    demo_cfg = dict(config, finetune=True, weight=[final[0]], seed=0)
    demo_cfg["log"] = dict(config["log"], path=str(tmp_path / "demo_out"))
    cfg = CONFIG(demo_cfg, mode="demo")
    try:
        served = common.setup(cfg, device="cpu")[0]
    finally:
        cfg.close()
    for k, v in model.state_dict().items():
        assert torch.equal(served.state_dict()[k], v), k


def test_port_and_chip_smoke_import_no_jax_and_no_h5py():
    """The chip machine has neither JAX nor (necessarily) h5py."""
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
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pose2room_tpu', 'h5py'))\n"
        "assert 'pose2room_tpu_torch.train.engine' in names, names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
