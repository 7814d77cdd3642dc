"""Shared helpers of the tests/test_torch_*.py suites (JAX package vs port).

The same seeded numpy weights and inputs go through pose2room_tpu (the
reference, on the CPU) and pose2room_tpu_torch (the port, on the CPU, where
each kernel wrapper runs its plain PyTorch version).
"""

import os

import flax.linen as nn
import numpy as np
import torch
import yaml

import jax
import jax.numpy as jnp

from pose2room_tpu.config.dataset_config import DatasetConfig as JaxDatasetConfig
from pose2room_tpu.eval import ap as jax_ap
from pose2room_tpu.eval import parse as jax_parse
from pose2room_tpu.eval.voxels import voxelize_box as jax_voxelize_box
from pose2room_tpu.models import P2RNet as JaxP2RNet
from pose2room_tpu.models import P2RNetConfig as JaxP2RNetConfig
from pose2room_tpu.models.mdn import MDNHead as JaxMDNHead
from pose2room_tpu_torch.convert import state_dict_from_flax
from pose2room_tpu_torch.data import synth
from pose2room_tpu_torch.data.dataset import sample_to_item
from pose2room_tpu_torch.data.loader import collate
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_YAML = os.path.join(REPO, "configs", "config_files", "p2rnet_test.yaml")
SMALL = dict(num_frames=96, num_seeds=64, num_proposals=16, num_gaussian=10)
FULL = dict(num_frames=768, num_seeds=512, num_proposals=128, num_gaussian=100)


def _perturb(tree, rng, path=()):
    """Give BatchNorm stats/affines, biases and edge importances non-trivial
    values, so every folding term is exercised (flax init leaves them 0/1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, path + (k,))
            continue
        v = np.asarray(v, dtype=np.float32)
        if k in ("scale", "var") or k.startswith("edge_importance"):
            v = rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            v = (rng.randn(*v.shape) * 0.05).astype(np.float32)
        out[k] = v
    return out


def flax_payload(num_gaussian, seed=0, vote_factor=1):
    """{'params', 'batch_stats'} numpy pytree of a flax P2RNet init on the
    CPU.  Parameter shapes depend only on num_gaussian and vote_factor, so a
    short-clip init serves every clip length."""
    model = JaxP2RNet(config=JaxP2RNetConfig(
        num_frames=96, num_seeds=64, num_proposals=16, num_gaussian=num_gaussian,
        vote_factor=vote_factor,
    ))
    key = jax.random.PRNGKey(seed)
    variables = model.init(
        {"params": key, "mdn": key}, np.zeros((1, 96, 53, 3), np.float32), train=False
    )
    rng = np.random.RandomState(seed)
    return {
        "params": _perturb(jax.tree_util.tree_map(np.asarray, dict(variables["params"])), rng),
        "batch_stats": _perturb(
            jax.tree_util.tree_map(np.asarray, dict(variables["batch_stats"])), rng
        ),
    }


def jax_model(sizes, **kw):
    return JaxP2RNet(config=JaxP2RNetConfig(**{**sizes, **kw}))


def port_model(sizes, payload, device="cpu", **kw):
    model = P2RNet(P2RNetConfig(**{**sizes, **kw}), device=device)
    model.load_state_dict(state_dict_from_flax(payload), strict=True)
    return model


def walking_clip(rng, B, T):
    """(B, T, 53, 3) f32 pose clip drifting along x, as test_torch_parity uses."""
    x = (rng.randn(B, T, 53, 3) * 0.4).astype(np.float32)
    x[..., 0] += np.linspace(0, 3, T, dtype=np.float32)[None, :, None]
    x[..., 1] += 0.9
    return x


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        tree = tree.detach().cpu()
        return (tree.float() if tree.dtype == torch.bfloat16 else tree).numpy()
    return np.asarray(tree)


def assert_generate_close(port, ref, rows=None):
    """The bands of test_torch_parity.py:157-185.  ``rows``: a (B, P) mask of
    the proposals whose box outputs (center, size, heading) are held; all of
    them when None."""
    np.testing.assert_array_equal(port["seed_inds"], ref["seed_inds"])
    np.testing.assert_allclose(port["seed_features"], ref["seed_features"], atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(port["vote_xyz"], ref["vote_xyz"], atol=2e-4)
    np.testing.assert_allclose(port["vote_features"], ref["vote_features"], atol=2e-4)
    np.testing.assert_array_equal(port["aggregated_vote_inds"], ref["aggregated_vote_inds"])
    np.testing.assert_allclose(port["aggregated_vote_xyz"], ref["aggregated_vote_xyz"], atol=2e-4)
    for key in ("center", "size", "heading", "objectness_scores", "sem_cls_scores"):
        held = rows if rows is not None and key in ("center", "size", "heading") else slice(None)
        np.testing.assert_allclose(port[key][held], ref[key][held], atol=5e-4, err_msg=key)
    for key in ("center", "size", "heading"):
        np.testing.assert_allclose(port["pi"][key], ref["pi"][key], atol=5e-4, err_msg=f"pi/{key}")


def scene_batch(seed, B, num_frames):
    """A collated batch of synthetic scenes through the port's item path."""
    rng = np.random.RandomState(seed)
    items = []
    for _ in range(B):
        joints, instances = synth.make_scene(rng, n_objects=int(rng.randint(2, 6)), n_frames=200)
        items.append(sample_to_item(*synth.as_stored(joints, instances), rng,
                                    num_frames=num_frames, augment=True))
    batch = collate(items)
    batch.pop("sample_idx")
    return batch


def mdn_eps_from_jax(model, variables, x, key, sizes=SMALL):
    """The noise the JAX model's three MDN ``predict`` heads draw for rng
    ``key``: record each head's rng key (under jit: the eager forward takes
    seconds), then repeat its draw."""
    dims = []

    def keys_of(variables, x, key):
        keys = []

        def record(next_fun, args, kwargs, context):
            if isinstance(context.module, JaxMDNHead) and context.method_name == "predict":
                dims.append(context.module.out_dim)
                keys.append(args[1])
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(record):
            model.apply(variables, x, train=True, rngs={"mdn": key}, mutable=["batch_stats"])
        return keys

    keys = jax.jit(keys_of)(variables, x, key)
    B, P, G = x.shape[0], sizes["num_proposals"], sizes["num_gaussian"]
    return {
        name: np.asarray(jax.random.normal(jax.random.split(k)[0], (B, P, G, 1, dim)))
        for name, dim, k in zip(("center", "size", "heading"), dims, keys)
    }


def ordinal(a):
    """bf16 values (as an f32 array) -> integers in value order: adjacent
    bf16 values differ by 1, +0 and -0 are both 0."""
    u = (np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32) >> 16).astype(np.int64)
    return np.where(u & 0x8000, -(u & 0x7FFF), u)


def ulps(a, b):
    """Largest distance in bf16 ulps between two arrays of bf16 values."""
    return int(np.abs(ordinal(a) - ordinal(b)).max())


def f32(a):
    return to_numpy(a).astype(np.float32) if torch.is_tensor(a) else np.asarray(a, np.float32)


def jax_generate_multi(sizes, n_samples, **kw):
    """The JAX package's multi-mode ``generate``, jitted, that also returns
    the rng key each MDN head's ``generate_multi`` was given:
    fn(variables, x, key) -> (end_points, {"center", "size", "heading"} -> key)."""
    model = jax_model(sizes, **kw)

    def run(variables, x, key):
        keys = {}

        def record(next_fun, args, kwargs, context):
            if isinstance(context.module, JaxMDNHead) and context.method_name == "generate_multi":
                keys[context.module.name.removeprefix("gmm_")] = args[1]
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(record):
            out = model.apply(variables, x, multi_mode=True, n_samples=n_samples,
                              method=JaxP2RNet.generate, rngs={"mdn": key})
        return out, keys

    return jax.jit(run)


def jax_multi_draws(keys, B, n_samples, sizes=SMALL):
    """Repeat the draws of the JAX package's ``MDNHead._samples(sample_pi=True)``
    from each head's key: {"center", "size", "heading"} -> (eps (B, P, G, n, D),
    u (B, P, G, n)) as numpy, where jax.random.bernoulli(k_pi, pi) is
    ``uniform(k_pi, shape, pi's dtype) < pi``."""
    P, G = sizes["num_proposals"], sizes["num_gaussian"]
    out = {}
    for name, dim in (("center", 3), ("size", 3), ("heading", 2)):
        k_eps, k_pi = jax.random.split(keys[name])
        out[name] = (np.asarray(jax.random.normal(k_eps, (B, P, G, n_samples, dim))),
                     np.asarray(jax.random.uniform(k_pi, (B, P, G, n_samples), jnp.float32)))
    return out


def torch_noise(draws, device="cpu"):
    return {k: tuple(torch.from_numpy(np.array(a)).to(device) for a in v) for k, v in draws.items()}


def mask_agreement(draws, pi_a, pi_b):
    """(flipped weights, weights, (B, P) mask of the proposals whose Bernoulli
    masks ``u < pi`` agree in every head) of two pi sets on the same draws."""
    flips, total, rows = 0, 0, None
    for k, (_, u) in draws.items():
        a = u < np.asarray(pi_a[k], np.float32)[..., None]
        b = u < np.asarray(pi_b[k], np.float32)[..., None]
        flips += int((a != b).sum())
        total += a.size
        agree = (a == b).all(axis=(2, 3))
        rows = agree if rows is None else rows & agree
    return flips, total, rows


def small_test_config(root, split_dir, thresholds, weight=None, **test_knobs):
    """p2rnet_test.yaml at the SMALL sizes with the sparse chain, batches of
    2, no dumps, ``weight`` finetuned when given, logs under ``root``."""
    config = yaml.safe_load(open(TEST_YAML))
    config["data"].update(split=split_dir, num_frames=SMALL["num_frames"], num_seeds=SMALL["num_seeds"],
                          num_target=SMALL["num_proposals"], num_gaussian=SMALL["num_gaussian"])
    config["model"]["sparse_eval"] = True
    config["test"].update(batch_size=2, ap_iou_thresholds=thresholds, **test_knobs)
    config["generation"]["dump_results"] = False
    config.update(finetune=weight is not None, weight=[weight] if weight else [], seed=42,
                  device={"num_workers": 2}, log={**config["log"], "path": os.path.join(root, "out")})
    return config


def jax_test_metrics(outputs, thresholds, knobs, mesh_voxel_size=None):
    """The JAX package's test path from ``generate`` on: parse, assembly,
    ``APCalculator`` and loss means over [(arrays, end_points, losses)], and
    with ``mesh_voxel_size`` the voxelized scans (each distinct box once, as
    JAX runners/test.py:114-132) and ``compute_metrics_w_mesh``.  Returns
    ({thresh: metrics}, mean losses, number of pred entries)."""
    ds_cfg = JaxDatasetConfig()
    test_cfg = yaml.safe_load(open(TEST_YAML))["test"]
    eval_cfg = {
        "dataset_config": ds_cfg, "remove_far_box": test_cfg["remove_far_box"], "use_3d_nms": True,
        "nms_iou": test_cfg["nms_iou"], "use_old_type_nms": False, "cls_nms": False,
        "per_class_proposal": True, "conf_thresh": test_cfg["conf_thresh"], "sample_cls": False,
        **knobs,
    }
    calcs = {t: jax_ap.APCalculator(t, ds_cfg.class2type) for t in thresholds}
    n_pred, sums = 0, {}
    for arrays, ep, losses in outputs:
        eval_dict, parsed = jax_parse.parse_predictions(ep, arrays, eval_cfg)
        pred_map = jax_parse.assembly_pred_map_cls(eval_dict, parsed, eval_cfg)["batch_pred_map_cls"]
        gt_map = jax_parse.assembly_gt_map_cls(jax_parse.parse_groundtruths(arrays))
        n_pred += sum(len(p) for p in pred_map)
        if mesh_voxel_size is not None:
            cache = {}

            def vox(box):
                box = np.asarray(box, dtype=np.float64)
                if box.tobytes() not in cache:
                    cache[box.tobytes()] = jax_voxelize_box(box, mesh_voxel_size)
                return cache[box.tobytes()]

            pred_map = [[(c, b, s, vox(b)) for c, b, s in scan] for scan in pred_map]
            gt_map = [[(c, b, vox(b)) for c, b in scan] for scan in gt_map]
        for calc in calcs.values():
            calc.step(pred_map, gt_map)
        for k, v in losses.items():
            sums[k] = sums.get(k, 0.0) + v
    means = {k: v / len(outputs) for k, v in sums.items()}
    compute = "compute_metrics_w_mesh" if mesh_voxel_size is not None else "compute_metrics"
    return {t: getattr(c, compute)() for t, c in calcs.items()}, means, n_pred
