"""Shared helpers of the tests/test_torch_*.py suites (JAX package vs port).

The same seeded numpy weights and inputs go through pose2room_tpu (the
reference, on the CPU) and pose2room_tpu_torch (the port, on the CPU, where
each kernel wrapper runs its plain PyTorch version).
"""

import flax.linen as nn
import numpy as np
import torch

import jax

from pose2room_tpu.models import P2RNet as JaxP2RNet
from pose2room_tpu.models import P2RNetConfig as JaxP2RNetConfig
from pose2room_tpu.models.mdn import MDNHead as JaxMDNHead
from pose2room_tpu_torch.convert import state_dict_from_flax
from pose2room_tpu_torch.data import synth
from pose2room_tpu_torch.data.dataset import sample_to_item
from pose2room_tpu_torch.data.loader import collate
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig

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


def assert_generate_close(port, ref):
    """The bands of test_torch_parity.py:157-185."""
    np.testing.assert_array_equal(port["seed_inds"], ref["seed_inds"])
    np.testing.assert_allclose(port["seed_features"], ref["seed_features"], atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(port["vote_xyz"], ref["vote_xyz"], atol=2e-4)
    np.testing.assert_allclose(port["vote_features"], ref["vote_features"], atol=2e-4)
    np.testing.assert_array_equal(port["aggregated_vote_inds"], ref["aggregated_vote_inds"])
    np.testing.assert_allclose(port["aggregated_vote_xyz"], ref["aggregated_vote_xyz"], atol=2e-4)
    for key in ("center", "size", "heading", "objectness_scores", "sem_cls_scores"):
        np.testing.assert_allclose(port[key], ref[key], atol=5e-4, err_msg=key)
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
    ``key``: record each head's rng key, then repeat its draw."""
    keys = []

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxMDNHead) and context.method_name == "predict":
            keys.append((context.module.out_dim, args[1]))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        model.apply(variables, x, train=True, rngs={"mdn": key}, mutable=["batch_stats"])
    B, P, G = x.shape[0], sizes["num_proposals"], sizes["num_gaussian"]
    return {
        name: np.asarray(jax.random.normal(jax.random.split(k)[0], (B, P, G, 1, dim)))
        for name, (dim, k) in zip(("center", "size", "heading"), keys)
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
