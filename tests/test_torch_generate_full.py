"""The port's whole ``generate`` against the JAX package at production shape
(T=768, 512 seeds, 128 proposals, 100 gaussians, B=1) on the demo clip, and
at B=64 at the SMALL sizes, on the CPU with the same seeded weights."""

import os

import numpy as np
import pytest
import torch

import jax

from pose2room_tpu.data.dataset import load_demo_clip as jax_load_demo_clip
from pose2room_tpu.models import P2RNet as JaxP2RNet
from pose2room_tpu_torch.data.dataset import load_demo_clip
from torch_port_util import (
    FULL,
    SMALL,
    assert_generate_close,
    flax_payload,
    jax_model,
    port_model,
    to_numpy,
    walking_clip,
)

DEMO_CLIP = os.path.join(os.path.dirname(__file__), "..", "demo", "inputs", "input_joints_1.npy")


@pytest.fixture(scope="module")
def clip():
    x = load_demo_clip(DEMO_CLIP, num_frames=768)[None]
    np.testing.assert_array_equal(x[0], jax_load_demo_clip(DEMO_CLIP, num_frames=768))
    return x


def test_generate_production_shape_matches_jax(clip):
    payload = flax_payload(FULL["num_gaussian"], seed=5)
    variables = {"params": payload["params"], "batch_stats": payload["batch_stats"]}
    ref = jax.tree_util.tree_map(
        np.asarray, jax_model(FULL).apply(variables, clip, method=JaxP2RNet.generate)
    )
    model = port_model(FULL, payload)
    got = to_numpy(model.generate(torch.from_numpy(clip), folded=model.fold_eval()))
    assert got["seed_inds"].shape == (1, 512) and got["center"].shape == (1, 128, 3)
    assert got["pi"]["center"].shape == (1, 128, 100)
    assert_generate_close(got, ref)


def test_generate_batch_64_matches_jax():
    """``generate`` at B=64 (the batch the card sweeps beside 128) at the
    SMALL sizes against the JAX package's on the same weights and clips, in
    the serving band (test_torch_parity.py's); and its rows against the
    port's two B=32 calls on the halves in that band (indices equal)."""
    payload = flax_payload(SMALL["num_gaussian"], seed=7)
    clip = walking_clip(np.random.RandomState(4), 64, SMALL["num_frames"])
    variables = {"params": payload["params"], "batch_stats": payload["batch_stats"]}
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(lambda v, x: jax_model(SMALL).apply(
        v, x, method=JaxP2RNet.generate))(variables, clip))
    model = port_model(SMALL, payload)
    folded = model.fold_eval()
    got = to_numpy(model.generate(torch.from_numpy(clip), folded=folded))
    assert got["seed_inds"].shape == (64, SMALL["num_seeds"]) and got["center"].shape == (64, SMALL["num_proposals"], 3)
    assert_generate_close(got, ref)
    halves = [to_numpy(model.generate(torch.from_numpy(clip[h:h + 32]), folded=folded)) for h in (0, 32)]
    whole = {k: ({j: np.concatenate([h[k][j] for h in halves]) for j in v} if isinstance(v, dict)
                 else np.concatenate([h[k] for h in halves])) for k, v in halves[0].items()}
    assert_generate_close(got, whole)
