#!/usr/bin/env python3
"""How often the port's bf16 eval rounds differently from the JAX package's,
on the CPU (no card needed).

1. The bf16 graph matmul + BN1 + ReLU and the epilogue's plain version at a
   full-width block (B=2, T=96, 3456 columns, random operands): the share
   of bf16 outputs that differ from JAX's and the largest distance in ulps.
2. ``generate`` at the small shape (T=96, 64 seeds, 16 proposals, 10
   gaussians) on seeded weights, for clips 0-7 and each chain (dense,
   sparse, module path): how many proposal indices differ from JAX's jit
   and eager runs.

Run from the repository root: ``JAX_PLATFORMS=cpu python scripts/torch_bf16_vs_jax.py``.
"""

import os
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from pose2room_tpu.models import P2RNet as JaxP2RNet  # noqa: E402
from pose2room_tpu.ops import stgcn_fused as jax_fused  # noqa: E402
from pose2room_tpu_torch.ops import stgcn_fused  # noqa: E402
from torch_port_util import SMALL, flax_payload, jax_model, port_model, walking_clip  # noqa: E402

BF16 = torch.bfloat16


def ordinal(a):
    u = (np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32) >> 16).astype(np.int64)
    return np.where(u & 0x8000, -(u & 0x7FFF), u)


def flips(got, ref):
    d = np.abs(ordinal(got.float().numpy()) - ordinal(np.asarray(ref, np.float32)))
    return (d > 0).mean(), int(d.max())


def ops():
    rng = np.random.RandomState(0)
    B, T, Wp = 2, 96, 3456
    x = np.maximum(rng.randn(B, T, Wp), 0).astype(np.float32)
    M = (rng.randn(Wp, Wp) * 0.02).astype(np.float32)
    vecs = np.zeros((8, Wp), np.float32)
    vecs[:4] = rng.randn(4, Wp) * 0.1
    vecs[0] += 1.0
    vecs[2] += 1.0
    taps = (rng.randn(3, 64, 64) * 0.1).astype(np.float32)
    KB = np.einsum("sio,pq->spiqo", taps, np.eye(2, dtype=np.float32)).reshape(3, 128, 128)
    jx, jM, jKB = (jnp.asarray(a, jnp.bfloat16) for a in (x, M, KB))
    tx, tM, tKB = (torch.from_numpy(a).to(BF16) for a in (x, M, KB))
    tv = torch.from_numpy(vecs)
    jt1 = jax.jit(jax_fused._graph_matmul_bn_relu)(jx, jM, jnp.asarray(vecs[0]), jnp.asarray(vecs[1]))
    pt1 = stgcn_fused.graph_matmul_bn_relu(tx, tM, tv[0], tv[1])
    share, worst = flips(pt1, jt1)
    print(f"graph matmul + BN1 + ReLU (B={B}, T={T}, {Wp} columns): {share:.2e} of outputs differ, "
          f"at most {worst} ulp")
    for residual in (True, False):
        ref = jax.jit(jax_fused.epilogue_merged_ref, static_argnames="residual")(
            jnp.asarray(pt1.float().numpy(), jnp.bfloat16), jx if residual else None, jnp.asarray(vecs), jKB,
            residual=residual)
        got = stgcn_fused.epilogue_merged_ref(pt1, tx if residual else None, tv, tKB, residual=residual)
        share, worst = flips(got, ref)
        print(f"epilogue, residual={residual}: {share:.2e} of outputs differ, at most {worst} ulp")


def generate():
    payload = flax_payload(SMALL["num_gaussian"], seed=3)
    variables = {"params": payload["params"], "batch_stats": payload["batch_stats"]}
    for name, kw in (("dense", {}), ("sparse", dict(sparse_eval=True)), ("module", dict(fused_eval=False))):
        jm = jax_model(SMALL, compute_dtype="bfloat16", **kw)
        jit_fn = jax.jit(lambda v, x, m=jm: m.apply(v, x, method=JaxP2RNet.generate))
        model = port_model(SMALL, payload, compute_dtype="bfloat16", **kw)
        folded = model.fold_eval()
        rows = []
        for seed in range(8):
            x = walking_clip(np.random.RandomState(seed), 2, SMALL["num_frames"])
            jit_inds = np.asarray(jit_fn(variables, x)["aggregated_vote_inds"])
            eager_inds = np.asarray(jm.apply(variables, x, method=JaxP2RNet.generate)["aggregated_vote_inds"])
            port_inds = model.generate(torch.from_numpy(x), folded=folded)["aggregated_vote_inds"].numpy()
            rows.append(f"clip {seed}: port vs jit {(port_inds != jit_inds).sum()}, "
                        f"port vs eager {(port_inds != eager_inds).sum()}, jit vs eager {(jit_inds != eager_inds).sum()}")
        print(f"{name} chain, proposal indices that differ (of {2 * SMALL['num_proposals']}):")
        for r in rows:
            print("  " + r)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    ops()
    generate()
