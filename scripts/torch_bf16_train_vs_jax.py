#!/usr/bin/env python3
"""How far the port's bf16 train step is from the JAX package's, and how far
the JAX package's own runs are from each other, on the CPU (no card needed).

At the small shape (T=96, 64 seeds, 16 proposals, 10 gaussians), on the
seeded weights of tests/test_torch_bf16_train.py and synthetic scene
batches:

1. ``--scan A B``: for scene batches A..B-1, whether the JAX package's jit
   and eager bf16 train forwards and the port's pick the same proposals,
   and the smallest distance of a proposal to the 0.3 / 0.6 objectness
   thresholds (and the labels that differ between JAX jit and the port).
2. ``--grads SEED``: on scene batch SEED, each parameter's gradient gap in
   relative L2: port vs JAX jit, JAX eager vs JAX jit, JAX jit vs the f32
   gradient; and how many parameters JAX eager vs jit and the port vs JAX
   jit keep inside the bulk band of tests/test_stgcn_train.py:270-283.

Run from the repository root, e.g.
``JAX_PLATFORMS=cpu python scripts/torch_bf16_train_vs_jax.py --grads 4``
(the eager JAX step takes about a minute).
"""

import argparse
import os
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from pose2room_tpu.models.loss import detection_loss  # noqa: E402
from pose2room_tpu_torch.convert import state_dict_from_flax  # noqa: E402
from pose2room_tpu_torch.train import state  # noqa: E402
from pose2room_tpu_torch.train.step import GT_KEYS, batch_to_device, train_step  # noqa: E402
from torch_port_util import SMALL, flax_payload, jax_model, mdn_eps_from_jax, port_model, scene_batch  # noqa: E402

KEY = jax.random.PRNGKey(11)


def setup():
    """The weights of tests/test_torch_bf16_train.py's step fixture."""
    payload = flax_payload(SMALL["num_gaussian"], seed=5)
    vote_head = payload["params"]["centervoting"]["conv_input"]["dense2"]
    vote_head["kernel"] = vote_head["kernel"] * np.float32(0.1)
    return payload, {"params": payload["params"], "batch_stats": payload["batch_stats"]}


def gt_distances(agg, batch):
    """Each proposal's distance to its nearest valid GT center."""
    gt, mask = batch["center_label"][:, :, :3], batch["box_label_mask"]
    d2 = ((agg[:, :, None] - gt[:, None]) ** 2).sum(-1) + (1 - mask)[:, None] * 1e9
    return np.sqrt(d2.min(2) + 1e-6)


def scan(first, last):
    payload, variables = setup()
    model = jax_model(SMALL, compute_dtype="bfloat16")
    port = port_model(SMALL, payload, compute_dtype="bfloat16").train()

    def fwd(v, x):
        return model.apply(v, x, train=True, rngs={"mdn": KEY}, mutable=["batch_stats"])[0]

    jit_fwd = jax.jit(fwd)
    for seed in range(first, last):
        batch = scene_batch(seed, 2, SMALL["num_frames"])
        x = jnp.asarray(batch["input_joints"])
        a = jit_fwd(variables, x)
        with jax.disable_jit():
            b = fwd(variables, x)
        eps = {k: torch.from_numpy(v.copy()) for k, v in mdn_eps_from_jax(model, variables, x, KEY).items()}
        with torch.no_grad():
            c = port(torch.from_numpy(batch["input_joints"]), eps=eps)
        ia, ib = np.asarray(a["aggregated_vote_inds"]), np.asarray(b["aggregated_vote_inds"])
        ic = c["aggregated_vote_inds"].numpy()
        dj = gt_distances(np.asarray(a["aggregated_vote_xyz"], np.float64), batch)
        dp = gt_distances(c["aggregated_vote_xyz"].numpy().astype(np.float64), batch)
        near = np.minimum(np.abs(dj - 0.3), np.abs(dj - 0.6)).min()
        flips = ((dj < 0.3) != (dp < 0.3)) | ((dj > 0.6) != (dp > 0.6))
        vote_gap = np.abs(np.asarray(a["vote_xyz"], np.float32) - c["vote_xyz"].numpy()).max()
        eager_gap = np.abs(np.asarray(a["vote_xyz"], np.float32) - np.asarray(b["vote_xyz"], np.float32)).max()
        print(f"batch {seed}: proposals jit==eager {bool((ia == ib).all())}, port==jit {bool((ic == ia).all())} "
              f"(per clip differing {(ic != ia).sum(1).tolist()}), port==eager {bool((ic == ib).all())}; "
              f"votes port-jit {vote_gap:.4f}, eager-jit {eager_gap:.4f}; nearest distance to a threshold "
              f"{near:.6f}; labels that differ {int(flips.sum())} (JAX {dj[flips].tolist()}, port "
              f"{dp[flips].tolist()})", flush=True)


def relative_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def in_bulk_band(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b) / max(np.abs(b).max(), 1e-3)
    return np.median(err) < 3e-2 and np.mean(err > 7e-2) < 0.02 and err.max() < 0.5


def grads(seed):
    payload, variables = setup()
    model = jax_model(SMALL, compute_dtype="bfloat16")
    np_batch = scene_batch(seed, 2, SMALL["num_frames"])
    batch = {k: jnp.asarray(v) for k, v in np_batch.items()}

    def loss_fn(p):
        out, _ = model.apply({"params": p, "batch_stats": variables["batch_stats"]}, batch["input_joints"],
                             train=True, rngs={"mdn": KEY}, mutable=["batch_stats"])
        return detection_loss(out, {k: batch[k] for k in GT_KEYS})["total"]

    def as_state_dict(g):
        to_np = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), g)
        return state_dict_from_flax({"params": to_np, "batch_stats": variables["batch_stats"]})

    jit_sd = as_state_dict(jax.jit(jax.grad(loss_fn))(variables["params"]))
    with jax.disable_jit():
        eager_sd = as_state_dict(jax.grad(loss_fn)(variables["params"]))
    eps = {k: torch.from_numpy(v.copy())
           for k, v in mdn_eps_from_jax(model, variables, batch["input_joints"], KEY).items()}
    port = {}
    for dtype in ("bfloat16", "float32"):
        m = port_model(SMALL, payload, compute_dtype=dtype)
        optimizer, _, _ = state.make_optimizer(m, {"lr": 1e-3})
        train_step(m, optimizer, batch_to_device(np_batch, "cpu"), eps=eps)
        port[dtype] = {k: p.grad.numpy() for k, p in m.named_parameters()}
    names = [k for k in port["bfloat16"] if not k.endswith("tcn.2.bias")]
    print(f"scene batch {seed}, relative L2 gaps: port vs JAX jit | JAX eager vs jit | JAX jit vs f32 (port)")
    rows = []
    for k in names:
        j = jit_sd[k].numpy()
        rows.append((relative_l2(port["bfloat16"][k], j), relative_l2(eager_sd[k].numpy(), j),
                     relative_l2(j, port["float32"][k])))
        print(f"  {k:55s} {rows[-1][0]:.3e} {rows[-1][1]:.3e} {rows[-1][2]:.3e}")
    backbone = [r for k, r in zip(names, rows) if k.startswith("backbone")]
    print(f"backbone: port vs jit {min(r[0] for r in backbone):.3f}-{max(r[0] for r in backbone):.3f}, "
          f"eager vs jit {min(r[1] for r in backbone):.3f}-{max(r[1] for r in backbone):.3f}; "
          f"largest (port vs jit) / (eager vs jit) {max(r[0] / max(r[1], 1e-12) for r in rows):.3f}")
    eager_in = sum(in_bulk_band(eager_sd[k].numpy(), jit_sd[k].numpy()) for k in names)
    port_in = sum(in_bulk_band(port["bfloat16"][k], jit_sd[k].numpy()) for k in names)
    print(f"inside the bulk band: JAX eager vs jit {eager_in} of {len(names)} parameters, "
          f"port vs JAX jit {port_in} of {len(names)}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scan", nargs=2, type=int, metavar=("FIRST", "LAST"))
    parser.add_argument("--grads", type=int, metavar="SEED")
    args = parser.parse_args()
    if args.scan:
        scan(*args.scan)
    if args.grads is not None:
        grads(args.grads)


if __name__ == "__main__":
    main()
