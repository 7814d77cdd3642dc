"""Goldens that several port test files compare against, computed once a run.

The data- and tensor-parallel files (tests/test_torch_ddp.py,
tests/test_torch_ddp_bf16.py, tests/test_torch_tp.py,
tests/test_torch_tp_bf16.py) hold their ranks against the same references
on the same inputs: the perturbed flax init ``payload`` (seed 5, SMALL),
the global batch ``step_batch()`` (scene batch 44, 4 clips) and the MDN rng
``step_key()`` (PRNGKey 11).  ``Goldens`` computes each of these once:

* ``payload``: the flax init (jitted) with its vote head scaled down;
* ``eps``: the noise of the JAX model's three MDN heads under the key;
* ``jax_step``: JAX's single-device f32 step (losses, gradients);
* ``jax_tp_step``: JAX's f32 step under ``shard_params`` at model 2;
* ``jax_bf16(kind, fused)``: JAX's bf16 step on one device ("single"), with
  the batch on a 2-device data axis ("sharded") or under ``shard_params``
  at model 2 ("tp"), on either train path;
* ``single_steps(fused)``: the port's one process on the whole batch in
  float64, two AdamW steps (at the test process's thread count);
* ``bf16_one_process(fused, order)``: the port's bf16 steps in one process
  at ``BF16_RANK_THREADS`` (losses, gradients, states, picks).

and, for the other files:

* ``flax_payload(num_gaussian, seed, vote_factor)``: the JAX package's
  eager flax init of ``torch_port_util.flax_payload`` (seed 3 at SMALL is
  the weights of seven files);
* ``jax_generate_small(sparse_eval)``: JAX's eager SMALL ``generate`` on
  the seed-3 weights and the seed-0 walking clips
  (tests/test_torch_model.py, tests/test_torch_sparse.py,
  tests/test_torch_tconv_3xtf32.py, tests/test_torch_bwd_sparse_3xtf32.py);
* JAX's fused train layer on ``torch_kernel_cases``' operands:
  ``jax_layer`` (f32; tests/test_torch_train_layer.py,
  tests/test_torch_bwd_sparse_3xtf32.py) and ``jax_layer_bf16``
  (tests/test_torch_bf16_train.py, tests/test_torch_train_bf16_redesign.py),
  each also a module fixture of that name.

Where they are kept.  Under pytest-xdist every worker's base temp is
``pytest-<N>/popen-gw<k>``; its parent ``pytest-<N>`` is made anew for
each run and shared by that run's workers alone.  A golden is computed by
the first worker that asks for it, under an ``fcntl.flock`` of its own lock
file in ``pytest-<N>/torch_golden/`` (the pattern pytest-xdist documents
for session fixtures that execute once), and saved there with
``torch.save``; a worker that asks later waits on the lock and reads the
file.  No file outlives its run's directory, so a stale golden cannot be
read.  Without xdist (``worker_id == "master"``) the parent is
``pytest-of-<user>``, which outlives the run: there a golden is computed in
the process, kept in memory for the session, and nothing is written.
``golden.log`` in that directory says who computed each golden, in how
many seconds, and who read it.
"""

import copy
import fcntl
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose2room_tpu.models import P2RNet as JaxP2RNet
from pose2room_tpu.models.loss import detection_loss as jax_detection_loss
from pose2room_tpu.ops import stgcn_train as jax_train
from pose2room_tpu.parallel import make_mesh, replicate, shard_batch, shard_params
from pose2room_tpu_torch.convert import state_dict_from_flax
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
from pose2room_tpu_torch.train.state import make_optimizer
from pose2room_tpu_torch.train.step import GT_KEYS, batch_to_device, train_step
from torch_ddp_worker import BF16_RANK_THREADS, bf16_steps
from torch_kernel_cases import B, C, T, V, Wp, bf16_layer_args, bf16_round, layer_args
from torch_port_util import SMALL, _perturb, flax_payload, jax_model, mdn_eps_from_jax, scene_batch, walking_clip

OPTIMIZER = {"lr": 1e-3, "weight_decay": 0.01, "clip_norm": 0.5}


def step_batch():
    """The global batch of the parallel steps: 4 clips, two ranks of 2.  On
    it JAX's f32 gradient is within 1.6e-5 of max|g| of the port's float64
    one (the f32 gradients of both packages are ill-conditioned on most
    batches, ROADMAP §3)."""
    return scene_batch(44, 4, SMALL["num_frames"])


def step_key():
    return jax.random.PRNGKey(11)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def shared(name, compute, cache_dir=None, who="master", memo=None):
    """``compute()`` once a run: once across the processes sharing
    ``cache_dir`` (the first computes and saves it under a lock, the others
    read it), or, without one, once in this process, kept in ``memo`` (each
    request given its own copy, as a read from disk would be)."""
    if cache_dir is None:
        if name not in memo:
            memo[name] = compute()
        return copy.deepcopy(memo[name])
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{name}.pt")
    with open(os.path.join(cache_dir, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        t0 = time.perf_counter()
        if os.path.exists(path):
            value, verb = torch.load(path, weights_only=False), "read"
        else:
            value, verb = compute(), "computed"
            torch.save(value, path + ".tmp")
            os.replace(path + ".tmp", path)
        with open(os.path.join(cache_dir, "golden.log"), "a") as log:
            log.write(f"{name} {verb} by {who} in {time.perf_counter() - t0:.1f} s\n")
    return value


class Goldens:
    """The goldens of this run (see the module's docstring)."""

    def __init__(self, cache_dir=None, who="master", memo=None):
        self.cache_dir, self.who, self.memo = cache_dir, who, memo

    def _get(self, name, compute):
        return shared(name, compute, self.cache_dir, self.who, self.memo)

    def payload(self):
        return self._get("payload", lambda: flax_payload_small(5))

    def eps(self):
        return self._get("eps", lambda: mdn_eps_from_jax(jax_model(SMALL), self.payload(),
                                                         jnp.asarray(step_batch()["input_joints"]), step_key()))

    def jax_step(self):
        return self._get("jax_step", lambda: jax_step(self.payload(), step_batch(), step_key()))

    def jax_tp_step(self):
        return self._get("jax_tp_step", lambda: jax_tp_step(self.payload(), step_batch(), step_key()))

    def jax_bf16(self, kind, fused):
        def compute():
            mesh = {"single": None, "sharded": make_mesh(jax.devices()[:2]),
                    "tp": make_mesh(model_parallel=2)}[kind]
            return jax_bf16_step(self.payload(), step_batch(), step_key(), fused, mesh, tp=kind == "tp")
        return self._get(f"jax_bf16_{kind}_{'fused' if fused else 'module'}", compute)

    def step_inputs(self):
        """The inputs of the ranks' steps (``torch_ddp_worker.train_steps``,
        ``tp_steps``, ``bf16_steps``)."""
        return {"sizes": SMALL, "state_dict": state_dict_from_flax(self.payload()), "batch": step_batch(),
                "eps": self.eps(), "optimizer": OPTIMIZER}

    def single_steps(self, fused):
        return self._get(f"single_steps_{'fused' if fused else 'module'}",
                         lambda: single_steps(self.step_inputs(), fused))

    def bf16_one_process(self, fused, order=None):
        def compute():
            res = bf16_one_process(dict(self.step_inputs(), paths=[fused]), fused, order=order)
            return {k: res[k] for k in ("losses", "grads", "state", "picks")}
        suffix = "" if order is None else "_" + "".join(map(str, order))
        return self._get(f"bf16_one_{'fused' if fused else 'module'}{suffix}", compute)

    def flax_payload(self, num_gaussian, seed=0, vote_factor=1):
        return self._get(f"flax_payload_{num_gaussian}_{seed}_{vote_factor}",
                         lambda: flax_payload(num_gaussian, seed=seed, vote_factor=vote_factor))

    def jax_generate_small(self, sparse_eval):
        """JAX's ``generate`` (eager) at the SMALL sizes on
        ``flax_payload(10, seed=3)`` and the walking clips of seed 0 (B=2),
        dense or ``sparse_eval``, as numpy."""
        def compute():
            payload = self.flax_payload(SMALL["num_gaussian"], seed=3)
            jvars = {"params": payload["params"], "batch_stats": payload["batch_stats"]}
            x = walking_clip(np.random.RandomState(0), 2, SMALL["num_frames"])
            return jax.tree_util.tree_map(
                np.asarray, jax_model(SMALL, sparse_eval=sparse_eval).apply(jvars, x, method=JaxP2RNet.generate))
        return self._get(f"jax_generate_small_{'sparse' if sparse_eval else 'dense'}", compute)

    def jax_layer(self):
        return self._get("jax_layer", jax_train_layer)

    def jax_layer_bf16(self):
        return self._get("jax_layer_bf16", jax_train_layer_bf16)


_MEMO = pytest.StashKey[dict]()


@pytest.fixture(scope="session")
def goldens(request, tmp_path_factory, worker_id):
    """This run's goldens: under xdist in the run's ``pytest-<N>/torch_golden``,
    without it in the session's memory (``request.config``, one for every
    module that imports this fixture)."""
    if worker_id == "master":
        return Goldens(memo=request.config.stash.setdefault(_MEMO, {}))
    return Goldens(str(tmp_path_factory.getbasetemp().parent / "torch_golden"), worker_id)


@pytest.fixture(scope="module")
def jax_layer(goldens):
    return goldens.jax_layer()


@pytest.fixture(scope="module")
def jax_layer_bf16(goldens):
    return goldens.jax_layer_bf16()


# ---------------------------------------------------------------------------
# what they compute
# ---------------------------------------------------------------------------

def flax_payload_small(seed):
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


def jax_step(payload, batch, key):
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


def jax_tp_step(payload, batch, key, tp=2):
    """JAX's f32 step on a global batch with ``shard_params`` on
    ``make_mesh(model_parallel=tp)`` and the batch on its data axis: losses
    and gradients, the gradients as a state_dict."""
    model = jax_model(SMALL)
    mesh = make_mesh(model_parallel=tp)
    params = shard_params(payload["params"], mesh)
    stats = shard_params(payload["batch_stats"], mesh)
    jbatch = shard_batch(batch, mesh)

    @jax.jit
    def loss_and_grad(params, jbatch):
        def loss_fn(p):
            out, _ = model.apply({"params": p, "batch_stats": stats}, jbatch["input_joints"], train=True,
                                 rngs={"mdn": key}, mutable=["batch_stats"])
            losses = jax_detection_loss(out, {k: jbatch[k] for k in GT_KEYS})
            return losses["total"], losses

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, losses), grads = loss_and_grad(params, jbatch)
    grads = jax.tree_util.tree_map(np.asarray, grads)
    return {k: float(v) for k, v in losses.items()}, state_dict_from_flax(
        {"params": grads, "batch_stats": payload["batch_stats"]})


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


def single_steps(inputs, fused):
    """The port's single process on the whole batch, float64: the ranks' two
    steps; (losses, final state)."""
    model = P2RNet(P2RNetConfig(**SMALL, fused_train=fused), device="cpu")
    model.load_state_dict(inputs["state_dict"])
    model.double()
    optimizer, _, clip_norm = make_optimizer(model, inputs["optimizer"])
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch_to_device(inputs["batch"], "cpu").items()}
    eps = {k: torch.from_numpy(v.copy()).double() for k, v in inputs["eps"].items()}
    losses = [{k: float(v) for k, v in train_step(model, optimizer, batch, eps=eps, clip_norm=clip_norm)[0].items()}
              for _ in range(2)]
    return losses, model.state_dict()


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


def jax_train_layer():
    """make_train_layer (f32, custom VJP, plain branch on the CPU): outputs
    and gradients of sum(out * w) for both residual settings, on
    ``layer_args(10 + residual, residual)``."""
    results = {}
    for residual in (False, True):
        args = [jnp.asarray(a) for a in layer_args(10 + residual, residual)]
        w = jnp.asarray(np.random.RandomState(20).randn(B, T, Wp).astype(np.float32))
        layer = jax_train.make_train_layer(residual, V, C, T, dtype="float32")
        outs = layer(*args)

        def loss(*a):
            return jnp.sum(layer(*a)[0] * w)

        grads = jax.grad(loss, argnums=tuple(range(9)))(*args)
        results[residual] = ([np.asarray(o) for o in outs], [np.asarray(g) for g in grads], np.array(w))
    return results


def jax_train_layer_bf16():
    """make_train_layer(dtype=bfloat16) (custom VJP, plain branch on the
    CPU): outputs and the gradients of sum(out * w) for both residual
    settings, on ``bf16_layer_args(10 + residual, residual)``."""
    results = {}
    for residual in (False, True):
        args = bf16_layer_args(10 + residual, residual)
        jargs = [jnp.asarray(a, jnp.bfloat16 if i < 2 else jnp.float32) for i, a in enumerate(args)]
        w = bf16_round(np.random.RandomState(20).randn(B, T, Wp))
        layer = jax_train.make_train_layer(residual, V, C, T, dtype="bfloat16")
        outs = layer(*jargs)

        def loss(*a):
            return jnp.sum(layer(*a)[0].astype(jnp.float32) * w)

        grads = jax.grad(loss, argnums=tuple(range(9)))(*jargs)
        results[residual] = (args, [np.asarray(o, np.float32) for o in outs],
                             [np.asarray(g, np.float32) for g in grads], w)
    return results
