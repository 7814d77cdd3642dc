"""Ranks of the port's data- and tensor-parallel CPU tests
(tests/test_torch_ddp.py, tests/test_torch_tp.py,
tests/test_torch_test_runner.py).

``Ranks(nprocs, inputs, tmpdir, device, threads=)`` starts ``nprocs`` processes
(torch.multiprocessing, spawn) and returns at once.  Each sets the
environment torchrun would give it, joins a group through
``parallel.init_distributed(device)`` (gloo on the CPU; on one card NCCL
for one rank, gloo for several), runs each scenario ``name`` of
``inputs`` ({name: its inputs}) in turn from its own working directory
``<tmpdir>/rank<r>``, and saves {name: result} (and "seconds": {name: its
wall seconds}) to ``<tmpdir>/rank<r>.pt``;
``Ranks.results()`` waits for them and returns those dicts in rank order.
The ranks import the port only (no JAX), and a rank that fails, or ranks
that outlast ``timeout`` seconds, fail ``results()``.
"""

import contextlib
import os
import socket
import time

import torch
import torch.multiprocessing as mp

from pose2room_tpu_torch.parallel import (
    allgather_object,
    init_distributed,
    process_count,
    process_index,
    shutdown,
    wrap_model,
)


# each rank's torch threads: one, so that ranks on a loaded host do not wait
# at OpenMP barriers; the bf16 sessions' two, the count their seeded cases
# are held at (a bf16 rounding, and so an FPS pick, follows the CPU's
# matmuls, which round by their thread count; at one thread the half-width
# GEMMs of the column-parallel layers round otherwise than one process's
# whole one).  A one-process run compared with ranks runs at their count.
RANK_THREADS = 1
BF16_RANK_THREADS = 2


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, nprocs, port, inputs, tmpdir, device, threads):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(nprocs), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(threads)
    workdir = os.path.join(tmpdir, f"rank{rank}")
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)  # the train runner's board writes to ./runs
    init_distributed(device)
    try:
        out, seconds = {}, {}
        for name, args in inputs.items():
            t0 = time.perf_counter()
            out[name] = SCENARIOS[name](args)
            seconds[name] = time.perf_counter() - t0
        torch.save(dict(out, seconds=seconds), os.path.join(tmpdir, f"rank{rank}.pt"))
    finally:
        shutdown()


class Ranks:
    def __init__(self, nprocs, inputs, tmpdir, device="cpu", timeout=600, threads=RANK_THREADS):
        self.nprocs, self.tmpdir = nprocs, str(tmpdir)
        os.makedirs(self.tmpdir, exist_ok=True)
        self._deadline = time.monotonic() + timeout
        self._context = mp.start_processes(_rank_main, args=(nprocs, free_port(), inputs, self.tmpdir, device, threads),
                                           nprocs=nprocs, join=False, start_method="spawn")
        self._results = None

    def results(self):
        if self._results is None:
            try:
                while not self._context.join(timeout=1):
                    if time.monotonic() > self._deadline:
                        raise TimeoutError(f"{self.nprocs} ranks did not finish in time")
            finally:
                self.close()
            self._results = [torch.load(os.path.join(self.tmpdir, f"rank{r}.pt"), weights_only=False)
                             for r in range(self.nprocs)]
        return self._results

    def close(self):
        for p in self._context.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


# ---------------------------------------------------------------------------
# scenarios: fn(inputs) -> a picklable result, run on every rank
# ---------------------------------------------------------------------------

def train_steps(inputs):
    """Two train steps through DDP on this rank's rows of the global batch
    and noise, in float64, on the fused train chain and on the module path:
    each step's (global) losses, the first step's gradients (reduced, before
    clipping) and the state after both steps, by ``fused``."""
    from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
    from pose2room_tpu_torch.train.state import make_optimizer
    from pose2room_tpu_torch.train.step import batch_to_device, train_step

    rank, n = process_index(), process_count()
    batch = {k: v.double() if v.is_floating_point() else v for k, v in
             batch_to_device({k: v[rank::n] for k, v in inputs["batch"].items()}, "cpu").items()}
    eps = {k: torch.from_numpy(v[rank::n].copy()).double() for k, v in inputs["eps"].items()}
    out = {}
    for fused in (True, False):
        model = P2RNet(P2RNetConfig(**inputs["sizes"], fused_train=fused), device="cpu")
        model.load_state_dict(inputs["state_dict"])
        model.double()
        optimizer, _, clip_norm = make_optimizer(model, inputs["optimizer"])
        ddp = wrap_model(model)
        losses, grads = [], None
        for _ in range(2):
            step_losses, _ = train_step(ddp, optimizer, batch, eps=eps, clip_norm=clip_norm, shard=(rank, n))
            losses.append({k: float(v) for k, v in step_losses.items()})
            if grads is None:
                # clipped in place by g / norm * clip_norm: undo it
                scale = max(losses[0]["grad_norm"] / clip_norm, 1.0)
                grads = {k: p.grad * scale for k, p in model.named_parameters()}
        out[fused] = {"losses": losses, "grads": grads, "state": model.state_dict()}
    return out


def card_steps(inputs):
    """Two float32 train steps on the card through DDP, with deterministic
    algorithms, on this rank's rows of the global batch and noise: each
    step's losses, the first step's gradients, the state after each step and
    the kernels' launches."""
    from pose2room_tpu_torch import kernels
    from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
    from pose2room_tpu_torch.train.state import make_optimizer
    from pose2room_tpu_torch.train.step import batch_to_device, train_step

    torch.use_deterministic_algorithms(True, warn_only=True)
    rank, n = process_index(), process_count()
    model = P2RNet(P2RNetConfig(**inputs["sizes"]))
    model.load_state_dict(inputs["state_dict"])
    optimizer, _, clip_norm = make_optimizer(model, inputs["optimizer"])
    ddp = wrap_model(model)
    batch = batch_to_device({k: v[rank::n] for k, v in inputs["batch"].items()}, model.device)
    eps = {k: torch.from_numpy(v[rank::n].copy()).to(model.device) for k, v in inputs["eps"].items()}
    out = {"losses": [], "state": [], "card": torch.cuda.current_device()}
    kernels.reset_launch_counts()
    for i in range(2):
        losses, _ = train_step(ddp, optimizer, batch, eps=eps, clip_norm=clip_norm)
        out["losses"].append({k: float(v) for k, v in losses.items()})
        if i == 0:
            out["grads"] = {k: p.grad.cpu() for k, p in model.named_parameters()}
        out["state"].append({k: v.cpu() for k, v in model.state_dict().items()})
    torch.cuda.synchronize()
    out["launches"] = dict(kernels.LAUNCHES)
    return out


def train_run(inputs):
    """The train runner on in-memory scenes: its history, the run dir it
    used, the final state and what this rank's working directory holds."""
    from pose2room_tpu_torch.config.loader import CONFIG
    from pose2room_tpu_torch.data.dataset import SceneDataset
    from pose2room_tpu_torch.runners import train as train_runner

    cfg = CONFIG(inputs["config"], mode="train")
    try:
        datasets = {k: SceneDataset(v, num_frames=inputs["num_frames"], augment=False)
                    for k, v in inputs["scenes"].items()}
        model, history = train_runner.run(cfg, device="cpu", datasets=datasets)
        out = {"history": history, "save_path": cfg.save_path, "state": model.state_dict(),
               "cwd": sorted(os.listdir("."))}
        return dict(out, model=model) if inputs.get("keep_model") else out
    finally:
        cfg.close()


def test_run(inputs):
    """The test runner on in-memory scenes: metrics, merged mean losses, the
    run dir and the multi-mode draws (run salt, sample count)."""
    from pose2room_tpu_torch.config.loader import CONFIG
    from pose2room_tpu_torch.data.dataset import SceneDataset
    from pose2room_tpu_torch.runners import test as test_runner

    cfg = CONFIG(inputs["config"], mode="test")
    try:
        dataset = SceneDataset(inputs["scenes"], num_frames=inputs["num_frames"], augment=False)
        metrics = test_runner.run(cfg, device="cpu", dataset=dataset)
        return {"metrics": metrics, "mean_losses": cfg.test_summary["mean_losses"],
                "save_path": cfg.save_path, "n_samples": cfg.test_summary["n_samples"],
                "salt": cfg.config["test"].get("drawn_run_salt")}
    finally:
        cfg.close()


def test_runs(inputs):
    """``test_run`` once for each config of ``inputs["configs"]`` on the same
    scenes, each batch's multi-mode noise recorded as this rank drew it
    (``runners.test.multi_mode_noise``): a list of ``test_run``'s results,
    each with its noise by batch."""
    from pose2room_tpu_torch.runners import test as test_runner

    draw = test_runner.multi_mode_noise
    out = []
    for config in inputs["configs"]:
        noise = []

        def recorded(*args):
            drawn = draw(*args)
            noise.append({k: tuple(t.cpu().clone() for t in v) for k, v in drawn.items()})
            return drawn

        test_runner.multi_mode_noise = recorded
        try:
            out.append(dict(test_run(dict(inputs, config=config)), noise=noise))
        finally:
            test_runner.multi_mode_noise = draw
    return out


def ap_merge(inputs):
    """This rank's scans in an APCalculator and its losses in a LossRecorder,
    merged across the group: the merged metrics, scan count and means."""
    from pose2room_tpu_torch.eval.ap import APCalculator
    from pose2room_tpu_torch.utils.logger import LossRecorder

    preds, gts = inputs["scans"][process_index()]
    calc = APCalculator(0.25, inputs["class2type"])
    calc.step(preds, gts)
    calc.synchronize_between_processes()
    recorder = LossRecorder(batch_size=2)
    for losses in inputs["losses"][process_index()]:
        recorder.update_loss(losses)
    recorder.synchronize_between_processes()
    return {"metrics": calc.compute_metrics(), "scan_cnt": calc.scan_cnt, "means": recorder.means(),
            "ranks": allgather_object(process_index())}


def tp_steps(inputs):
    """Two train steps under a (data, model) grid of degree ``inputs["tp"]``
    on this model group's rows of the global batch and noise (its ranks'
    strided rows in rank order), on the card with deterministic algorithms
    (``inputs["device"]`` "cuda") or on the CPU in float64, for each train
    path of ``inputs["paths"]`` (True: the fused chain): each step's
    losses, the first step's gradients (reduced and gathered, before
    clipping), the gathered state after each step, the shapes this rank
    holds of each parameter and AdamW moment, its replicated tensors, its
    bytes of parameters and moments, and the kernels' launches."""
    from pose2room_tpu_torch import kernels
    from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
    from pose2room_tpu_torch.parallel import batch_shard, make_grid
    from pose2room_tpu_torch.parallel.tensor import (
        full_state_dict,
        gather_state_dict,
        shard_module_,
        sharded_keys,
        state_bytes,
    )
    from pose2room_tpu_torch.train.state import make_optimizer
    from pose2room_tpu_torch.train.step import batch_to_device, train_step

    grid = make_grid(inputs["tp"])
    device = inputs.get("device", "cpu")
    float64 = device == "cpu"
    if not float64:
        torch.use_deterministic_algorithms(True, warn_only=True)
    n = process_count()
    B = len(inputs["batch"]["input_joints"])
    rows = [i for r in grid.model_ranks for i in range(B)[r::n]]
    batch = batch_to_device({k: v[rows] for k, v in inputs["batch"].items()}, device)
    eps = {k: torch.from_numpy(v[rows].copy()).to(device) for k, v in inputs["eps"].items()}
    if float64:
        batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
        eps = {k: v.double() for k, v in eps.items()}
    out = {}
    try:
        for fused in inputs["paths"]:
            model = P2RNet(P2RNetConfig(**inputs["sizes"], fused_train=fused), device=device)
            model.load_state_dict(inputs["state_dict"])
            if float64:
                model.double()
            optimizer, _, clip_norm = make_optimizer(model, inputs["optimizer"])
            shard_module_(model, optimizer)
            res = {"losses": [], "state": []}
            kernels.reset_launch_counts()
            for i in range(2):
                step_losses, _ = train_step(wrap_model(model), optimizer, batch, eps=eps, clip_norm=clip_norm,
                                            shard=batch_shard())
                res["losses"].append({k: float(v) for k, v in step_losses.items()})
                if i == 0:
                    # clipped in place by g / norm * clip_norm: undo it
                    scale = max(res["losses"][0]["grad_norm"] / clip_norm, 1.0) if clip_norm > 0 else 1.0
                    grads = {k: p.grad * scale for k, p in model.named_parameters()}
                    res["grads"] = {k: v.cpu() for k, v in gather_state_dict(grads, sharded_keys(model)).items()}
                res["state"].append({k: v.detach().cpu().clone() for k, v in full_state_dict(model).items()})
            if not float64:
                torch.cuda.synchronize()
            res["launches"] = dict(kernels.LAUNCHES)
            res["shapes"] = {k: tuple(p.shape) for k, p in model.named_parameters()}
            res["moment_shapes"] = {k: tuple(optimizer.state[p]["exp_avg"].shape) for k, p in model.named_parameters()
                                    if p in optimizer.state}
            sharded = set(sharded_keys(model))
            res["replicated"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items() if k not in sharded}
            res["bytes"] = state_bytes(model, optimizer)
            out[fused] = res
    finally:
        make_grid(1)
        if not float64:
            torch.use_deterministic_algorithms(False)
    return out


class _Forced(torch.autograd.Function):
    """``value`` forward, the gradient of ``t`` passed through backward (a
    one-process all-reduce whose result is replaced)."""

    @staticmethod
    def forward(ctx, t, value):
        return value.to(t.device).clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@contextlib.contextmanager
def recorded_sums(log, one_process=False, forced=None):
    """Record what the train step reduces across the data group, in call
    order, as (kind, this rank's tensor, the reduced one): each fused
    block's packed sums ("chain", ``stgcn_train._global``: BN1's column
    sums, kernel 3's summed parts, the BN2 backward's channel sums, kernel
    4's summed parts), each module-path BatchNorm's (E[x], E[x^2]) ("bn",
    ``layers.all_reduce_sum``, after a ("rows", its row count) entry) and
    the gradient reaching each fused block's backward ("dout").
    ``one_process``: in a process of its own the same sites are recorded,
    with the local sums as the reduced ones, and so are the magnitudes of
    the terms ("terms": kernel 3's y, y2 and per-clip parts, kernel 4's
    per-clip parts).  ``forced``: then each site's result and each dout is
    replaced by the next of these (another run's reduced sums, divided as
    the layers divide them, and its douts in this run's row order), so that
    every site sums the terms that run summed."""
    from pose2room_tpu_torch.models import layers
    from pose2room_tpu_torch.ops import stgcn_train

    layer = stgcn_train.FusedTrainLayer
    saved = (stgcn_train._global, layers.all_reduce_sum, layers.in_group, layers.BatchNorm.forward,
             stgcn_train.tconv_stats_fwd, stgcn_train.tconv_bwd, layer.backward)
    forced = iter(forced) if forced is not None else None

    def host(t):
        return t.detach().cpu().clone()

    def chain(*vecs):
        out = saved[0](*vecs)
        log.append(("chain", host(torch.stack(vecs)), host(torch.stack(out))))
        return tuple(next(forced).to(vecs[0].device).unbind(0)) if forced is not None else out

    def bn(t):
        out = t if one_process else saved[1](t)
        log.append(("bn", host(t), host(out)))
        return _Forced.apply(t, next(forced)) if forced is not None else out

    def bn_forward(self, x):
        if self.training:
            log.append(("rows", x.numel() // x.shape[-1], None))
        return saved[3](self, x)

    def fwd(y, vecs, KB, *, T):
        y2, parts = saved[4](y, vecs, KB, T=T)
        if one_process:
            log.append(("terms", {"y": host(y), "y2": host(y2), "parts": host(parts)}, None))
        return y2, parts

    def bwd(dy2, y, vecs, KBT, *, T, C):
        dpre, parts, dtaps = saved[5](dy2, y, vecs, KBT, T=T, C=C)
        if one_process:
            log.append(("terms", {"parts": host(parts)}, None))
        return dpre, parts, dtaps

    def backward(ctx, dout, *stat_grads):
        if forced is not None:
            dout = next(forced).to(dout.device)
        log.append(("dout", host(dout), None))
        return saved[6](ctx, dout, *stat_grads)

    stgcn_train._global, layers.all_reduce_sum, layers.BatchNorm.forward = chain, bn, bn_forward
    stgcn_train.tconv_stats_fwd, stgcn_train.tconv_bwd, layer.backward = fwd, bwd, staticmethod(backward)
    if one_process:
        layers.in_group = lambda: True
    try:
        yield log
    finally:
        (stgcn_train._global, layers.all_reduce_sum, layers.in_group, layers.BatchNorm.forward,
         stgcn_train.tconv_stats_fwd, stgcn_train.tconv_bwd) = saved[:6]
        layer.backward = staticmethod(saved[6])


def bf16_steps(inputs, one_process=False, forced=None):
    """Two bf16 train steps (``compute_dtype: bfloat16``, f32 parameters)
    on this rank's rows of the global batch and noise, through DDP, or under
    a (data, model) grid of degree ``inputs["tp"]`` on the model group's
    rows, for each train path of ``inputs["paths"]`` (True: the fused
    chain): each step's losses, the first step's gradients (reduced and
    gathered, before clipping), its seed and proposal picks and its reduced
    sums (``recorded_sums``), the gathered state after each step, this
    rank's own tensors and AdamW moments, the sharded keys and the kernels'
    launches.  ``one_process``: the same steps in a process of its own on
    the whole batch (the reference), its rows in ``inputs["order"]`` when
    given."""
    from pose2room_tpu_torch import kernels
    from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
    from pose2room_tpu_torch.parallel import batch_shard, make_grid
    from pose2room_tpu_torch.parallel.tensor import full_state_dict, gather_state_dict, shard_module_, sharded_keys
    from pose2room_tpu_torch.train.state import make_optimizer
    from pose2room_tpu_torch.train.step import batch_to_device, train_step

    tp = inputs.get("tp", 1)
    grid = None if one_process else make_grid(tp)
    n = 1 if one_process else process_count()
    B = len(inputs["batch"]["input_joints"])
    ranks = grid.model_ranks if grid is not None else (0 if one_process else process_index(),)
    rows = inputs.get("order") or [i for r in ranks for i in range(B)[r::n]]
    batch = batch_to_device({k: v[rows] for k, v in inputs["batch"].items()}, "cpu")
    eps = {k: torch.from_numpy(v[rows].copy()) for k, v in inputs["eps"].items()}
    out = {}
    try:
        for fused in inputs["paths"]:
            model = P2RNet(P2RNetConfig(**inputs["sizes"], fused_train=fused, compute_dtype="bfloat16"), device="cpu")
            model.load_state_dict(inputs["state_dict"])
            optimizer, _, clip_norm = make_optimizer(model, inputs["optimizer"])
            if grid is not None:
                shard_module_(model, optimizer)
            net = model if one_process else wrap_model(model)
            shard = (0, 1) if one_process else batch_shard()
            res = {"losses": [], "state": [], "sums": []}
            kernels.reset_launch_counts()
            for i in range(2):
                with recorded_sums(res["sums"] if i == 0 else [], one_process,
                                   forced[fused] if forced is not None and i == 0 else None):
                    step_losses, end_points = train_step(net, optimizer, batch, eps=eps, clip_norm=clip_norm,
                                                         shard=shard)
                res["losses"].append({k: float(v) for k, v in step_losses.items()})
                if i == 0:
                    # clipped in place by g / norm * clip_norm: undo it
                    scale = max(res["losses"][0]["grad_norm"] / clip_norm, 1.0) if clip_norm > 0 else 1.0
                    grads = {k: p.grad * scale for k, p in model.named_parameters()}
                    res["grads"] = gather_state_dict(grads, sharded_keys(model))
                    res["picks"] = {k: end_points[k].clone() for k in ("seed_inds", "aggregated_vote_inds")}
                res["state"].append({k: v.detach().clone() for k, v in full_state_dict(model).items()})
            res["launches"] = dict(kernels.LAUNCHES)
            res["sharded"] = sharded_keys(model)
            res["own"] = {**{k: v.detach().clone() for k, v in model.state_dict().items()},
                          **{f"{k}/{m}": optimizer.state[p][m].clone() for k, p in model.named_parameters()
                             for m in ("exp_avg", "exp_avg_sq")}}
            out[fused] = res
    finally:
        if grid is not None:
            make_grid(1)
    return out


def tp_dense_grad(inputs):
    """A bf16 column-parallel dense layer at tp ``inputs["tp"]``
    (``models.layers.column_parallel_dense``) on a whole f32 input ``x``
    with this rank's block of ``w`` (out, in) and the whole bias: its output
    and the input's gradient under the output gradient ``dy``, and this
    rank's own f32 product for that gradient (before the group's sum and
    the rounding to bf16), by the same autograd op."""
    from pose2room_tpu_torch.models.layers import column_parallel_dense
    from pose2room_tpu_torch.parallel import make_grid

    grid = make_grid(inputs["tp"])
    try:
        block = inputs["w"].chunk(grid.tp, 0)[grid.model_index]
        x = inputs["x"].clone().requires_grad_(True)
        y = column_parallel_dense(x, block.t(), inputs["b"], torch.bfloat16)
        (y.float() * inputs["dy"]).sum().backward()
        xw = x.detach().to(torch.bfloat16).float().requires_grad_(True)
        own = torch.matmul(xw, block.t().to(torch.bfloat16).float()).to(torch.bfloat16)
        (own.float() * inputs["dy"].chunk(grid.tp, -1)[grid.model_index]).sum().backward()
        return {"y": y.detach(), "dx": x.grad, "own": xw.grad}
    finally:
        make_grid(1)


def quiet_board(**_):
    """A ``LogBoard`` that writes nothing: on this host the board's import
    of tensorboard loads TensorFlow (~17 s a process), and the tests that
    take it need no board."""
    from pose2room_tpu_torch.utils.logger import LogBoard

    return LogBoard(enabled=False)


def tp_train_run(inputs):
    """``train_run`` under the config's ``device.model_parallel``, with the
    gathered final state and the sharded keys (and no board)."""
    from pose2room_tpu_torch.parallel import make_grid
    from pose2room_tpu_torch.parallel.tensor import full_state_dict, sharded_keys
    from pose2room_tpu_torch.train import engine

    engine.LogBoard = quiet_board
    out = {}
    try:
        out = train_run(dict(inputs, keep_model=True))
        model = out.pop("model")
        out.update(full_state=full_state_dict(model), sharded=sharded_keys(model))
    finally:
        make_grid(1)
    return out


def demo_run(inputs):
    """The demo runner on ``inputs["demo_path"]``: its results and the number
    of dump writes this rank made."""
    from pose2room_tpu_torch.config.loader import CONFIG
    from pose2room_tpu_torch.parallel import make_grid
    from pose2room_tpu_torch.runners import demo

    writes = []

    def counted(fn):
        def wrapped(*args, **kwargs):
            writes.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    for name in ("dump_predictions", "write_ply_boxes", "write_ply_points"):
        setattr(demo, name, counted(getattr(demo, name)))
    cfg = CONFIG(inputs["config"], mode="demo")
    try:
        results = demo.run(cfg, device="cpu")
        return {"results": [(os.path.basename(p), n) for p, _, n, _ in results], "writes": writes,
                "vis_path": cfg.config["log"]["vis_path"]}
    finally:
        cfg.close()
        make_grid(1)


SCENARIOS = {"train_steps": train_steps, "card_steps": card_steps, "train_run": train_run, "train_run_lr": train_run,
             "test_run": test_run, "ap_merge": ap_merge, "tp_steps": tp_steps, "tp_train_run": tp_train_run,
             "tp_test_run": test_run, "demo_run": demo_run, "bf16_steps": bf16_steps,
             "tp_bf16_steps": bf16_steps, "bf16_train_run": tp_train_run, "tp_bf16_train_run": tp_train_run,
             "test_runs": test_runs, "tp_test_runs": test_runs,
             "tp_dense_grad": tp_dense_grad}

