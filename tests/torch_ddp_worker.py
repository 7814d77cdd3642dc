"""Ranks of the port's data-parallel CPU tests (tests/test_torch_ddp.py,
tests/test_torch_test_runner.py).

``Ranks(nprocs, inputs, tmpdir, device)`` starts ``nprocs`` processes
(torch.multiprocessing, spawn) and returns at once.  Each sets the
environment torchrun would give it, joins a group through
``parallel.init_distributed(device)`` (gloo on the CPU; on one card NCCL
for one rank, gloo for several), runs each scenario ``name`` of
``inputs`` ({name: its inputs}) in turn from its own working directory
``<tmpdir>/rank<r>``, and saves {name: result} to ``<tmpdir>/rank<r>.pt``;
``Ranks.results()`` waits for them and returns those dicts in rank order.
The ranks import the port only (no JAX), and a rank that fails, or ranks
that outlast ``timeout`` seconds, fail ``results()``.
"""

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


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, nprocs, port, inputs, tmpdir, device):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(nprocs), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(4)
    workdir = os.path.join(tmpdir, f"rank{rank}")
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)  # the train runner's board writes to ./runs
    init_distributed(device)
    try:
        out = {name: SCENARIOS[name](args) for name, args in inputs.items()}
        torch.save(out, os.path.join(tmpdir, f"rank{rank}.pt"))
    finally:
        shutdown()


class Ranks:
    def __init__(self, nprocs, inputs, tmpdir, device="cpu", timeout=600):
        self.nprocs, self.tmpdir = nprocs, str(tmpdir)
        os.makedirs(self.tmpdir, exist_ok=True)
        self._deadline = time.monotonic() + timeout
        self._context = mp.start_processes(_rank_main, args=(nprocs, free_port(), inputs, self.tmpdir, device),
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
        return {"history": history, "save_path": cfg.save_path, "state": model.state_dict(),
                "cwd": sorted(os.listdir("."))}
    finally:
        cfg.close()


def test_run(inputs):
    """The test runner on in-memory scenes: metrics, merged mean losses and
    the run dir."""
    from pose2room_tpu_torch.config.loader import CONFIG
    from pose2room_tpu_torch.data.dataset import SceneDataset
    from pose2room_tpu_torch.runners import test as test_runner

    cfg = CONFIG(inputs["config"], mode="test")
    try:
        dataset = SceneDataset(inputs["scenes"], num_frames=inputs["num_frames"], augment=False)
        metrics = test_runner.run(cfg, device="cpu", dataset=dataset)
        return {"metrics": metrics, "mean_losses": cfg.test_summary["mean_losses"],
                "save_path": cfg.save_path}
    finally:
        cfg.close()


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


SCENARIOS = {"train_steps": train_steps, "card_steps": card_steps, "train_run": train_run, "train_run_lr": train_run,
             "test_run": test_run, "ap_merge": ap_merge}

