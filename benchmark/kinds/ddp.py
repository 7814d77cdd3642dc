"""The ``ddp`` kind: the ``train`` kind's steps at ``world`` data-parallel
ranks, one process a card, ``batch`` a rank (the global batch is ``world``
times it).

Rank 0 is the harness's own process; ranks 1 .. world - 1 are this file run
as a script (``python benchmark/kinds/ddp.py --root ... --rank r``), each
on card ``r`` where there are ``world`` cards.  They meet at a localhost
rendezvous through the program's ``parallel.mesh.init_distributed`` (NCCL
where each rank has a card of its own, gloo where ranks share one), with
``NCCL_SHM_DISABLE=1`` and a timeout on the rendezvous and on every
collective, so that a fault fails the run and does not hang it.  Every rank
makes the same scenes and weights from the seed, wraps the program's
P2RNet in ``parallel.wrap_model`` (DDP with the summing hook) and reads its
shard of the program's ``DataLoader`` (``process_index`` / ``process_count``);
each step is ``train/step.py:train_step`` with the rank's rows of the
global batch's MDN noise (``shard``).

Every rank runs the same steps.  The first ``checked_steps`` are kept, and
their batches and outputs gathered to rank 0 once, before the window.
After that rank 0 posts, on a TCP store of its own (host only, no device
collective), how many steps the ranks are to have run: during the window
``AHEAD`` steps beyond its own, so the others never wait for the post, and
when its time is up it runs on to the posted count.  Items are world x
batch x the steps of rank 0's window.  Only rank 0 is traced; ``close``
posts the last count and leaves the group together with the other ranks
(NCCL's communicator destroy waits for every rank of the node), then joins
them, killing any that outlive ``JOIN_S``.  Should leaving the group itself
outlast ``JOIN_S``, rank 0 kills the ranks and exits with code 1.

``correct``: rank 0's first three steps against the plain reference trained
on the global batch of ``world`` x ``batch``: the ranks' shards
interleaved as the loader deals them (row j of the global batch is row
j // world of rank j % world), recomputed from the scenes with each
shard's augmentation seeds, and the noise drawn for the global batch, as
the program draws it (``harness/checks.py:train_numbers``).
"""

import argparse
import atexit
import datetime
import os
import socket
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.realpath(__file__))))
if __name__ == "__main__" and REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from benchmark.harness import checks, scenes  # noqa: E402
from benchmark.harness.cells import program_model, span, streams, sync  # noqa: E402
from benchmark.harness.weights import make_weights  # noqa: E402
from pose2room_tpu_torch.data.dataset import SceneDataset  # noqa: E402
from pose2room_tpu_torch.data.loader import DataLoader  # noqa: E402
from pose2room_tpu_torch.parallel import mesh  # noqa: E402
from pose2room_tpu_torch.parallel.collectives import batch_shard  # noqa: E402
from pose2room_tpu_torch.train import state as port_state  # noqa: E402
from pose2room_tpu_torch.train import step as port_step  # noqa: E402

GT_KEYS = ("input_joints",) + port_step.GT_KEYS
TIMEOUT = datetime.timedelta(seconds=300)  # the rendezvous, each collective, the store
JOIN_S = 120
AHEAD = 2  # steps rank 0 posts beyond its own in the window
TARGET = "steps"  # the store's key: the steps to have run; negative: then leave
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank, world, port):
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "NCCL_SHM_DISABLE": "1"}


def join(device):
    """Join the group of the environment; the rank's device."""
    mesh.init_distributed("cpu" if device.type == "cpu" else None, timeout=TIMEOUT)
    return device if device.type == "cpu" else torch.device("cuda", torch.cuda.current_device())


class Rank:
    """One rank's state and steps."""

    def __init__(self, cell, seed, device):
        t, self.model_cfg, self.device = cell.traffic, cell.config["model"], device
        self.optim_cfg = cell.config["optimizer"]
        st = streams(seed)
        self.batch, self.world, self.traffic = t["batch"], t["world"], t
        self.scenes = scenes.make_scenes(np.random.RandomState(st["scenes"]), t["scenes"], t["objects"],
                                         t["frames"])
        leaf_shapes, mu = checks.shapes(self.model_cfg)
        self.weights0 = make_weights(leaf_shapes, mu, st["weights"], device)
        self.model = program_model(self.model_cfg, self.weights0, device)
        self.net = mesh.wrap_model(self.model)
        self.optimizer, _, self.clip = port_state.make_optimizer(self.model, self.optim_cfg)
        reps = -(-t["epoch_items"] // len(self.scenes))
        dataset = SceneDataset(self.scenes * reps, num_frames=self.model_cfg["num_frames"], augment=True)
        self.loader_seed = st["loader"]
        self.loader = DataLoader(dataset, batch_size=self.batch, shuffle=True, seed=self.loader_seed,
                                 num_workers=t["workers"], process_index=dist.get_rank(),
                                 process_count=self.world)
        self.batches = iter(self.loader)
        self.shard = batch_shard()
        self.noise = st["noise"]
        self.steps = 0
        self.pending = None
        self.waits = []

    def noise_seed(self, step):
        return self.noise + step

    def step(self):
        t0 = time.perf_counter()
        with span("loader_wait"):
            batch = next(self.batches)
        self.waits.append(time.perf_counter() - t0)
        with span("step"):
            dev = port_step.batch_to_device(batch, self.device)
            gen = torch.Generator().manual_seed(self.noise_seed(self.steps))
            losses, end_points = port_step.train_step(self.net, self.optimizer, dev, generator=gen,
                                                      clip_norm=self.clip, shard=self.shard)
        self.steps += 1
        with span("read_losses"):
            if self.pending is not None:
                torch.stack(list(self.pending.values())).cpu()
        self.pending = losses
        return batch, losses, end_points

    def finish(self):
        if self.pending is not None:
            torch.stack(list(self.pending.values())).cpu()
            self.pending = None
        sync(self.device)

    def checked_steps(self):
        """The first steps; every rank's batches and outputs of them, gathered
        to each rank: [rank][step] -> (batch, end points), and this rank's
        losses, first gradient and parameters after them."""
        beta1 = float(self.optim_cfg["betas"][0])
        mine, own = [], {"losses": []}
        for i in range(self.traffic["checked_steps"]):
            batch, losses, ep = self.step()
            mine.append(({k: np.array(batch[k]) for k in GT_KEYS},
                         {k: ep[k].detach().cpu() for k in checks.CHOICE_OUTPUTS}))
            own["losses"].append(float(losses["total"]))
            if i == 0:
                own["grad1"] = {n: self.optimizer.state[p]["exp_avg"].cpu() / (1 - beta1)
                                for n, p in self.model.named_parameters()}
        own["params3"] = {n: p.detach().cpu().clone() for n, p in self.model.named_parameters()}
        gathered = [None] * self.world
        dist.all_gather_object(gathered, mine)
        return gathered, own

    def follow(self, store):
        """Run the steps rank 0 posts until it posts the last count."""
        while True:
            posted = int(store.get(TARGET))
            if self.steps < abs(posted):
                self.step()
            elif posted < 0:
                return
            else:
                time.sleep(0.001)

    def close(self):
        self.finish()
        self.loader.close()
        del self.net, self.model, self.optimizer, self.batches


def interleave(parts):
    """The global batch of the ranks' ``parts`` (arrays or tensors, rank
    order): row j is row j // world of rank j % world."""
    if torch.is_tensor(parts[0]):
        return torch.stack(parts, 1).reshape(-1, *parts[0].shape[1:])
    return np.stack(parts, 1).reshape(-1, *parts[0].shape[1:])


def global_record(gathered, own):
    """The checked steps as one process at the global batch would record
    them."""
    steps = range(len(gathered[0]))
    return {"batches": [{k: interleave([g[s][0][k] for g in gathered]) for k in GT_KEYS} for s in steps],
            "end_points": [{k: interleave([g[s][1][k] for g in gathered]) for k in checks.CHOICE_OUTPUTS}
                           for s in steps],
            **own}


def reference_batches(scene_list, loader_seed, batch, world, n_batches, num_frames, epoch_items):
    """The first global batches worked out again from the scenes, as the
    loader deals them to ``world`` processes: epoch 0's order is
    RandomState(seed).permutation of the repeated scene list, repeated up to
    whole global batches; process r takes order[r::world] and seeds each of
    its positions from RandomState(seed * 7919)'s draws by position in its
    shard (a sample twice in a shard with its last position's draw)."""
    n = -(-epoch_items // len(scene_list)) * len(scene_list)
    order = np.random.RandomState(loader_seed).permutation(n)
    order = np.resize(order, -(-n // (world * batch)) * world * batch)
    ranks = []
    for r in range(world):
        shard = order[r::world]
        drawn = np.random.RandomState(loader_seed * 7919).randint(0, 2 ** 31 - 1, size=len(shard))
        last = {int(idx): pos for pos, idx in enumerate(shard)}
        out = []
        for b in range(n_batches):
            items = [scenes.sample_to_item(*scene_list[shard[p] % len(scene_list)],
                                           np.random.RandomState(drawn[last[int(shard[p])]]), num_frames)
                     for p in range(b * batch, (b + 1) * batch)]
            out.append({k: np.stack([it[k] for it in items]) for k in GT_KEYS})
        ranks.append(out)
    return [{k: interleave([ranks[r][b][k] for r in range(world)]) for k in GT_KEYS} for b in range(n_batches)]


class Traffic:
    def __init__(self, cell, seed, device):
        t = cell.traffic
        self.world, self.batch, self.traffic = t["world"], t["batch"], t
        self.model_cfg, self.optim_cfg = cell.config["model"], cell.config["optimizer"]
        port, store_port = free_port(), free_port()
        self.saved_env = {k: os.environ.get(k) for k in (*ENV, "NCCL_SHM_DISABLE")}
        os.environ.update(rank_env(0, self.world, port))
        self.procs = []
        atexit.register(self.kill)
        for r in range(1, self.world):
            cmd = [sys.executable, os.path.realpath(__file__), "--root", cell.root, "--workload", cell.name,
                   "--seed", str(seed), "--rank", str(r), "--store-port", str(store_port),
                   "--device", device.type]
            self.procs.append(subprocess.Popen(cmd, cwd=REPO, env={**os.environ, **rank_env(r, self.world, port)},
                                               stdout=subprocess.DEVNULL))
        self.store = dist.TCPStore("localhost", store_port, self.world, is_master=True, timeout=TIMEOUT,
                                   wait_for_workers=False)
        self.device = join(device)
        self.rank = Rank(cell, seed, self.device)
        self.weights0 = self.rank.weights0

    @property
    def waits(self):
        return self.rank.waits

    def post(self, steps):
        self.store.set(TARGET, str(steps))

    def warm(self):
        gathered, own = self.rank.checked_steps()
        self.record = global_record(gathered, own)
        self.post(self.rank.steps + self.traffic["warm_steps"])
        for _ in range(self.traffic["warm_steps"]):
            self.rank.step()
        self.finish()

    def finish(self):
        self.rank.finish()

    def window(self, seconds):
        first = self.rank.steps
        ends = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.post(self.rank.steps + 1 + AHEAD)
            self.rank.step()
            ends.append(time.perf_counter() - t0)
        while self.rank.steps < int(self.store.get(TARGET)):
            self.rank.step()
            ends.append(time.perf_counter() - t0)
        self.finish()
        elapsed = time.perf_counter() - t0
        steps = self.rank.steps - first
        return {"items": steps * self.world * self.batch, "iterations": steps, "seconds": elapsed, "ends": ends}

    def traced(self):
        """Rank 0's traced steps (the others run them too, untraced); the
        loader's counters count from their start."""
        n = self.traffic["trace_steps"]
        self.rank.waits = []
        self.rank.loader.reset_stats()
        self.post(self.rank.steps + n)
        for _ in range(n):
            self.rank.step()
        self.loader_stats = dict(self.rank.loader.stats)
        return n

    def close(self):
        self.post(-self.rank.steps)
        self.rank.close()
        watchdog = threading.Timer(JOIN_S, self.abandon)
        watchdog.daemon = True
        watchdog.start()
        mesh.shutdown()
        watchdog.cancel()
        deadline = time.monotonic() + JOIN_S
        for p in self.procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
        self.kill()
        failed = [p.returncode for p in self.procs if p.returncode != 0]
        for k, v in self.saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if failed:
            raise RuntimeError(f"data-parallel ranks exited with {failed}")

    def abandon(self):
        """Leaving the group took over ``JOIN_S``: kill the ranks and end
        the run with code 1, so that it does not hang."""
        print(f"rank 0 did not leave the process group within {JOIN_S} s", file=sys.stderr, flush=True)
        self.kill()
        os._exit(1)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def checked_inputs(self):
        return checked_inputs(self.rank.scenes, self.rank.loader_seed, self.traffic, self.model_cfg,
                              self.rank.noise)

    def numbers(self):
        batches, seeds = self.checked_inputs()
        return checks.train_numbers(self.model_cfg, self.optim_cfg, self.weights0, self.record, batches, seeds,
                                    self.device)


def checked_inputs(scene_list, loader_seed, t, model_cfg, noise):
    """The checked steps' global batches worked out again, and their noise
    seeds."""
    n = t["checked_steps"]
    batches = reference_batches(scene_list, loader_seed, t["batch"], t["world"], n, model_cfg["num_frames"],
                                t["epoch_items"])
    return batches, [noise + i for i in range(n)]


def control_numbers(cell, seed, device):
    """The control: the plain reference trained on the global batches with
    TF32 on, put in the program's place, judged by the same comparison."""
    from benchmark.reference.p2rnet import set_precision

    t, m, optim = cell.traffic, cell.config["model"], cell.config["optimizer"]
    st = streams(seed)
    scene_list = scenes.make_scenes(np.random.RandomState(st["scenes"]), t["scenes"], t["objects"], t["frames"])
    leaf_shapes, mu = checks.shapes(m)
    weights0 = make_weights(leaf_shapes, mu, st["weights"], device)
    batches, seeds = checked_inputs(scene_list, st["loader"], t, m, st["noise"])
    try:
        set_precision(tf32=True)
        rec = checks.reference_record(m, optim, weights0, batches, seeds, device)
    finally:
        set_precision(tf32=False)
    return checks.train_numbers(m, optim, weights0, rec, batches, seeds, device)


def main():
    p = argparse.ArgumentParser(description="one data-parallel rank (1 .. world - 1) of a ddp cell")
    p.add_argument("--root", required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--store-port", type=int, required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), required=True)
    args = p.parse_args()
    from benchmark.harness import spec
    from pose2room_tpu_torch import kernels

    cell = spec.load_cell(args.root, args.workload)
    store = dist.TCPStore("localhost", args.store_port, cell.traffic["world"], is_master=False, timeout=TIMEOUT)
    device = join(torch.device(args.device))
    if device.type == "cuda":
        kernels.timed_build()
    rank = Rank(cell, args.seed, device)
    rank.checked_steps()
    rank.follow(store)
    rank.close()
    mesh.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
