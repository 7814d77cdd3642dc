"""The ``train`` kind: ``train/step.py:train_step`` on batches of the
program's ``DataLoader`` over a ``SceneDataset`` of synthetic scenes made
at set-up (``scenes`` of them, ``objects`` boxes, ``frames`` frames,
repeated to ``epoch_items`` rows so that no epoch ends inside the window),
``workers`` thread workers, augmentation on, the configuration's Adam.
Each step's MDN noise comes from a host generator seeded from the run's
seed and the step.  Set-up drives the first ``checked_steps`` steps through
the window's own step function and keeps what the comparison needs, then
``warm_steps`` more; the traced window runs ``trace_steps``, over which
it keeps the loader's counters (``DataLoader.stats``).  Losses are
read one step late, as the program's epoch loop reads them.
"""

import time

import numpy as np
import torch

from benchmark.harness import checks, scenes
from benchmark.harness.cells import program_model, span, streams, sync
from benchmark.harness.weights import make_weights
from pose2room_tpu_torch.data.dataset import SceneDataset
from pose2room_tpu_torch.data.loader import DataLoader
from pose2room_tpu_torch.train import state as port_state
from pose2room_tpu_torch.train import step as port_step

GT_KEYS = ("input_joints",) + port_step.GT_KEYS


class Traffic:
    def __init__(self, cell, seed, device):
        t, self.model_cfg, self.device = cell.traffic, cell.config["model"], device
        self.optim_cfg = cell.config["optimizer"]
        st = streams(seed)
        self.batch = t["batch"]
        self.scenes = scenes.make_scenes(np.random.RandomState(st["scenes"]), t["scenes"], t["objects"],
                                         t["frames"])
        leaf_shapes, mu = checks.shapes(self.model_cfg)
        self.weights0 = make_weights(leaf_shapes, mu, st["weights"], device)
        self.model = program_model(self.model_cfg, self.weights0, device)
        self.optimizer, _, clip = port_state.make_optimizer(self.model, self.optim_cfg)
        self.clip = clip
        reps = -(-t["epoch_items"] // len(self.scenes))
        dataset = SceneDataset(self.scenes * reps, num_frames=self.model_cfg["num_frames"], augment=True)
        self.loader_seed = st["loader"]
        self.loader = DataLoader(dataset, batch_size=self.batch, shuffle=True, seed=self.loader_seed,
                                 num_workers=t["workers"])
        self.batches = iter(self.loader)
        self.noise = st["noise"]
        self.steps = 0
        self.pending = None
        self.waits = []
        self.traffic = t

    def noise_seed(self, step):
        return self.noise + step

    def step(self):
        """One step of the window: the next batch, the program's train step;
        the previous step's losses read back (the epoch loop's order)."""
        t0 = time.perf_counter()
        with span("loader_wait"):
            batch = next(self.batches)
        self.waits.append(time.perf_counter() - t0)
        with span("step"):
            dev = port_step.batch_to_device(batch, self.device)
            gen = torch.Generator().manual_seed(self.noise_seed(self.steps))
            losses, end_points = port_step.train_step(self.model, self.optimizer, dev, generator=gen,
                                                      clip_norm=self.clip)
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

    def warm(self):
        """The first steps through the window's own step function, kept for
        the comparison; then a few more."""
        beta1 = float(self.optim_cfg["betas"][0])
        rec = {"batches": [], "end_points": [], "losses": []}
        for i in range(self.traffic["checked_steps"]):
            batch, losses, ep = self.step()
            rec["batches"].append({k: np.array(batch[k]) for k in GT_KEYS})
            rec["end_points"].append({k: ep[k].detach().cpu() for k in checks.CHOICE_OUTPUTS})
            rec["losses"].append(float(losses["total"]))
            if i == 0:
                rec["grad1"] = {n: self.optimizer.state[p]["exp_avg"].cpu() / (1 - beta1)
                                for n, p in self.model.named_parameters()}
        rec["params3"] = {n: p.detach().cpu().clone() for n, p in self.model.named_parameters()}
        self.record = rec
        for _ in range(self.traffic["warm_steps"]):
            self.step()
        self.finish()

    def window(self, seconds):
        """Steps until ``seconds`` have passed: samples and seconds."""
        first = self.steps
        t0 = time.perf_counter()
        ends = []
        while time.perf_counter() - t0 < seconds:
            self.step()
            ends.append(time.perf_counter() - t0)
        self.finish()
        elapsed = time.perf_counter() - t0
        return {"items": (self.steps - first) * self.batch, "iterations": self.steps - first,
                "seconds": elapsed, "ends": ends}

    def traced(self):
        """The traced steps; the loader's counters count from their start
        (and may take in the batch prefetched for the step after)."""
        self.waits = []
        self.loader.reset_stats()
        n = self.traffic["trace_steps"]
        for _ in range(n):
            self.step()
        self.loader_stats = dict(self.loader.stats)
        return n

    def close(self):
        self.loader.close()
        self.pending = None
        del self.model, self.optimizer, self.batches

    def numbers(self):
        """The comparison over the kept first steps."""
        batches, seeds = self.checked_inputs()
        return checks.train_numbers(self.model_cfg, self.optim_cfg, self.weights0, self.record, batches,
                                    seeds, self.device)

    def checked_inputs(self, n=None):
        """The first ``n`` (the checked) steps' batches worked out again from
        the scenes, and their noise seeds."""
        n = self.traffic["checked_steps"] if n is None else n
        batches = reference_batches(self.scenes, self.loader_seed, self.batch, n, self.model_cfg["num_frames"],
                                    self.traffic["epoch_items"])
        return batches, [self.noise_seed(i) for i in range(n)]


def reference_batches(scene_list, loader_seed, batch, n_batches, num_frames, epoch_items):
    """The loader's first batches worked out again from the scenes: epoch
    0's order is RandomState(seed).permutation of the repeated scene list,
    each row's augmentation seed the position's draw from
    RandomState(seed * 7919)."""
    n = -(-epoch_items // len(scene_list)) * len(scene_list)
    order = np.random.RandomState(loader_seed).permutation(n)
    drawn = np.random.RandomState(loader_seed * 7919).randint(0, 2 ** 31 - 1, size=n)
    out = []
    for b in range(n_batches):
        items = [scenes.sample_to_item(*scene_list[order[p] % len(scene_list)],
                                       np.random.RandomState(drawn[p]), num_frames)
                 for p in range(b * batch, (b + 1) * batch)]
        out.append({k: np.stack([it[k] for it in items]) for k in GT_KEYS})
    return out
