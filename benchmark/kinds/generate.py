"""The ``generate`` kind: ``P2RNet.generate`` on folded weights, ``batch``
clips a call, batch after batch from a pinned host pool of ``scenes`` x
``angles`` clips (``objects`` boxes, ``frames`` frames resampled to the
model's); each batch's outputs are copied back before it counts.  Set-up
runs ``warm_batches``; the traced window runs ``trace_batches``.
"""

import math
import time

import numpy as np
import torch

from benchmark.harness import checks, scenes
from benchmark.harness.cells import program_model, span, streams, sync
from benchmark.harness.weights import make_weights


class Traffic:
    def __init__(self, cell, seed, device):
        t, self.model_cfg, self.device = cell.traffic, cell.config["model"], device
        st = streams(seed)
        self.batch = B = t["batch"]
        joints = scenes.make_scenes(np.random.RandomState(st["scenes"]), t["scenes"], t["objects"],
                                    t["frames"], stored=False)
        ids = scenes.frame_ids(t["frames"], self.model_cfg["num_frames"])
        clips = [scenes.rotated_clip(j[ids].astype(np.float32), math.radians(a))
                 for a in t["angles"] for j in joints]
        self.n_batches = len(clips) // B
        pool = torch.from_numpy(np.stack(clips[:self.n_batches * B]))
        self.pool = pool.pin_memory() if device.type == "cuda" else pool
        leaf_shapes, mu = checks.shapes(self.model_cfg)
        self.weights = make_weights(leaf_shapes, mu, st["weights"], device)
        self.model = program_model(self.model_cfg, self.weights, device).eval()
        self.folded = self.model.fold_eval()
        self.sample_seed = st["sample"]
        self.traffic = t
        self.calls = 0
        self.kept = []

    def step(self):
        """One batch from issue to its outputs on the host: (pool batch,
        outputs, seconds)."""
        k = self.calls % self.n_batches
        self.calls += 1
        t0 = time.perf_counter()
        with span("h2d"):
            x = self.pool[k * self.batch:(k + 1) * self.batch].to(self.device, non_blocking=True)
        with span("generate"):
            ep = self.model.generate(x, folded=self.folded)
        with span("d2h"):
            out = {key: ep[key].cpu() for key in checks.KEPT}
        return k, out, time.perf_counter() - t0

    def warm(self):
        for _ in range(self.traffic["warm_batches"]):
            self.step()
        self.finish()

    def finish(self):
        sync(self.device)

    def window(self, seconds):
        times, ends = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            k, out, dt = self.step()
            times.append(dt)
            ends.append(time.perf_counter() - t0)
            self.kept.append((k, out))
        elapsed = time.perf_counter() - t0
        return {"items": len(times) * self.batch, "iterations": len(times), "seconds": elapsed,
                "batch_seconds": times, "ends": ends}

    def traced(self):
        n = self.traffic["trace_batches"]
        for _ in range(n):
            self.step()
        return n

    def close(self):
        del self.model, self.folded

    def numbers(self):
        """The comparison over one batch of the window, drawn from the seed."""
        k, out = self.kept[np.random.RandomState(self.sample_seed).randint(len(self.kept))]
        clips = self.pool[k * self.batch:(k + 1) * self.batch]
        self.kept = []
        return checks.generate_numbers(self.model_cfg, self.weights, clips, out, self.device)
