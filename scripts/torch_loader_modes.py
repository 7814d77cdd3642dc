#!/usr/bin/env python3
"""Time the port's loader in thread and process mode on the host.

    python3 scripts/torch_loader_modes.py [--workers 2 8] [--epochs 6]
    OPENBLAS_NUM_THREADS=1 python3 scripts/torch_loader_modes.py

Two measurements, at the full width of p2rnet_train.yaml (T=768, batch 8)
on 16 in-memory synthetic scenes (900 frames, augmentation on), the data
that ``chip_smoke.py`` trains on:

1. The start of a forkserver process pool of each worker count, with the
   initializer given a 32-byte argument and then the pickled dataset (as
   ``data/loader.py``'s process mode gives it): when each worker's
   initializer ran, in seconds after the pool was made.
2. ``DataLoader`` per-epoch times in each mode and worker count over
   ``--epochs`` epochs, and samples/s over the last two (host clock).

The environment's BLAS thread count (``OPENBLAS_NUM_THREADS``) is printed
beside them: each process-mode worker starts its own BLAS thread pool.
"""

import argparse
import multiprocessing
import os
import pickle
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pose2room_tpu_torch.data import synth  # noqa: E402
from pose2room_tpu_torch.data.dataset import SceneDataset  # noqa: E402
from pose2room_tpu_torch.data.loader import DataLoader  # noqa: E402


def _note_start(made, payload):
    print(f"    worker {os.getpid()} initializer at +{time.time() - made:.2f} s", flush=True)


def _pid(_):
    time.sleep(0.5)  # keeps each worker busy, so the pool starts all of them
    return os.getpid()


def pool_start(workers, payload, what):
    made = time.time()
    pool = ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("forkserver"),
                               initializer=_note_start, initargs=(made, payload))
    print(f"  pool of {workers}, initializer argument {what}:", flush=True)
    futures = [pool.submit(_pid, i) for i in range(2 * workers)]
    submitted = time.time() - made
    pids = {f.result() for f in futures}
    print(f"    {len(pids)} workers; submits returned at +{submitted:.2f} s, all tasks done at "
          f"+{time.time() - made:.2f} s", flush=True)
    pool.shutdown()


def loader_epochs(dataset, mode, workers, epochs):
    loader = DataLoader(dataset, batch_size=8, shuffle=True, seed=42, num_workers=workers, worker_mode=mode)
    seconds = []
    try:
        for epoch in range(epochs):
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            list(loader)
            seconds.append(time.perf_counter() - t0)
    finally:
        loader.close()
    rate = 2 * len(dataset) / sum(seconds[-2:])
    print(f"  {mode} x{workers}: {rate:.1f} samples/s over the last two epochs; epochs "
          f"{', '.join(f'{t:.3f}' for t in seconds)} s", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, nargs="+", default=[2, 8])
    ap.add_argument("--epochs", type=int, default=6)
    args = ap.parse_args()
    rng = np.random.RandomState(5)
    scenes = [synth.as_stored(*synth.make_scene(rng, n_objects=int(rng.randint(2, 6)), n_frames=900))
              for _ in range(16)]
    dataset = SceneDataset(scenes, num_frames=768, augment=True)
    print(f"OPENBLAS_NUM_THREADS={os.environ.get('OPENBLAS_NUM_THREADS')}; {os.cpu_count()} cores; "
          f"pickled dataset {len(pickle.dumps(dataset)) / 2**20:.1f} MiB", flush=True)
    for workers in args.workers:
        pool_start(workers, b"x" * 32, "32 bytes")
        pool_start(workers, dataset, "the dataset")
    for workers in args.workers:
        for mode in ("thread", "process"):
            loader_epochs(dataset, mode, workers, args.epochs)


if __name__ == "__main__":
    main()
