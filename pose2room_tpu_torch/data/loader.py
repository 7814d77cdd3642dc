"""Host-side batched data loader with a worker pool and one-batch prefetch.

Port of pose2room_tpu/data/loader.py (single process).  Per epoch the
sample order is ``RandomState(seed + epoch).permutation`` when shuffling,
and every sample's augmentation seed is pre-drawn from
``RandomState(seed * 7919 + epoch)``, so the batches do not depend on which
worker read which sample.  Batches are collated numpy dicts; the last one
may be short (no drop_last by default).

Two worker modes (``device.worker_mode``):

* ``thread`` (default): a ThreadPoolExecutor.  HDF5 reads and large numpy
  augmentation ops release the GIL, so threads overlap reading with device
  steps at no IPC cost, within about one core of Python.
* ``process``: a forkserver ProcessPoolExecutor whose initializer installs
  the dataset in each worker (pickled once a worker): real parallelism for
  hosts where one core of Python cannot feed the card, at the cost of
  pickling each sample back.  The same pre-drawn seeds make its batches
  bit-equal to thread mode's.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

# the dataset of a process-mode worker, set once by the pool's initializer
_WORKER_DATASET = None


def _process_worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _process_worker_fetch(args):
    idx, seed = args
    return _WORKER_DATASET.__getitem__(idx, rng=np.random.RandomState(seed))


def collate(samples):
    """Stack a list of sample dicts; string keys become lists."""
    batch = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        batch[key] = vals if isinstance(vals[0], str) else np.stack(vals)
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=False, seed=42, drop_last=False,
                 num_workers=8, worker_mode="thread"):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"unknown worker_mode {worker_mode!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.worker_mode = worker_mode
        self.epoch = 0
        if not num_workers:
            self._pool = None
        elif worker_mode == "process":
            # forkserver, not fork: a fork of this process (threads of torch,
            # of the prefetcher and of other loaders by then) can clone a
            # child holding a locked mutex and deadlock
            self._pool = ProcessPoolExecutor(
                max_workers=num_workers, mp_context=multiprocessing.get_context("forkserver"),
                initializer=_process_worker_init, initargs=(dataset,))
        else:
            self._pool = ThreadPoolExecutor(max_workers=num_workers)
        # reads batch k+1 while batch k trains (distinct from _pool: its task
        # blocks on _pool.map)
        self._prefetcher = ThreadPoolExecutor(max_workers=1) if num_workers else None

    def set_epoch(self, epoch):
        self.epoch = epoch

    def close(self):
        for pool in (self._prefetcher, self._pool):
            if pool is not None:
                pool.shutdown(wait=True)

    def _epoch_indices(self):
        n = len(self.dataset)
        if self.shuffle:
            return np.random.RandomState(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        order = self._epoch_indices()
        rng = np.random.RandomState(self.seed * 7919 + self.epoch)
        seeds = rng.randint(0, 2 ** 31 - 1, size=len(order))  # by position in the epoch

        def fetch(pos):
            return self.dataset.__getitem__(int(order[pos]), rng=np.random.RandomState(seeds[pos]))

        def make_batch(start):
            positions = range(start, min(start + self.batch_size, len(order)))
            if self.drop_last and len(positions) < self.batch_size:
                return None
            if self._pool is None:
                return collate([fetch(p) for p in positions])
            if self.worker_mode == "process":
                jobs = [(int(order[p]), int(seeds[p])) for p in positions]
                return collate(list(self._pool.map(_process_worker_fetch, jobs)))
            return collate(list(self._pool.map(fetch, positions)))

        starts = list(range(0, len(order), self.batch_size))
        if self._pool is None:
            for start in starts:
                batch = make_batch(start)
                if batch is not None:
                    yield batch
            return
        pending = self._prefetcher.submit(make_batch, starts[0]) if starts else None
        for next_start in starts[1:] + [None]:
            batch = pending.result()
            pending = self._prefetcher.submit(make_batch, next_start) if next_start is not None else None
            if batch is not None:
                yield batch
