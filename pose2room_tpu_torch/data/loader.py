"""Host-side batched data loader with a worker pool and one-batch prefetch.

Port of pose2room_tpu/data/loader.py.  Per epoch the sample order is
``RandomState(seed + epoch).permutation`` when shuffling, and every sample's
augmentation seed is pre-drawn from ``RandomState(seed * 7919 + epoch)``, so
the batches do not depend on which worker read which sample.  Batches are
collated numpy dicts; the last one may be short (no drop_last by default).

Data parallel (``process_count`` > 1, one loader a process): the order is
wrap-padded to a multiple of ``process_count * batch_size`` and process i
takes ``order[i::process_count]``, so every process runs the same number of
full batches (DistributedSampler's padding), and batch k of process i holds
rows i, i + N, ... of the global batch k of one process at N times the
batch.  Seeds go by position in the process's shard; a sample that the
padding repeats in a shard takes the seed of its last position there, as
the JAX loader's ``i_pos`` map gives it, so the shards equal the JAX
package's bit for bit.

Two worker modes (``device.worker_mode``):

* ``thread`` (default): a ThreadPoolExecutor.  HDF5 reads and large numpy
  augmentation ops release the GIL, so threads overlap reading with device
  steps at no IPC cost, within about one core of Python.
* ``process``: a forkserver ProcessPoolExecutor whose initializer installs
  the dataset in each worker (pickled once a worker): real parallelism for
  hosts where one core of Python cannot feed the card, at the cost of
  pickling each sample back.  The same pre-drawn seeds make its batches
  bit-equal to thread mode's.

``DataLoader.stats`` counts, always on, the batches and items made and the
CPU seconds they took (``cpu_s``): each item's ``time.thread_time`` in the
worker that read it, which travels back with the item, plus the collate.
The thread that makes a batch adds it up, so no lock is taken;
``reset_stats`` starts the count again.
"""

import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

# the dataset of a process-mode worker, set once by the pool's initializer
_WORKER_DATASET = None


def _process_worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _timed(fetch, *args, **kwargs):
    """(fetch(*args, **kwargs), the CPU seconds this thread spent in it)."""
    t0 = time.thread_time()
    item = fetch(*args, **kwargs)
    return item, time.thread_time() - t0


def _process_worker_fetch(args):
    idx, seed = args
    return _timed(_WORKER_DATASET.__getitem__, idx, rng=np.random.RandomState(seed))


def collate(samples):
    """Stack a list of sample dicts; string keys become lists."""
    batch = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        batch[key] = vals if isinstance(vals[0], str) else np.stack(vals)
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=False, seed=42, drop_last=False,
                 num_workers=8, worker_mode="thread", process_index=0, process_count=1):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"unknown worker_mode {worker_mode!r}")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} is not in [0, {process_count})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.worker_mode = worker_mode
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self.reset_stats()
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

    def reset_stats(self):
        """Zero ``stats``.  A fresh dict: a batch being counted meanwhile
        goes into the old one, and the reset is never lost."""
        self.stats = {"batches": 0, "items": 0, "cpu_s": 0.0}

    def _collate_counted(self, timed):
        """Collate (item, seconds) pairs and count the batch in ``stats``."""
        t0 = time.thread_time()
        batch = collate([item for item, _ in timed])
        cpu_s = sum(s for _, s in timed) + time.thread_time() - t0
        stats = self.stats
        stats["batches"] += 1
        stats["items"] += len(timed)
        stats["cpu_s"] += cpu_s
        return batch

    def close(self):
        for pool in (self._prefetcher, self._pool):
            if pool is not None:
                pool.shutdown(wait=True)

    def _epoch_indices(self):
        """This process's sample order for the epoch."""
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        if self.process_count > 1:
            stride = self.process_count * self.batch_size
            order = np.resize(order, -(-n // stride) * stride)  # cyclic repeat up to full batches
        return order[self.process_index::self.process_count]

    def __len__(self):
        n = len(self._epoch_indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        order = self._epoch_indices()
        rng = np.random.RandomState(self.seed * 7919 + self.epoch)
        drawn = rng.randint(0, 2 ** 31 - 1, size=len(order))  # by position in the shard
        last = {int(idx): pos for pos, idx in enumerate(order)}
        seeds = [drawn[last[int(idx)]] for idx in order]

        def fetch(pos):
            return _timed(self.dataset.__getitem__, int(order[pos]), rng=np.random.RandomState(seeds[pos]))

        def make_batch(start):
            positions = range(start, min(start + self.batch_size, len(order)))
            if self.drop_last and len(positions) < self.batch_size:
                return None
            if self._pool is None:
                return self._collate_counted([fetch(p) for p in positions])
            if self.worker_mode == "process":
                jobs = [(int(order[p]), int(seeds[p])) for p in positions]
                return self._collate_counted(list(self._pool.map(_process_worker_fetch, jobs)))
            return self._collate_counted(list(self._pool.map(fetch, positions)))

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
