"""Host-side batched data loader with a thread pool and one-batch prefetch.

Port of pose2room_tpu/data/loader.py (single process).  Per epoch the
sample order is ``RandomState(seed + epoch).permutation`` when shuffling,
and every sample's augmentation seed is pre-drawn from
``RandomState(seed * 7919 + epoch)``, so the batches do not depend on which
worker thread read which sample.  Batches are collated numpy dicts; the
last one may be short (no drop_last by default).  The process-pool worker
mode is not ported and raises.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np


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
        if worker_mode != "thread":
            raise NotImplementedError(f"worker_mode {worker_mode!r}: only 'thread' is ported")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self._pool = ThreadPoolExecutor(max_workers=num_workers) if num_workers else None
        # reads batch k+1 while batch k trains (distinct from _pool: its task
        # blocks on _pool.map)
        self._prefetcher = ThreadPoolExecutor(max_workers=1) if num_workers else None

    def set_epoch(self, epoch):
        self.epoch = epoch

    def close(self):
        for pool in (self._pool, self._prefetcher):
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
