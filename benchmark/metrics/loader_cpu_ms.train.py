"""loader_cpu_ms.train: the loader's CPU milliseconds a batch over the
traced steps (``DataLoader.stats``: each item's thread CPU time in the
worker that made it, plus the collate), over the batches it made in them:
one a step, and the batch prefetched for the step after where it was
done in time."""


def read(ctx):
    stats = ctx["spans"]["loader"] if ctx["trace"] is not None else None
    return 1e3 * stats["cpu_s"] / stats["batches"] if stats and stats["batches"] else None
