"""loader_wait_ms.train: the mean time a step of the traced window waited
in next(loader) for its batch (host clock around the call)."""

import numpy as np


def read(ctx):
    if ctx["trace"] is None:
        return None
    waits = ctx["spans"]["loader_wait"]
    return 1e3 * float(np.mean(waits)) if waits else None
