"""generate_ms_p95: the 95th percentile of every batch's time in the
window, from the copy in being issued to the outputs on the host (host
clock, linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
    times = ctx["window"].get("batch_seconds")
    return 1e3 * float(np.percentile(times, 95)) if times else None
