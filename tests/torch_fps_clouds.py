"""FPS clouds of the port's FPS tests: tests/test_torch_gpu.py holds the
card's kernel to ``fps_ref`` on them, tests/test_torch_kernels.py holds
``fps_ref`` to JAX on the same clouds.  numpy only (no JAX, no torch), so
that the card tests import it on a machine without JAX.
"""

import numpy as np

FPS_KINDS = ("random", "near_origin", "ties", "all_invalid", "grid", "cross_lane_ties", "one_valid")
# tied pairs (lower, higher index) at far corners, each the argmax of a pick:
# (2, 7) in one lane of the blocked layout (8 or 16 points a lane); (5, 34),
# (37, 67) with the lower index in the higher lane of the strided layout
# (i % 32); (120, 130), (250, 260), (501, 515), (1530, 1540) with the lower
# index in the higher lane of both the strided and a blocked layout (4
# points a lane over 4 warps; 8 over 2, 4 or 8 warps; 16 over 2 or 4)
FPS_TIED_PAIRS = ((2, 7), (5, 34), (37, 67), (120, 130), (250, 260), (501, 515), (1530, 1540))


def fps_cloud(kind, B, N, seed):
    """(B, N, 3) f32 FPS clouds, made with numpy from ``seed``.  The card
    tests hold the kernel to fps_ref on them, and tests/test_torch_kernels.py
    holds fps_ref to JAX on the same clouds."""
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(B, N, 3) * 4 - 2).astype(np.float32)
    if kind == "near_origin":
        xyz[:, 1:N // 4] *= 1e-3  # ||p||^2 <= 1e-3: never candidates
    elif kind == "ties":
        xyz[:, N // 2:] = xyz[:, :N - N // 2]  # every point duplicated
        if N > 9:
            xyz[:, 5] = xyz[:, 9]
    elif kind == "all_invalid":
        xyz *= 1e-4
    elif kind == "grid":  # exact equal distances everywhere
        g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3)
        xyz = np.broadcast_to(g[np.arange(N) % 64].astype(np.float32) - 1.5, (B, N, 3)).copy()
    elif kind == "cross_lane_ties":
        corners = np.array([[20, 20, 20], [-20, -20, 20], [-20, 20, -20], [20, -20, -20], [20, 20, -20],
                            [-20, -20, -20], [-20, 20, 20]], np.float32)
        for corner, (lo, hi) in zip(corners, FPS_TIED_PAIRS):
            if hi < N:
                xyz[:, lo] = xyz[:, hi] = corner
    elif kind == "one_valid":  # every point but one never a candidate: -1 below a pick's +0
        xyz *= 1e-4
        xyz[:, N // 2] = (1.5, -0.5, 0.25)
    return xyz
