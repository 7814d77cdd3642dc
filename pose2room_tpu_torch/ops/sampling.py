"""Point-sampling ops: furthest-point sampling, ball query, grouping.

Port of pose2room_tpu/ops/sampling.py, with the reference CUDA semantics of
``external/pointnet2_ops_lib``:

* ``furthest_point_sample``: the hand-written CUDA kernel (csrc/fps.cu) on a
  card, ``fps_ref`` on the CPU.  First pick is index 0, each further pick the
  argmax of the running min-distance (ties to the lowest index), and points
  with ||p||^2 <= 1e-3 are never candidates.
* ``ball_query``: for each center the first ``nsample`` points in scan order
  with d^2 < r^2; short balls repeat the first hit, empty balls give index 0.
* ``gather_points`` / ``group_points``: channel-last gathers.

The last three are plain PyTorch, as they are plain XLA in the JAX package.
Squared norms and distances are written out term by term in a fixed order,
so the CPU and the card round them alike.
"""

import ctypes

import torch

from pose2room_tpu_torch import kernels

_NEAR_ORIGIN_SQ = 1e-3
_INIT_DIST = 1e10
_FPS_MAX_POINTS = 2048  # csrc/fps.cu: up to 4 warps a clip x 32 lanes x 16 points a lane


def _sq3(x, y, z):
    return x * x + y * y + z * z


def fps_ref(xyz, npoint):
    """Plain PyTorch FPS. xyz: (B, N, 3) f32 -> (B, npoint) int32."""
    B, N, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    valid = _sq3(x, y, z) > _NEAR_ORIGIN_SQ
    mind = torch.full((B, N), _INIT_DIST, dtype=torch.float32, device=xyz.device)
    neg = torch.full_like(mind, -1.0)
    rows = torch.arange(B, device=xyz.device)
    old = torch.zeros(B, dtype=torch.long, device=xyz.device)
    picks = [old]
    for _ in range(npoint - 1):
        d = _sq3(x - x[rows, old, None], y - y[rows, old, None], z - z[rows, old, None])
        mind = torch.where(valid, torch.minimum(mind, d), mind)
        old = torch.argmax(torch.where(valid, mind, neg), dim=1)
        picks.append(old)
    return torch.stack(picks, dim=1).to(torch.int32)


def furthest_point_sample(xyz, npoint):
    """FPS: the CUDA kernel for CUDA tensors, ``fps_ref`` for CPU tensors.

    xyz: (B, N, 3) f32.  Returns (B, npoint) int32; column 0 is always 0.
    """
    if xyz.device.type == "cpu":
        return fps_ref(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"no FPS kernel for device {xyz.device}")
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"xyz has shape {tuple(xyz.shape)}, expected (B, N, 3)")
    if xyz.dtype != torch.float32:
        raise TypeError(f"xyz is {xyz.dtype}; the FPS kernel takes float32")
    if not xyz.is_contiguous():
        raise ValueError("xyz is not contiguous")
    B, N, _ = xyz.shape
    if not 1 <= npoint <= N <= _FPS_MAX_POINTS:
        raise ValueError(f"FPS kernel needs 1 <= npoint={npoint} <= N={N} <= {_FPS_MAX_POINTS}")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    fn = kernels.load("fps").p2r_fps_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(xyz.data_ptr(), out.data_ptr(), B, N, npoint,
             torch.cuda.current_stream(xyz.device).cuda_stream)
    kernels.check(err, "fps")
    kernels.LAUNCHES["fps"] += 1
    return out


def ball_query(radius, new_xyz, xyz, nsample):
    """First-``nsample``-in-scan-order ball query with first-hit backfill.

    new_xyz: (B, M, 3) centers; xyz: (B, N, 3) points scanned in order.
    Returns (B, M, nsample) int32 indices into xyz.  d^2 < radius^2 is a hit
    (strict); short balls repeat the first hit; empty balls give index 0.
    """
    N = xyz.shape[1]
    q = new_xyz[:, :, None, :]
    p = xyz[:, None, :, :]
    dot = q[..., 0] * p[..., 0] + q[..., 1] * p[..., 1] + q[..., 2] * p[..., 2]
    d2 = _sq3(*new_xyz.unbind(-1))[:, :, None] + _sq3(*xyz.unbind(-1))[:, None, :] - 2.0 * dot
    hit = d2 < radius * radius
    order = torch.arange(N, dtype=torch.int32, device=xyz.device)
    scan_key = torch.where(hit, order, torch.full_like(order, N))
    slots = torch.topk(scan_key, nsample, dim=-1, largest=False, sorted=True).values
    slots = torch.where(slots == N, slots[:, :, :1], slots)
    slots = torch.where(slots == N, torch.zeros_like(slots), slots)
    return slots.to(torch.int32)


def gather_points(points, idx):
    """points: (B, N, C); idx: (B, M) -> (B, M, C)."""
    return torch.gather(points, 1, idx.long()[:, :, None].expand(-1, -1, points.shape[-1]))


def group_points(points, idx):
    """points: (B, N, C); idx: (B, M, S) -> (B, M, S, C)."""
    B, M, S = idx.shape
    return gather_points(points, idx.reshape(B, M * S)).reshape(B, M, S, points.shape[-1])
