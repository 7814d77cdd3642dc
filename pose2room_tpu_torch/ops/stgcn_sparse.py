"""Block-sparse folded graph matmul of the ST-GCN eval chain.

Port of pose2room_tpu/ops/stgcn_sparse.py.  The folded graph conv is a
(Wp, Wp) = (3456, 3456) matrix whose 64x64 joint blocks are zero wherever two
joints are more than max_hop apart: 971 of 53*53 joint pairs are connected.
A joint permutation (models/graph.py:SPARSE_JOINT_ORDER) pairs the joints so
that only 279 of the 729 128x128 tiles hold a nonzero block, and only those
tiles are stored, packed (nnz, 128, 128) in CSR order by output column tile
(``col_off``, ``vlist`` from ``sparse_tile_lists``).

``sparse_graph_matmul_bn_relu`` computes relu((x @ M) * s1 + b1) from the
packed tiles: the hand-written CUDA kernel (csrc/stgcn_sparse.cu) for CUDA
tensors, the plain version ``sparse_graph_matmul_bn_relu_ref`` (densify,
then one f32 matmul) for CPU tensors.  Its output feeds the epilogue kernel
of ops/stgcn_fused.py, which serves the permuted layout unchanged: its taps
are the same for every joint and the caller permutes the per-column vectors.

In the bf16 chain x, the tiles and the output are bf16 and vecs f32: the
products accumulate in f32 and relu(acc * s1 + b1) is rounded to bf16 once
(JAX stgcn_sparse.py:142-151); the kernel's bf16 leg keeps its split-K
partials in f32 too.

Padding contract: the pad joint (order value 53, slot 36 of the default
order, so columns 2304..2367 and not the last 64) has zero rows and columns
in M and zero per-column vectors, so its columns stay exactly zero.
"""

import ctypes

import numpy as np
import torch

from pose2room_tpu_torch import kernels
from pose2room_tpu_torch.ops.stgcn_fused import LANE, N_VEC_ROWS, widen


def sparse_tile_lists(pair_support, order):
    """CSR-by-output-tile lists of the nonzero 128x128 tiles.

    pair_support: (V, V) bool, True where any A_k[v, w] can be nonzero.
    order: (Vp,) joint permutation, Vp = V rounded up to even; slots holding
    values >= V are pad joints with no support.  Returns numpy int32
    (col_off (Vp//2 + 1,), vlist (nnz,)): the input tiles of output tile w
    are vlist[col_off[w]:col_off[w+1]].
    """
    Vp = len(order)
    if Vp % 2:
        raise ValueError(f"the order has {Vp} slots; two joints share a 128-wide tile")
    V = pair_support.shape[0]
    sup = np.zeros((Vp, Vp), dtype=bool)
    sup[:V, :V] = pair_support
    sup = sup[np.ix_(order, order)]
    tiles = sup.reshape(Vp // 2, 2, Vp // 2, 2).any(axis=(1, 3))  # (input tile, output tile)
    col_off, vlist = [0], []
    for w in range(Vp // 2):
        vlist.extend(np.where(tiles[:, w])[0].tolist())
        col_off.append(len(vlist))
    return np.asarray(col_off, dtype=np.int32), np.asarray(vlist, dtype=np.int32)


def tile_columns(col_off):
    """The output tile of each packed tile (numpy int32, length nnz)."""
    col_off = np.asarray(col_off)
    return np.repeat(np.arange(len(col_off) - 1, dtype=np.int32), np.diff(col_off))


def gather_m_tiles(M_perm, col_off, vlist):
    """Pack the nonzero (128, 128) tiles of the joint-permuted folded matrix
    M_perm (Wp, Wp) tensor into (nnz, 128, 128), in the order of ``vlist``."""
    G = M_perm.shape[0] // LANE
    t = M_perm.reshape(G, LANE, G, LANE)
    rows = torch.as_tensor(np.asarray(vlist, dtype=np.int64), device=M_perm.device)
    cols = torch.as_tensor(tile_columns(col_off).astype(np.int64), device=M_perm.device)
    return t[rows, :, cols, :]


def densify_tiles(m_tiles, vlist, wlist, G):
    """The dense (G*128, G*128) matrix of packed tiles: the inverse of
    ``gather_m_tiles``.  vlist / wlist: index tensors on m_tiles' device."""
    dense = m_tiles.new_zeros(G, LANE, G, LANE)
    dense[vlist, :, wlist, :] = m_tiles
    return dense.reshape(G * LANE, G * LANE)


def sparse_graph_matmul_bn_relu_ref(x, m_tiles, vecs, col_off, vlist):
    """Plain PyTorch version of the kernel (same operands): densify the
    tiles, then relu((x @ M) * s1 + b1) with an f32 accumulator, cast to x's
    dtype once (bf16 operands are widened to f32, value-exact)."""
    G = x.shape[-1] // LANE
    col_off = torch.as_tensor(col_off, device=m_tiles.device).long()
    wlist = torch.repeat_interleave(torch.arange(G, device=m_tiles.device), torch.diff(col_off))
    vlist = torch.as_tensor(vlist, device=m_tiles.device).long()
    dense = densify_tiles(widen(m_tiles), vlist, wlist, G)
    return torch.relu(torch.matmul(widen(x), dense) * vecs[0] + vecs[1]).to(x.dtype)


# each dtype's leg of the kernel: (launch-count name, C entry point)
SPARSE_LEGS = {
    torch.float32: ("stgcn_sparse", "p2r_stgcn_sparse_f32"),
    torch.bfloat16: ("stgcn_sparse_bf16", "p2r_stgcn_sparse_bf16"),
}


def sparse_graph_matmul_bn_relu(x, m_tiles, vecs, col_off, vlist):
    """relu((x @ M) * s1 + b1) with M given as its packed nonzero tiles: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    x: (B, T, Wp) f32 or bf16 in the joint-permuted merged layout, pad
    columns zero; m_tiles: (nnz, 128, 128) in x's dtype (which picks the
    kernel's leg); vecs: (8, Wp) f32 rows [s1, b1', ...],
    permuted, pad entries zero; col_off (Wp//128 + 1,) and vlist (nnz,)
    int32 tile lists on x's device.  The kernel trusts the lists' contents
    (checking them would copy them to the host on every call): the fold
    builds them with ``sparse_tile_lists``.  When there are few rows it cuts
    the long lists into chunks (split-K); this wrapper then allocates the
    partials' scratch (f32 for both legs) the library asks for and zeroes
    its counters.  Returns (B, T, Wp) in x's dtype.
    """
    if x.device.type == "cpu":
        return sparse_graph_matmul_bn_relu_ref(x, m_tiles, vecs, col_off, vlist)
    if x.device.type != "cuda":
        raise ValueError(f"no sparse graph matmul kernel for device {x.device}")
    if x.dtype not in SPARSE_LEGS:
        raise TypeError(f"stgcn_sparse: x is {x.dtype}; the kernel takes float32 or bfloat16")
    name, entry = SPARSE_LEGS[x.dtype]
    B, T, Wp = x.shape
    if Wp % LANE:
        raise ValueError(f"merged width {Wp} is not a multiple of {LANE}")
    nnz = m_tiles.shape[0]
    kernels.check_operands(name, {"x": (x, (B, T, Wp)), "m_tiles": (m_tiles, (nnz, LANE, LANE))},
                           x.device, dtype=x.dtype)
    kernels.check_operands(name, {"vecs": (vecs, (N_VEC_ROWS, Wp))}, x.device)
    kernels.check_operands(name, {"col_off": (col_off, (Wp // LANE + 1,)), "vlist": (vlist, (nnz,))},
                           x.device, dtype=torch.int32)
    for what, t in (("x", x), ("m_tiles", m_tiles), ("vecs", vecs)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not 16-byte aligned (the kernel copies 16 bytes at a time)")
    out = torch.empty_like(x)
    lib = kernels.load("stgcn_sparse")
    # split-K scratch: the partials of the cut CSR lists and a zeroed counter per output tile
    scratch_fn = lib.p2r_stgcn_sparse_scratch
    scratch_fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    scratch_fn.restype = ctypes.c_int
    sizes = (ctypes.c_longlong * 2)()
    kernels.check(scratch_fn(B * T, Wp, nnz, sizes), name)
    partials = torch.empty(sizes[0], dtype=torch.float32, device=x.device) if sizes[0] else None
    counters = torch.zeros(sizes[1], dtype=torch.int32, device=x.device) if sizes[1] else None
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        x.data_ptr(), m_tiles.data_ptr(), vecs.data_ptr(), col_off.data_ptr(), vlist.data_ptr(),
        out.data_ptr(), None if partials is None else partials.data_ptr(),
        None if counters is None else counters.data_ptr(), B * T, Wp, nnz,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out
