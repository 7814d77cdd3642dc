"""The port's two kernels (ST-GCN epilogue, FPS) and the sampling ops against
the JAX package, on the CPU through their plain PyTorch versions.  The CUDA
kernels themselves are held against the plain versions in test_torch_gpu.py.

JAX's Pallas kernels run as the JAX package's own tests run them: in
interpret mode, or through their jnp references.  The FPS kernel's
selection order (keys, trees, reductions) is emulated in numpy against
fps_ref.  The last test checks that the kernel libraries' names hash the
csrc/ headers their sources include.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose2room_tpu.ops import sampling as jax_sampling
from pose2room_tpu.ops import stgcn_fused as jax_fused
from pose2room_tpu_torch import kernels
from pose2room_tpu_torch.ops import sampling, stgcn_fused
from torch_fps_clouds import FPS_KINDS, FPS_TIED_PAIRS, fps_cloud


def _layer_operands(rng, B, T, W0, C=64):
    """Fused-layer operands in the fold's layout: pad rows/cols of M and pad
    entries of vecs zero, KB block-diagonal with one (C, C) tap per joint."""
    Wp = stgcn_fused.pad_merged(W0)
    x = np.zeros((B, T, Wp), np.float32)
    x[..., :W0] = np.maximum(rng.randn(B, T, W0), 0)
    M = np.zeros((Wp, Wp), np.float32)
    M[:W0, :W0] = rng.randn(W0, W0) * 0.05
    vecs = np.zeros((8, Wp), np.float32)
    vecs[0, :W0] = rng.uniform(0.5, 1.5, W0)
    vecs[1:4, :W0] = rng.randn(3, W0) * 0.1
    vecs[2, :W0] += 1.0
    taps = rng.randn(3, C, C).astype(np.float32) * 0.1
    KB = np.einsum("sio,pq->spiqo", taps, np.eye(128 // C, dtype=np.float32)).reshape(3, 128, 128)
    return x, M, vecs, KB


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("W0", [256, 192])
def test_epilogue_plain_matches_jax(rng, residual, W0):
    x, M, vecs, KB = _layer_operands(rng, 2, 24, W0)
    t1 = np.array(jax_fused._graph_matmul_bn_relu(x, M, vecs[0], vecs[1]))
    ref = np.asarray(jax_fused.epilogue_merged_ref(
        t1, x if residual else None, vecs, KB, residual=residual))
    kern = np.asarray(jax_fused.fused_epilogue(
        t1, x if residual else None, vecs, KB, residual=residual, interpret=True))
    got = stgcn_fused.fused_epilogue(
        torch.from_numpy(t1), torch.from_numpy(x) if residual else None,
        torch.from_numpy(vecs), torch.from_numpy(KB), residual=residual,
    ).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, kern, atol=1e-5, rtol=1e-5)
    assert np.all(got[..., W0:] == 0)


@pytest.mark.parametrize("residual", [True, False])
def test_fused_layer_matches_jax_interpret(rng, residual):
    x, M, vecs, KB = _layer_operands(rng, 2, 16, 192)
    ref = np.asarray(jax_fused.fused_stgcn_layer(
        jnp.asarray(x), M, vecs, KB, residual=residual, interpret=True))
    got = stgcn_fused.fused_stgcn_layer(
        torch.from_numpy(x), torch.from_numpy(M), torch.from_numpy(vecs),
        torch.from_numpy(KB), residual=residual,
    ).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        got,
        stgcn_fused.stgcn_layer_merged_ref(
            torch.from_numpy(x), torch.from_numpy(M), torch.from_numpy(vecs),
            torch.from_numpy(KB), residual=residual,
        ).numpy(),
        atol=0, rtol=0,
    )
    assert np.all(got[..., 192:] == 0)


def test_first_block_unpadded_input(rng):
    """Block 0 contracts the unpadded 3-joint merged input against M[:W0]."""
    W0 = 192
    x, M, vecs, KB = _layer_operands(rng, 1, 16, W0)
    ref = np.asarray(jax_fused.fused_stgcn_layer(
        jnp.asarray(x[..., :W0]), M, vecs, KB, residual=False, interpret=True))
    got = stgcn_fused.fused_stgcn_layer(
        torch.from_numpy(np.ascontiguousarray(x[..., :W0])), torch.from_numpy(M),
        torch.from_numpy(vecs), torch.from_numpy(KB), residual=False,
    ).numpy()
    assert got.shape == (1, 16, 256)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    assert np.all(got[..., W0:] == 0)
    with pytest.raises(ValueError):
        stgcn_fused.fused_stgcn_layer(
            torch.from_numpy(np.ascontiguousarray(x[..., :W0])), torch.from_numpy(M),
            torch.from_numpy(vecs), torch.from_numpy(KB), residual=True,
        )


@pytest.mark.parametrize("kind,N", [pytest.param(kind, 64, id=kind) for kind in FPS_KINDS]
                         + [pytest.param(kind, 50, id=f"{kind}-N50") for kind in FPS_KINDS])
def test_fps_bit_exact_vs_jax(kind, N):
    """fps_ref against JAX on the clouds of the card test's (3, 64, 16) and
    (3, 50, 16) cases, so the kernel, its plain version and JAX agree."""
    xyz = fps_cloud(kind, 3, N, seed=N + 3)
    got = sampling.furthest_point_sample(torch.from_numpy(xyz), 16).numpy()
    assert got.dtype == np.int32 and got.shape == (3, 16)
    np.testing.assert_array_equal(got, np.asarray(jax_sampling._fps_xla(jnp.asarray(xyz), 16)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_sampling._fps_pallas(jnp.asarray(xyz), 16, interpret=True))
    )
    if kind == "all_invalid":
        assert np.all(got == 0)
    if kind == "one_valid":
        assert np.all(got[:, 1:] == N // 2)
    if kind == "cross_lane_ties":  # each tied pair present resolves to its lower index
        picked = set(got[0].tolist())
        for lo, hi in FPS_TIED_PAIRS:
            if hi < N:
                assert lo in picked and hi not in picked


def _fps_kernel_order(xyz, npoint, warps, per):
    """csrc/fps.cu's selection in numpy: kPer points a lane in the blocked
    layout, scores as the signed-int bits of the running min (-1 for a point
    that is never a candidate or lies past N), the lane's tree argmax, the
    warp's max key then its least index holding it (the two redux.sync
    steps), then the warps' slots in order with a strict '>'."""
    B, N, _ = xyz.shape
    P = warps * 32 * per
    pts = np.zeros((B, P, 3), np.float32)
    pts[:, :N] = xyz
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    n2 = (x * x + y * y) + z * z
    mind = np.where((np.arange(P) < N) & (n2 > np.float32(1e-3)), np.float32(1e10), np.float32(-1))
    out = np.zeros((B, npoint), np.int32)
    for b in range(B):
        old = 0
        for j in range(1, npoint):
            dx, dy, dz = x[b] - x[b, old], y[b] - y[b, old], z[b] - z[b, old]
            mind[b] = np.fmin(mind[b], (dx * dx + dy * dy) + dz * dz)
            key = mind[b].view(np.int32).reshape(warps * 32, per).copy()
            at = np.broadcast_to(np.arange(per), key.shape).copy()
            s = 1
            while s < per:
                for m in range(0, per, 2 * s):
                    take = key[:, m + s] > key[:, m]
                    key[:, m] = np.where(take, key[:, m + s], key[:, m])
                    at[:, m] = np.where(take, at[:, m + s], at[:, m])
                s *= 2
            lane_key = key[:, 0].reshape(warps, 32)
            lane_idx = (np.arange(warps * 32) * per + at[:, 0]).reshape(warps, 32)
            best = lane_key.max(axis=1)
            idx = np.where(lane_key == best[:, None], lane_idx, np.iinfo(np.int32).max).min(axis=1)
            w = 0
            for v in range(1, warps):
                if best[v] > best[w]:
                    w = v
            old = out[b, j] = idx[w]
    return out


@pytest.mark.parametrize("warps,per,N", [(4, 4, 500), (4, 8, 1000), (8, 8, 2048), (1, 16, 512)])
@pytest.mark.parametrize("kind", FPS_KINDS)
def test_fps_kernel_order_emulated(kind, warps, per, N):
    """The kernel's keys, trees and reductions, emulated for each layout it
    launches (and the one-warp layout of scripts/torch_fps_variants.py's
    variant a), pick the same indices as fps_ref: the signed-int order of
    the scores' bits and the lowest index on ties."""
    xyz = fps_cloud(kind, 2, N, seed=N + 2)
    want = sampling.fps_ref(torch.from_numpy(xyz), 24).numpy()
    np.testing.assert_array_equal(_fps_kernel_order(xyz, 24, warps, per), want)


def test_fps_production_shape_matches_jax(rng):
    xyz = (rng.randn(2, 512, 3) * 1.5).astype(np.float32)
    xyz[:, 10:40] *= 1e-3
    got = sampling.furthest_point_sample(torch.from_numpy(xyz), 128).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_sampling._fps_xla(jnp.asarray(xyz), 128)))


def test_ball_query_gather_group_exact(rng):
    xyz = (rng.rand(2, 128, 3) * 2 - 1).astype(np.float32)
    centers = np.ascontiguousarray(xyz[:, ::8])
    centers[:, 0] = 50.0  # an empty ball -> all index 0
    for radius, ns in ((0.3, 16), (0.05, 8), (2.0, 4)):
        got = sampling.ball_query(radius, torch.from_numpy(centers), torch.from_numpy(xyz), ns)
        ref = np.asarray(jax_sampling.ball_query(radius, jnp.asarray(centers), jnp.asarray(xyz), ns))
        np.testing.assert_array_equal(got.numpy(), ref)
    assert np.all(got.numpy()[:, 0] == 0)
    feats = rng.randn(2, 128, 7).astype(np.float32)
    idx = rng.randint(0, 128, (2, 16)).astype(np.int32)
    np.testing.assert_array_equal(
        sampling.gather_points(torch.from_numpy(feats), torch.from_numpy(idx)).numpy(),
        np.asarray(jax_sampling.gather_points(jnp.asarray(feats), jnp.asarray(idx))),
    )
    ball = got.numpy()
    np.testing.assert_array_equal(
        sampling.group_points(torch.from_numpy(feats), got).numpy(),
        np.asarray(jax_sampling.group_points(jnp.asarray(feats), jnp.asarray(ball))),
    )


def test_cpu_wrappers_never_count_launches(rng):
    kernels.reset_launch_counts()
    x, M, vecs, KB = _layer_operands(rng, 1, 8, 256)
    stgcn_fused.fused_stgcn_layer(*(torch.from_numpy(a) for a in (x, M, vecs, KB)), residual=True)
    sampling.furthest_point_sample(torch.from_numpy(fps_cloud("random", 1, 32, seed=0)), 4)
    assert sum(kernels.LAUNCHES.values()) == 0


def test_library_name_hashes_included_headers(tmp_path, monkeypatch):
    """Editing csrc/tconv_mma.cuh rebuilds exactly the kernels that include
    it, directly or through csrc/tconv_bf16.cuh or csrc/wgmma_tf32.cuh;
    editing tconv_bf16.cuh exactly the four with a bf16 leg; editing
    wgmma_bf16.cuh kernel 5, whose bf16 leg runs on wgmma, and the graph
    GEMM, whose wgmma_tf32.cuh takes its TMA loads and barriers; editing
    wgmma_tf32.cuh only the graph GEMM."""
    src = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, src)
    monkeypatch.setattr(kernels, "CSRC", str(src))
    both = ["tconv_bf16.cuh", "tconv_mma.cuh"]
    assert kernels._source_files("stgcn_epilogue") == ["stgcn_epilogue.cu", *both]
    assert kernels._source_files("stgcn_train_fwd") == ["stgcn_train_fwd.cu", *both]
    assert kernels._source_files("stgcn_train_bwd") == ["stgcn_train_bwd.cu", *both]
    assert kernels._source_files("stgcn_sparse") == ["stgcn_sparse.cu", *both, "wgmma_bf16.cuh"]
    assert kernels._source_files("fps") == ["fps.cu"]
    assert kernels._source_files("stgcn_graph_gemm") == [
        "stgcn_graph_gemm.cu", "wgmma_tf32.cuh", "tconv_mma.cuh", "wgmma_bf16.cuh"]
    tensor_core = {"stgcn_epilogue", "stgcn_train_fwd", "stgcn_train_bwd", "stgcn_sparse"}
    for edited, rebuilt in (("tconv_mma.cuh", tensor_core | {"stgcn_graph_gemm"}), ("tconv_bf16.cuh", tensor_core),
                            ("wgmma_bf16.cuh", {"stgcn_sparse", "stgcn_graph_gemm"}),
                            ("wgmma_tf32.cuh", {"stgcn_graph_gemm"})):
        before = {name: kernels._lib_path(name) for name in kernels.SOURCES}
        header = src / edited
        header.write_text(header.read_text() + "\n// edited\n")
        after = {name: kernels._lib_path(name) for name in kernels.SOURCES}
        assert {name for name in kernels.SOURCES if after[name] != before[name]} == rebuilt
