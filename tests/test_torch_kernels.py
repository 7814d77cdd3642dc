"""The port's two kernels (ST-GCN epilogue, FPS) and the sampling ops against
the JAX package, on the CPU through their plain PyTorch versions.  The CUDA
kernels themselves are held against the plain versions in test_torch_gpu.py.

JAX's Pallas kernels run as the JAX package's own tests run them: in
interpret mode, or through their jnp references.  The last test checks that
the kernel libraries' names hash the csrc/ headers their sources include.
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


def _fps_cloud(rng, B, N, kind):
    xyz = (rng.rand(B, N, 3) * 4 - 2).astype(np.float32)
    if kind == "near_origin":
        xyz[:, 1:N // 4] *= 1e-3  # ||p||^2 <= 1e-3: never candidates
    elif kind == "ties":
        xyz[:, N // 2:] = xyz[:, : N - N // 2]  # every point duplicated
        xyz[:, 5] = xyz[:, 9]
    elif kind == "all_invalid":
        xyz *= 1e-4
    elif kind == "grid":  # exact equal distances everywhere
        g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3)
        xyz = np.broadcast_to(g[: N].astype(np.float32) - 1.5, (B, N, 3)).copy()
    return xyz


@pytest.mark.parametrize("kind", ["random", "near_origin", "ties", "all_invalid", "grid"])
def test_fps_bit_exact_vs_jax(rng, kind):
    N = 64
    xyz = _fps_cloud(rng, 3, N, kind)
    got = sampling.furthest_point_sample(torch.from_numpy(xyz), 16).numpy()
    assert got.dtype == np.int32 and got.shape == (3, 16)
    np.testing.assert_array_equal(got, np.asarray(jax_sampling._fps_xla(jnp.asarray(xyz), 16)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_sampling._fps_pallas(jnp.asarray(xyz), 16, interpret=True))
    )
    if kind == "all_invalid":
        assert np.all(got == 0)


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
    sampling.furthest_point_sample(torch.from_numpy(_fps_cloud(rng, 1, 32, "random")), 4)
    assert sum(kernels.LAUNCHES.values()) == 0


def test_library_name_hashes_included_headers(tmp_path, monkeypatch):
    """Editing csrc/tconv_mma.cuh rebuilds exactly the kernels that include
    it, directly or through csrc/tconv_bf16.cuh; editing tconv_bf16.cuh
    exactly the four with a bf16 leg; editing wgmma_bf16.cuh only kernel 5,
    whose bf16 leg runs on wgmma."""
    src = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, src)
    monkeypatch.setattr(kernels, "CSRC", str(src))
    both = ["tconv_bf16.cuh", "tconv_mma.cuh"]
    assert kernels._source_files("stgcn_epilogue") == ["stgcn_epilogue.cu", *both]
    assert kernels._source_files("stgcn_train_fwd") == ["stgcn_train_fwd.cu", *both]
    assert kernels._source_files("stgcn_train_bwd") == ["stgcn_train_bwd.cu", *both]
    assert kernels._source_files("stgcn_sparse") == ["stgcn_sparse.cu", *both, "wgmma_bf16.cuh"]
    assert kernels._source_files("fps") == ["fps.cu"]
    tensor_core = {"stgcn_epilogue", "stgcn_train_fwd", "stgcn_train_bwd", "stgcn_sparse"}
    for edited, rebuilt in (("tconv_mma.cuh", tensor_core), ("tconv_bf16.cuh", tensor_core),
                            ("wgmma_bf16.cuh", {"stgcn_sparse"})):
        before = {name: kernels._lib_path(name) for name in kernels.SOURCES}
        header = src / edited
        header.write_text(header.read_text() + "\n// edited\n")
        after = {name: kernels._lib_path(name) for name in kernels.SOURCES}
        assert {name for name in kernels.SOURCES if after[name] != before[name]} == rebuilt
