"""The block-sparse eval chain of the port against the JAX package, on the
CPU: tile lists, the plain version of the sparse graph matmul kernel, the
sparse fold, the sparse backbone and the whole sparse ``generate`` at the
small shape and at production shape B=1."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose2room_tpu.data.dataset import load_demo_clip as jax_load_demo_clip
from pose2room_tpu.models import P2RNet as JaxP2RNet
from pose2room_tpu.models.graph import SPARSE_JOINT_ORDER as JAX_SPARSE_JOINT_ORDER
from pose2room_tpu.models.stgcn import STGCN as JaxSTGCN
from pose2room_tpu.ops import stgcn_sparse as jax_sparse
from pose2room_tpu_torch.data.dataset import load_demo_clip
from pose2room_tpu_torch.models.graph import SPARSE_JOINT_ORDER, build_spatial_graph
from pose2room_tpu_torch.ops import stgcn_sparse
from torch_golden import goldens  # noqa: F401  (a fixture)
from torch_port_util import (
    FULL,
    SMALL,
    assert_generate_close,
    jax_model,
    port_model,
    to_numpy,
    walking_clip,
)

V, C, Wp = 53, 64, 3456
PAD_SLOT = 36  # where the pad joint sits in SPARSE_JOINT_ORDER
ORDERS = {"natural": np.arange(54, dtype=np.int32), "annealed": SPARSE_JOINT_ORDER}
DEMO_CLIP = os.path.join(os.path.dirname(__file__), "..", "demo", "inputs", "input_joints_1.npy")


def _support():
    return (build_spatial_graph() != 0).any(0)


@pytest.fixture(scope="module")
def payload(goldens):
    return goldens.flax_payload(SMALL["num_gaussian"], seed=3)


def test_sparse_joint_order_matches_jax():
    np.testing.assert_array_equal(SPARSE_JOINT_ORDER, JAX_SPARSE_JOINT_ORDER)
    assert sorted(SPARSE_JOINT_ORDER.tolist()) == list(range(54))
    assert int(np.where(SPARSE_JOINT_ORDER == 53)[0][0]) == PAD_SLOT


@pytest.mark.parametrize("name,count", [("natural", 391), ("annealed", 279)])
def test_tile_lists_match_jax(name, count):
    sup = _support()
    assert sup.sum() == 971
    col_off, vlist = stgcn_sparse.sparse_tile_lists(sup, ORDERS[name])
    ref_col, ref_vl = jax_sparse.sparse_tile_lists(sup, ORDERS[name])
    np.testing.assert_array_equal(col_off, ref_col)
    np.testing.assert_array_equal(vlist, ref_vl)
    assert len(vlist) == count and col_off[-1] == count and col_off.shape == (28,)
    assert col_off.dtype == np.int32 and vlist.dtype == np.int32


def _operands(order, B, T, seed=0):
    """The operands of tests/test_stgcn_sparse.py:_operands: a random folded
    matrix on the support of A, permuted, its packed tiles, x and vecs with
    the pad slot zero."""
    rng = np.random.RandomState(seed)
    col_off, vlist = stgcn_sparse.sparse_tile_lists(_support(), order)
    s = np.zeros((54, 54), bool)
    s[:V, :V] = _support()
    M = rng.randn(54, C, 54, C).astype(np.float32) * 0.1
    M *= s[:, None, :, None]
    Mp = M[np.ix_(order, np.arange(C), order, np.arange(C))].reshape(Wp, Wp)
    pad = int(np.where(np.asarray(order) == 53)[0][0])
    x = (rng.randn(B, T, Wp) * 0.5).astype(np.float32)
    x[..., pad * C:(pad + 1) * C] = 0
    vecs = np.zeros((8, Wp), np.float32)
    vecs[0] = rng.rand(Wp) + 0.5
    vecs[1] = rng.randn(Wp)
    vecs[:, pad * C:(pad + 1) * C] = 0
    return x, Mp, vecs, col_off, vlist, pad


@pytest.mark.parametrize("B,T", [(2, 40), (1, 96)])
@pytest.mark.parametrize("name", ["natural", "annealed"])
def test_plain_version_matches_jax_kernel(name, B, T):
    """Kernel 5's plain version against the Pallas kernel in interpret mode.
    Both sum the same f32 products in another order (the plain version
    densifies the tiles and contracts all 3456 rows), so the band is 1e-5 of
    max|out|, a hundredth of the JAX test's own."""
    x, Mp, vecs, col_off, vlist, pad = _operands(ORDERS[name], B, T)
    tiles = stgcn_sparse.gather_m_tiles(torch.from_numpy(Mp), col_off, vlist)
    ref_tiles = np.asarray(jax_sparse.gather_m_tiles(Mp, col_off, vlist))
    np.testing.assert_array_equal(tiles.numpy(), ref_tiles)
    ref = np.asarray(jax_sparse.sparse_graph_matmul_bn_relu(
        jnp.asarray(x), jnp.asarray(ref_tiles), jnp.asarray(vecs), jnp.asarray(col_off),
        jnp.asarray(vlist), interpret=True))
    before = dict(stgcn_sparse.kernels.LAUNCHES)
    got = stgcn_sparse.sparse_graph_matmul_bn_relu(
        torch.from_numpy(x), tiles, torch.from_numpy(vecs), torch.from_numpy(col_off),
        torch.from_numpy(vlist)).numpy()
    assert dict(stgcn_sparse.kernels.LAUNCHES) == before  # CPU tensors: no launch
    assert got.shape == (B, T, Wp) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    assert np.all(got[..., pad * C:(pad + 1) * C] == 0)
    # densify is the exact inverse of gather
    dense = stgcn_sparse.densify_tiles(
        tiles, torch.from_numpy(vlist).long(),
        torch.from_numpy(stgcn_sparse.tile_columns(col_off)).long(), 27)
    np.testing.assert_array_equal(dense.numpy(), Mp)


def test_empty_output_tile_gets_bn_shift():
    """An output tile without entries writes relu(0 * s1 + b1)."""
    x, Mp, vecs, col_off, vlist, _ = _operands(SPARSE_JOINT_ORDER, 1, 8)
    keep = stgcn_sparse.tile_columns(col_off) != 5
    col_off = np.concatenate([[0], np.cumsum(np.bincount(stgcn_sparse.tile_columns(col_off)[keep],
                                                         minlength=27))]).astype(np.int32)
    tiles = stgcn_sparse.gather_m_tiles(torch.from_numpy(Mp), col_off, vlist[keep])
    assert col_off[6] == col_off[5]
    got = stgcn_sparse.sparse_graph_matmul_bn_relu(
        torch.from_numpy(x), tiles, torch.from_numpy(vecs), torch.from_numpy(col_off),
        torch.from_numpy(vlist[keep])).numpy()
    np.testing.assert_array_equal(got[..., 640:768], np.broadcast_to(np.maximum(vecs[1, 640:768], 0), (1, 8, 128)))


def test_fold_sparse_matches_jax(payload):
    """Per-block (tiles, vecs, KB) of the sparse fold against the JAX sparse
    fold on perturbed parameters, and against the port's dense fold."""
    jvars = {"params": payload["params"]["backbone"], "batch_stats": payload["batch_stats"]["backbone"]}
    ref = JaxSTGCN(n_seeds=64, num_frames=96, sparse_eval=True).apply(
        jvars, method=JaxSTGCN.fold_eval_operands)
    model = port_model(SMALL, payload, sparse_eval=True)
    folded = model.fold_eval()
    dense = port_model(SMALL, payload).fold_eval()
    assert len(ref) == 3 * len(folded["blocks"]) == 18
    col_off, vlist = stgcn_sparse.sparse_tile_lists(_support(), SPARSE_JOINT_ORDER)
    np.testing.assert_array_equal(folded["col_off"].numpy(), col_off)
    np.testing.assert_array_equal(folded["vlist"].numpy(), vlist)
    assert folded["col_off"].dtype == folded["vlist"].dtype == torch.int32
    expand = (SPARSE_JOINT_ORDER.astype(np.int64)[:, None] * C + np.arange(C)[None]).reshape(-1)
    valid = np.repeat(SPARSE_JOINT_ORDER < V, C)
    for i, (tiles, vecs, KB) in enumerate(folded["blocks"]):
        assert tiles.shape == (279, 128, 128) and vecs.shape == (8, Wp)
        np.testing.assert_allclose(tiles.numpy(), np.asarray(ref[3 * i]), atol=1e-6, rtol=0,
                                   err_msg=f"block {i} tiles")
        np.testing.assert_allclose(vecs.numpy(), np.asarray(ref[3 * i + 1]), atol=1e-6, rtol=0,
                                   err_msg=f"block {i} vecs")
        np.testing.assert_array_equal(KB.numpy(), np.asarray(ref[3 * i + 2]))
        assert np.all(vecs.numpy()[:, PAD_SLOT * C:(PAD_SLOT + 1) * C] == 0)
        # the tiles densify to the dense fold's matrix permuted on both axes
        M, dvecs, dKB = dense["blocks"][i]
        Mfull = np.zeros((54 * C, 54 * C), np.float32)
        Mfull[:V * C, :V * C] = M.numpy()[:V * C, :V * C]
        got = stgcn_sparse.densify_tiles(tiles, torch.from_numpy(vlist).long(),
                                         torch.from_numpy(stgcn_sparse.tile_columns(col_off)).long(), 27)
        np.testing.assert_allclose(got.numpy(), Mfull[np.ix_(expand, expand)], atol=1e-6, rtol=0)
        np.testing.assert_allclose(vecs.numpy()[:, valid], dvecs.numpy()[:, expand[valid]], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(KB.numpy(), dKB.numpy())
    cj, cj_bias = folded["conv_joint"]
    dense_cj = dense["conv_joint"][0].numpy()
    np.testing.assert_array_equal(cj.numpy()[valid], dense_cj[expand[valid]])
    assert np.all(cj.numpy()[~valid] == 0)
    np.testing.assert_array_equal(cj_bias.numpy(), dense["conv_joint"][1].numpy())


def test_sparse_generate_small_matches_jax(payload, goldens):
    """Whole sparse ``generate`` against the JAX package's sparse generate,
    and its seed features against the JAX sparse backbone and the port's
    dense chain within 2e-5 of their scale (tests/test_stgcn_sparse.py)."""
    x = walking_clip(np.random.RandomState(0), 2, SMALL["num_frames"])
    ref = goldens.jax_generate_small(sparse_eval=True)  # JAX's sparse generate on these weights and clips
    model = port_model(SMALL, payload, sparse_eval=True)
    got = to_numpy(model.generate(torch.from_numpy(x), folded=model.fold_eval()))
    assert_generate_close(got, ref)
    dense = to_numpy(port_model(SMALL, payload).generate(torch.from_numpy(x)))
    scale = np.abs(dense["seed_features"]).max()
    assert np.abs(got["seed_features"] - ref["seed_features"]).max() <= 2e-5 * scale
    assert np.abs(got["seed_features"] - dense["seed_features"]).max() <= 2e-5 * scale
    # the inline fold gives the same bits as the folded operands
    inline = to_numpy(model.generate(torch.from_numpy(x)))
    np.testing.assert_array_equal(inline["seed_features"], got["seed_features"])


def test_sparse_generate_production_shape_matches_jax(goldens):
    x = load_demo_clip(DEMO_CLIP, num_frames=768)[None]
    np.testing.assert_array_equal(x[0], jax_load_demo_clip(DEMO_CLIP, num_frames=768))
    payload = goldens.flax_payload(FULL["num_gaussian"], seed=5)
    jvars = {"params": payload["params"], "batch_stats": payload["batch_stats"]}
    ref = jax.tree_util.tree_map(
        np.asarray, jax_model(FULL, sparse_eval=True).apply(jvars, x, method=JaxP2RNet.generate))
    model = port_model(FULL, payload, sparse_eval=True)
    got = to_numpy(model.generate(torch.from_numpy(x), folded=model.fold_eval()))
    assert got["seed_inds"].shape == (1, 512) and got["center"].shape == (1, 128, 3)
    assert_generate_close(got, ref)
