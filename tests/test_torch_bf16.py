"""bf16 eval (``model.compute_dtype: bfloat16``) of the port against the JAX
package's bf16 path, on the CPU, at the small shape (T=96, 64 seeds, 16
proposals, 10 gaussians) with the same seeded weights and inputs.

The port keeps f32 parameters and casts where flax does; its kernels' plain
versions (the path a CPU tensor takes) accumulate bf16 products in f32 and
round once.  f32 sums taken in another order than XLA's flip about 1e-5 to
1e-4 of the bf16 roundings, so the ops and the chain are held within 1 bf16
ulp or within bands no looser than the JAX package's own bf16 tests; the
folds and flax's Dense + bias are held bit for bit.
"""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from pose2room_tpu.models import P2RNet as JaxP2RNet
from pose2room_tpu.models.layers import MLP1x1 as JaxMLP1x1
from pose2room_tpu.models.stgcn import STGCN as JaxSTGCN
from pose2room_tpu.ops import stgcn_fused as jax_fused
from pose2room_tpu.ops import stgcn_sparse as jax_sparse
from pose2room_tpu_torch.config.loader import CONFIG
from pose2room_tpu_torch.data import synth
from pose2room_tpu_torch.data.dataset import SceneDataset
from pose2room_tpu_torch.models.graph import SPARSE_JOINT_ORDER, build_spatial_graph
from pose2room_tpu_torch.models.layers import MLP1x1
from pose2room_tpu_torch.ops import stgcn_fused, stgcn_sparse
from pose2room_tpu_torch.runners import test as test_runner
from torch_port_util import SMALL, f32, flax_payload, jax_model, ordinal, port_model, ulps, walking_clip

TEST_YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "configs", "config_files", "p2rnet_test.yaml")
BF16 = torch.bfloat16
VARIANTS = {"dense": dict(), "sparse": dict(sparse_eval=True), "module": dict(fused_eval=False)}


@pytest.fixture(scope="module")
def payload():
    return flax_payload(SMALL["num_gaussian"], seed=3)


@pytest.fixture(scope="module")
def variables(payload):
    return {"params": payload["params"], "batch_stats": payload["batch_stats"]}


@pytest.fixture(scope="module")
def clip():
    # FPS over the bf16-rounded votes meets near ties: a one-ulp flip of a
    # vote offset reselects proposals.  Over clips 0-7, wherever the port's
    # proposals differ from the JAX package's jit or eager run, those two
    # runs differ from each other too (scripts/torch_bf16_vs_jax.py).  On
    # this seeded clip all three chains give JAX's proposals.
    return walking_clip(np.random.RandomState(2), 2, SMALL["num_frames"])


@pytest.fixture(scope="module")
def jax_generate(variables, clip):
    """The JAX package's bf16 generate (jit) for each variant, on ``clip``."""
    out = {}
    for name, kw in VARIANTS.items():
        model = jax_model(SMALL, compute_dtype="bfloat16", **kw)
        fn = jax.jit(lambda v, x, m=model: m.apply(v, x, method=JaxP2RNet.generate))
        out[name] = jax.tree_util.tree_map(np.asarray, fn(variables, clip))
    return out


def _fused_operands(rng, B=2, T=24, Wp=256):
    x = np.maximum(rng.randn(B, T, Wp), 0).astype(np.float32)
    M = (rng.randn(Wp, Wp) * 0.05).astype(np.float32)
    vecs = np.zeros((8, Wp), np.float32)
    vecs[:4] = rng.randn(4, Wp) * 0.1
    vecs[0] += 1.0
    vecs[2] += 1.0
    taps = (rng.randn(3, 64, 64) * 0.1).astype(np.float32)
    KB = np.einsum("sio,pq->spiqo", taps, np.eye(2, dtype=np.float32)).reshape(3, 128, 128)
    return x, M, vecs, KB


@pytest.mark.parametrize("variant", ["dense", "sparse"])
def test_fold_operands_bit_equal_jax(payload, variant):
    """M (or the packed tiles) and KB in bf16 equal JAX's fold_eval_arrays
    [_sparse] bit for bit: both fold in f32 and cast once.  vecs stay f32
    (within 1e-6, as the f32 fold test)."""
    kw = VARIANTS[variant]
    jvars = {"params": payload["params"]["backbone"], "batch_stats": payload["batch_stats"]["backbone"]}
    ref = JaxSTGCN(n_seeds=SMALL["num_seeds"], num_frames=SMALL["num_frames"], dtype=jnp.bfloat16,
                   **kw).apply(jvars, method=JaxSTGCN.fold_eval_operands)
    folded = port_model(SMALL, payload, compute_dtype="bfloat16", **kw).fold_eval()
    assert len(ref) == 3 * len(folded["blocks"]) == 18
    for i, (M, vecs, KB) in enumerate(folded["blocks"]):
        assert M.dtype == KB.dtype == BF16 and vecs.dtype == torch.float32
        assert ref[3 * i].dtype == ref[3 * i + 2].dtype == jnp.bfloat16
        np.testing.assert_array_equal(f32(M), np.asarray(ref[3 * i], np.float32), err_msg=f"block {i} M")
        np.testing.assert_array_equal(f32(KB), np.asarray(ref[3 * i + 2], np.float32), err_msg=f"block {i} KB")
        np.testing.assert_allclose(vecs.numpy(), np.asarray(ref[3 * i + 1]), atol=1e-6, rtol=0)


def test_graph_matmul_rounds_accumulator_once():
    """The bf16 producer of t1 keeps the f32 accumulator through BN1 and
    ReLU and casts once: equal to relu(f32(x @ M) * s1 + b1) cast to bf16
    (exact products, f64 sum rounded to f32) and to JAX's
    _graph_matmul_bn_relu within 1 bf16 ulp wherever |t1| is above 1e-3 of
    its max; the bf16 accumulator (``torch.matmul`` on bf16) moves many
    elements by more."""
    x, M, vecs, _ = _fused_operands(np.random.RandomState(0), Wp=384)
    xb, Mb = torch.from_numpy(x).to(BF16), torch.from_numpy(M).to(BF16)
    s1, b1 = torch.from_numpy(vecs[0]), torch.from_numpy(vecs[1])
    got = stgcn_fused.graph_matmul_bn_relu(xb, Mb, s1, b1)
    assert got.dtype == BF16
    acc = torch.matmul(xb.double(), Mb.double()).float()
    want = torch.relu(acc * s1 + b1).to(BF16)
    jax_t1 = jax_fused._graph_matmul_bn_relu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(M, jnp.bfloat16),
                                             jnp.asarray(vecs[0]), jnp.asarray(vecs[1]))
    rounded_first = torch.relu(torch.matmul(xb, Mb).float() * s1 + b1).to(BF16)
    live = f32(want) > 1e-3 * f32(want).max()
    assert ulps(f32(got)[live], f32(want)[live]) <= 1
    assert ulps(f32(got)[live], np.asarray(jax_t1, np.float32)[live]) <= 1
    assert (np.abs(ordinal(f32(rounded_first)) - ordinal(f32(want)))[live] > 1).sum() > 0


@pytest.mark.parametrize("residual", [True, False])
def test_epilogue_ref_matches_jax(residual):
    """The bf16 plain version of kernel 1 against JAX epilogue_merged_ref in
    bf16: within the JAX band (test_stgcn_fused.py:66, 2e-2) and within 1
    bf16 ulp wherever the output is above 1e-3 of its max."""
    x, _, vecs, KB = _fused_operands(np.random.RandomState(1))
    t1 = np.maximum(x * 0.8 - 0.2, 0)
    tb, xb, KBb = (torch.from_numpy(a).to(BF16) for a in (t1, x, KB))
    got = stgcn_fused.epilogue_merged_ref(tb, xb if residual else None, torch.from_numpy(vecs), KBb,
                                          residual=residual)
    j = {k: jnp.asarray(a, jnp.bfloat16) for k, a in (("t1", t1), ("x", x), ("KB", KB))}
    ref = jax_fused.epilogue_merged_ref(j["t1"], j["x"] if residual else None, jnp.asarray(vecs), j["KB"],
                                        residual=residual)
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    g, r = f32(got), np.asarray(ref, np.float32)
    np.testing.assert_allclose(g, r, atol=2e-2, rtol=2e-2)
    live = r > 1e-3 * r.max()
    assert ulps(g[live], r[live]) <= 1


def test_sparse_ref_matches_jax():
    """The bf16 plain version of kernel 5 against JAX
    sparse_graph_matmul_bn_relu_ref in bf16: within the JAX band
    (test_stgcn_sparse.py:93, 5e-2 of max) and within 1 bf16 ulp wherever
    the output is above 1e-3 of its max; the pad slot exactly 0."""
    rng = np.random.RandomState(2)
    order = SPARSE_JOINT_ORDER
    support = (build_spatial_graph() != 0).any(0)
    col_off, vlist = stgcn_sparse.sparse_tile_lists(support, order)
    sup = np.zeros((54, 54), bool)
    sup[:53, :53] = support
    M = (rng.randn(54, 64, 54, 64) * 0.02 * sup[:, None, :, None]).astype(np.float32)
    Mp = M[order][:, :, order].reshape(3456, 3456)
    pad = int(np.where(order == 53)[0][0])
    x = np.maximum(rng.randn(2, 16, 3456), 0).astype(np.float32)
    vecs = np.zeros((8, 3456), np.float32)
    vecs[0], vecs[1] = rng.rand(3456) + 0.5, rng.randn(3456) * 0.3
    for a in (x, vecs):
        a[..., pad * 64:(pad + 1) * 64] = 0
    tiles = stgcn_sparse.gather_m_tiles(torch.from_numpy(Mp), col_off, vlist).to(BF16)
    got = stgcn_sparse.sparse_graph_matmul_bn_relu_ref(torch.from_numpy(x).to(BF16), tiles,
                                                       torch.from_numpy(vecs), col_off, vlist)
    ref = jax_sparse.sparse_graph_matmul_bn_relu_ref(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(f32(tiles), jnp.bfloat16), jnp.asarray(vecs), col_off, vlist)
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    g, r = f32(got), np.asarray(ref, np.float32)
    np.testing.assert_allclose(g, r, atol=5e-2 * np.abs(r).max())
    live = r > 1e-3 * r.max()
    assert ulps(g[live], r[live]) <= 1
    assert np.all(g[..., pad * 64:(pad + 1) * 64] == 0)


@pytest.mark.parametrize("in_dim,features", [(3, (64, 64, 64)), (256, (128, 128, 24))])
def test_mlp1x1_bit_equal_flax(in_dim, features):
    """MLP1x1 with dtype bf16 and a plain last layer (pos_embed / sk_feat,
    conv_sem_obj) equals flax's bit for bit: each Dense rounds its product
    to bf16 and then adds the bf16 bias with a second rounding; BatchNorm and
    ReLU run in f32 between them."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 40, in_dim).astype(np.float32)
    flax_mlp = JaxMLP1x1(list(features), dtype=jnp.bfloat16)
    v = flax_mlp.init(jax.random.PRNGKey(0), x)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.uniform(0.05, 0.3, a.shape).astype(np.float32), v)
    want = flax_mlp.apply(v, x)
    port = MLP1x1(in_dim, list(features), dtype=BF16).eval()
    with torch.no_grad():
        for i, layer in enumerate(port):
            p = v["params"][f"dense{i}"]
            layer.conv.weight.copy_(torch.from_numpy(p["kernel"].T.copy()))
            if layer.conv.bias is not None:
                layer.conv.bias.copy_(torch.from_numpy(p["bias"]))
            if layer.batchnorm is not None:
                bn, st = v["params"][f"bn{i}"], v["batch_stats"][f"bn{i}"]
                for name, val in (("weight", bn["scale"]), ("bias", bn["bias"]),
                                  ("running_mean", st["mean"]), ("running_var", st["var"])):
                    getattr(layer.batchnorm, name).copy_(torch.from_numpy(val))
        got = port(torch.from_numpy(x))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(f32(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("variant", ["dense", "sparse", "module"])
def test_backbone_matches_jax(payload, clip, variant):
    """STGCN in bf16 against JAX: seed indices equal, seed features within
    the JAX band (test_stgcn_sparse.py:191, 0.05 of max) and within 1e-2 of
    max (two bf16 ulps at the max)."""
    kw = VARIANTS[variant]
    jvars = {"params": payload["params"]["backbone"], "batch_stats": payload["batch_stats"]["backbone"]}
    jm = JaxSTGCN(n_seeds=SMALL["num_seeds"], num_frames=SMALL["num_frames"], dtype=jnp.bfloat16, **kw)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(jvars, clip)
    model = port_model(SMALL, payload, compute_dtype="bfloat16", **kw)
    got = model.backbone(torch.from_numpy(clip), folded=model.fold_eval())
    np.testing.assert_array_equal(got["seed_inds"].numpy(), np.asarray(ref["seed_inds"]))
    g, r = f32(got["seed_features"]), np.asarray(ref["seed_features"], np.float32)
    scale = np.abs(r).max()
    assert np.abs(g - r).max() <= 0.05 * scale
    assert np.abs(g - r).max() <= 1e-2 * scale


@pytest.mark.parametrize("variant", ["dense", "sparse", "module"])
def test_generate_matches_jax(payload, clip, jax_generate, variant):
    """bf16 generate against the JAX package's: seed and proposal indices
    equal on the seeded clip; seed features within 1e-2 of their max and
    every other float output within 0.05 of its max (the JAX package's bf16
    backbone band, test_stgcn_sparse.py:191: the heading is a pi-weighted
    sum of unit vectors that cancels to ~7% of its terms); the logits bf16
    as in JAX."""
    ref = jax_generate[variant]
    model = port_model(SMALL, payload, compute_dtype="bfloat16", **VARIANTS[variant])
    got = model.generate(torch.from_numpy(clip), folded=model.fold_eval())
    np.testing.assert_array_equal(got["seed_inds"].numpy(), ref["seed_inds"])
    np.testing.assert_array_equal(got["aggregated_vote_inds"].numpy(), ref["aggregated_vote_inds"])
    for key in ("objectness_scores", "sem_cls_scores"):
        assert got[key].dtype == BF16 and ref[key].dtype == jnp.bfloat16
    pairs = {k: (got[k], ref[k]) for k in ("seed_features", "vote_xyz", "vote_features", "aggregated_vote_xyz",
                                           "center", "size", "heading", "objectness_scores", "sem_cls_scores")}
    pairs.update({f"pi/{k}": (got["pi"][k], ref["pi"][k]) for k in ("center", "size", "heading")})
    for key, (g, r) in pairs.items():
        g, r = f32(g), np.asarray(r, np.float32)
        band = 1e-2 if key == "seed_features" else 0.05
        assert np.abs(g - r).max() <= band * np.abs(r).max(), key


def test_test_runner_bf16_sparse_on_cpu(tmp_path):
    """bf16 flows from the YAML through generate, parse, loss and AP: the
    sparse_eval test runner on in-memory synthetic scenes gives finite
    metrics, with the bf16 logits widened on the host."""
    config = yaml.safe_load(open(TEST_YAML))
    config["data"].update(num_frames=SMALL["num_frames"], num_seeds=SMALL["num_seeds"],
                          num_target=SMALL["num_proposals"], num_gaussian=SMALL["num_gaussian"])
    config["model"].update(compute_dtype="bfloat16", sparse_eval=True)
    config["test"].update(batch_size=2, remove_far_box=False)
    config.update(finetune=False, seed=42, device={"num_workers": 0},
                  log={**config["log"], "path": str(tmp_path / "out")})
    rng = np.random.RandomState(5)
    scenes = [synth.as_stored(*synth.make_scene(rng, n_objects=3, n_frames=120)) for _ in range(2)]
    cfg = CONFIG(config, mode="test")
    try:
        metrics = test_runner.run(cfg, device="cpu", dataset=SceneDataset(scenes, num_frames=SMALL["num_frames"]))
        losses = cfg.test_summary["mean_losses"]
    finally:
        cfg.close()
    assert metrics
    for m in metrics.values():
        assert np.isfinite(m["mAP"]) and np.isfinite(m["AR"])
    assert all(np.isfinite(v) for v in losses.values())
