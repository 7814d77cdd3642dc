"""Port modules against the JAX package at the small shape (T=96, 64 seeds,
16 proposals, 10 gaussians): graph, fold, weight bridge, backbone, votes and
the whole ``generate``, on the CPU with the same seeded weights and inputs."""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from pose2room_tpu.convert import export_to_reference_state_dict
from pose2room_tpu.models import P2RNet as JaxP2RNet
from pose2room_tpu.models.graph import build_spatial_graph as jax_build_spatial_graph
from pose2room_tpu.models.stgcn import STGCN as JaxSTGCN
from pose2room_tpu_torch.config.loader import CONFIG
from pose2room_tpu_torch.convert import load_reference_state_dict, state_dict_from_flax
from pose2room_tpu_torch.data import synth
from pose2room_tpu_torch.data.dataset import SceneDataset
from pose2room_tpu_torch.models.graph import build_spatial_graph
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
from pose2room_tpu_torch.models.stgcn import blocked_cumsum
from pose2room_tpu_torch.runners import train as train_runner
from torch_golden import goldens  # noqa: F401  (a fixture)
from torch_port_util import (
    SMALL,
    assert_generate_close,
    flax_payload,
    jax_model,
    port_model,
    to_numpy,
    walking_clip,
)

TRAIN_YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "config_files", "p2rnet_train.yaml")


@pytest.fixture(scope="module")
def payload(goldens):
    return goldens.flax_payload(SMALL["num_gaussian"], seed=3)


@pytest.fixture(scope="module")
def port(payload):
    return port_model(SMALL, payload)


@pytest.fixture(scope="module")
def jax_variables(payload):
    return {"params": payload["params"], "batch_stats": payload["batch_stats"]}


@pytest.mark.parametrize("max_hop", [1, 5])
def test_graph_bit_equal(max_hop):
    A = build_spatial_graph(53, max_hop=max_hop)
    assert A.shape == (1 + 2 * max_hop, 53, 53) and A.dtype == np.float32
    np.testing.assert_array_equal(A, jax_build_spatial_graph(53, max_hop=max_hop))


def test_converter_bit_exact(payload, port):
    """state_dict_from_flax == the JAX package's exporter, key for key."""
    ours = state_dict_from_flax(payload)
    template = {k: v.numpy() for k, v in port.state_dict().items()}
    ref = export_to_reference_state_dict(payload, template)
    assert set(ours) == set(ref) == set(template)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_reference_checkpoint_layout_loads(payload):
    """A reference checkpoint ('module.' prefixes, (out,in,1[,1]) 1x1 conv
    weights, A and num_batches_tracked buffers) loads with strict keys."""
    sd = state_dict_from_flax(payload)
    ckpt = {}
    for k, v in sd.items():
        if v.dim() == 2 and not k.endswith((".mdn.mu", ".mdn.log_sigma")):
            v = v[..., None, None] if "backbone" in k else v[..., None]
        ckpt[f"module.{k}"] = v
    ckpt["module.backbone.A"] = torch.zeros(11, 53, 53)
    ckpt["module.backbone.pos_embed.0.batchnorm.num_batches_tracked"] = torch.tensor(3)
    model = load_reference_state_dict(P2RNet(P2RNetConfig(**SMALL), device="cpu"), ckpt)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_fold_matches_jax(payload, port):
    """fold_eval_arrays (M, vecs, KB) per block within 1e-6; KB block-diagonal."""
    jax_stgcn = JaxSTGCN(n_seeds=64, num_frames=96)
    jvars = {"params": payload["params"]["backbone"], "batch_stats": payload["batch_stats"]["backbone"]}
    ref = jax_stgcn.apply(jvars, method=JaxSTGCN.fold_eval_operands)
    folded = port.fold_eval()
    assert len(ref) == 3 * len(folded["blocks"]) == 18
    for i, (M, vecs, KB) in enumerate(folded["blocks"]):
        for name, got, want in (("M", M, ref[3 * i]), ("vecs", vecs, ref[3 * i + 1]),
                                ("KB", KB, ref[3 * i + 2])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0,
                                       err_msg=f"block {i} {name}")
        kb = KB.numpy().reshape(3, 2, 64, 2, 64)
        assert np.all(kb[:, 0, :, 1] == 0) and np.all(kb[:, 1, :, 0] == 0)
        np.testing.assert_array_equal(kb[:, 0, :, 0], kb[:, 1, :, 1])
        assert np.all(M.numpy()[3392:] == 0) and np.all(M.numpy()[:, 3392:] == 0)
        assert np.all(vecs.numpy()[:, 3392:] == 0) and np.all(vecs.numpy()[4:] == 0)
    # conv_joint re-permuted once at fold time: joint-major rows
    cj_kernel, cj_bias = folded["conv_joint"]
    np.testing.assert_array_equal(cj_kernel.numpy(), payload["params"]["backbone"]["conv_joint"]["kernel"])
    np.testing.assert_array_equal(cj_bias.numpy(), payload["params"]["backbone"]["conv_joint"]["bias"])


@pytest.mark.parametrize("kw", [
    dict(),
    dict(fused_eval=False),
    dict(cluster_sampling="seed_fps"),
    dict(vote_factor=2),
])
def test_generate_small_matches_jax(payload, jax_variables, goldens, kw):
    """Fused chain, module path, seed_fps proposals and two votes per seed.
    vote_factor changes parameter shapes, so it gets its own weights."""
    x = walking_clip(np.random.RandomState(0), 2, SMALL["num_frames"])
    if "vote_factor" in kw:
        payload = flax_payload(SMALL["num_gaussian"], seed=4, vote_factor=kw["vote_factor"])
        jax_variables = {"params": payload["params"], "batch_stats": payload["batch_stats"]}
    if kw:
        ref = jax.tree_util.tree_map(
            np.asarray, jax_model(SMALL, **kw).apply(jax_variables, x, method=JaxP2RNet.generate)
        )
    else:  # the same call on the same weights and clips, shared with other files
        ref = goldens.jax_generate_small(sparse_eval=False)
    model = port_model(SMALL, payload, **kw)
    got = to_numpy(model.generate(torch.from_numpy(x), folded=model.fold_eval()))
    assert set(got) == set(ref)
    assert got["seed_inds"].dtype == np.int32 and got["aggregated_vote_inds"].dtype == np.int32
    assert_generate_close(got, ref)


@pytest.mark.parametrize("n", [1, 5, 16, 17, 96, 250, 768, 4100])
def test_blocked_cumsum_matches_jax_cpu_cumsum(n):
    """The arc-length seeds need XLA's CPU cumsum association bit for bit."""
    rng = np.random.RandomState(n)
    x = (rng.rand(3, n) * 0.02).astype(np.float32)
    x[:, ::3] = 0  # plateaus, as in a resampled clip with repeated frames
    np.testing.assert_array_equal(
        blocked_cumsum(torch.from_numpy(x)).numpy(), np.asarray(jnp.cumsum(x, axis=1))
    )


def test_folded_equals_inline_fold(port):
    x = torch.from_numpy(walking_clip(np.random.RandomState(1), 1, SMALL["num_frames"]))
    a = to_numpy(port.generate(x, folded=port.fold_eval()))
    b = to_numpy(port.generate(x))
    for k in ("seed_features", "center", "sem_cls_scores"):
        np.testing.assert_array_equal(a[k], b[k])


def test_random_seed_sampling_uses_generator(payload):
    model = port_model(SMALL, payload, seed_sampling="random", num_seeds=32)
    x = torch.from_numpy(walking_clip(np.random.RandomState(2), 2, SMALL["num_frames"]))
    a = model.generate(x, generator=torch.Generator().manual_seed(7))["seed_inds"]
    b = model.generate(x, generator=torch.Generator().manual_seed(7))["seed_inds"]
    c = model.generate(x, generator=torch.Generator().manual_seed(8))["seed_inds"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 32) and torch.all(a[:, 1:] > a[:, :-1])


def test_linspace_seeds_when_seeds_cover_frames(payload):
    sizes = dict(SMALL, num_seeds=128)
    x = walking_clip(np.random.RandomState(3), 1, SMALL["num_frames"])
    jvars = {"params": payload["params"], "batch_stats": payload["batch_stats"]}
    ref = np.asarray(jax_model(sizes).apply(jvars, x, method=JaxP2RNet.generate)["seed_inds"])
    got = port_model(sizes, payload).generate(torch.from_numpy(x))["seed_inds"].numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("path", ["train_forward", "train_runner"])
def test_unported_options_raise(path, tmp_path, monkeypatch):
    """bf16 training is ported: the train-mode forward gives finite outputs
    (bf16 logits, as in JAX) and gradients that reach every f32 parameter,
    and the train runner finishes an epoch; an unported compute dtype still
    raises."""
    if path == "train_forward":
        model = P2RNet(P2RNetConfig(**SMALL, compute_dtype="bfloat16"), device="cpu").train()
        x = torch.from_numpy(walking_clip(np.random.RandomState(5), 1, SMALL["num_frames"]))
        out = model(x, generator=torch.Generator().manual_seed(0))
        for k in ("seed_features", "vote_xyz", "center", "size", "heading", "objectness_scores", "sem_cls_scores"):
            assert torch.isfinite(out[k].float()).all(), k
        assert out["sem_cls_scores"].dtype == torch.bfloat16 and out["center"].dtype == torch.float32
        (out["center"].sum() + out["size"].sum() + out["sem_cls_scores"].float().sum()).backward()
        grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
        assert grads and all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads.values())
        assert "backbone.st_gcn_networks.0.gcn.conv.weight" in grads and "backbone.edge_importance.5" in grads
    else:
        monkeypatch.chdir(tmp_path)  # the TensorBoard board writes to ./runs
        config = yaml.safe_load(open(TRAIN_YAML))
        config["model"] = {**(config.get("model") or {}), "compute_dtype": "bfloat16"}
        config["data"].update(num_frames=SMALL["num_frames"], num_seeds=SMALL["num_seeds"],
                              num_target=SMALL["num_proposals"], num_gaussian=SMALL["num_gaussian"])
        config["train"].update(epochs=1, batch_size=2)
        config["val"]["batch_size"] = 2
        config["device"]["num_workers"] = 0
        config["log"]["path"] = str(tmp_path / "out")
        rng = np.random.RandomState(6)
        scenes = [synth.as_stored(*synth.make_scene(rng, n_objects=3, n_frames=120)) for _ in range(4)]
        cfg = CONFIG(config, mode="train")
        try:
            _, history = train_runner.run(cfg, device="cpu", datasets={
                "train": SceneDataset(scenes[:2], num_frames=SMALL["num_frames"], augment=True),
                "val": SceneDataset(scenes[2:], num_frames=SMALL["num_frames"])})
        finally:
            cfg.close()
        assert len(history) == 1
        for phase in ("train", "val"):
            assert all(np.isfinite(v) for v in history[0][phase].values()), phase
    with pytest.raises(NotImplementedError):
        P2RNet(P2RNetConfig(**SMALL, compute_dtype="float16"), device="cpu")


def test_multi_mode_raises(port):
    """Multi-mode generation draws its noise from a generator of the model's
    device or takes it injected; with neither it raises."""
    x = torch.from_numpy(walking_clip(np.random.RandomState(4), 1, SMALL["num_frames"]))
    with pytest.raises(ValueError, match="multi_mode"):
        port.generate(x, multi_mode=True)
