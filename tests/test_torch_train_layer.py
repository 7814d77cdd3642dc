"""Train-mode layers of the port against the JAX package, on the CPU.

* train-mode BatchNorm / MLP1x1 against flax (outputs, updated mean/var);
* the plain versions of kernels 3 and 4 against the JAX package's jnp
  mirrors and its interpret-mode Pallas kernels, at the small shape of
  tests/test_stgcn_train.py (V=5, W0=320 -> Wp=384, T=16, B=2) with that
  file's f32 bands;
* ``FusedTrainLayer``'s hand-written backward against torch autograd of
  ``train_layer_ref`` (the same forward from the plain versions);
* the layer's outputs, stats and gradients against ``jax.grad`` of
  ``make_train_layer(..., dtype=float32)`` on the same numpy operands;
* the port's fused block against its own module path (full 53-joint width).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose2room_tpu.models.layers import MLP1x1 as JaxMLP1x1
from pose2room_tpu.ops import stgcn_train as jax_train
from pose2room_tpu_torch import kernels
from pose2room_tpu_torch.models.graph import build_spatial_graph
from pose2room_tpu_torch.models.layers import MLP1x1, STGCNBlock
from pose2room_tpu_torch.ops import stgcn_train
from pose2room_tpu_torch.ops.stgcn_fused import block_diag_taps
from torch_golden import goldens, jax_layer  # noqa: F401  (fixtures)
from torch_kernel_cases import B, C, NAMES, T, V, W0, Wp, layer_args


def _kernel_operands(seed):
    rng = np.random.RandomState(seed)
    y = np.zeros((B * T, Wp), np.float32)
    y[:, :W0] = rng.randn(B * T, W0) * 0.7
    vecs = np.zeros((4, Wp), np.float32)
    vecs[0, :W0] = 0.5 + rng.rand(W0)
    vecs[1, :W0] = rng.randn(W0) * 0.3
    vecs[2, :W0] = rng.randn(W0) * 0.1
    taps = (rng.randn(3, C, C) * 0.15).astype(np.float32)
    dy2 = np.zeros((B * T, Wp), np.float32)
    dy2[:, :W0] = rng.randn(B * T, W0) * 0.5
    KB = np.array(jax_train._block_diag_taps(jnp.asarray(taps)))
    return y, vecs, KB, dy2


def _copy_mlp(port, params, stats):
    with torch.no_grad():
        for i, layer in enumerate(port):
            layer.conv.weight.copy_(torch.from_numpy(np.array(params[f"dense{i}"]["kernel"]).T))
            if layer.conv.bias is not None:
                layer.conv.bias.copy_(torch.from_numpy(np.array(params[f"dense{i}"]["bias"])))
            if layer.batchnorm is not None:
                bn = layer.batchnorm
                bn.weight.copy_(torch.from_numpy(np.array(params[f"bn{i}"]["scale"])))
                bn.bias.copy_(torch.from_numpy(np.array(params[f"bn{i}"]["bias"])))
                bn.running_mean.copy_(torch.from_numpy(np.array(stats[f"bn{i}"]["mean"])))
                bn.running_var.copy_(torch.from_numpy(np.array(stats[f"bn{i}"]["var"])))


@pytest.mark.parametrize("bn_momentum", [0.9, 0.5])
def test_train_mode_mlp_matches_flax(bn_momentum):
    """Live batch stats (biased variance), flax EMA of the running stats."""
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 24, 20, 3) * 2.0 + 0.5).astype(np.float32)
    flax_mlp = JaxMLP1x1([64, 64, 64], bn_momentum=bn_momentum)
    variables = flax_mlp.init(jax.random.PRNGKey(0), x, train=False)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.1, 0.5, np.shape(v)).astype(np.float32),
        variables["batch_stats"],
    )
    variables = {"params": variables["params"], "batch_stats": stats}
    ref, mut = flax_mlp.apply(variables, x, train=True, mutable=["batch_stats"])
    port = MLP1x1(3, [64, 64, 64], bn_momentum=bn_momentum)
    _copy_mlp(port, variables["params"], stats)
    port.train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)
    for i in range(2):
        bn = port[i].batchnorm
        np.testing.assert_allclose(bn.running_mean.numpy(), mut["batch_stats"][f"bn{i}"]["mean"],
                                   atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(), mut["batch_stats"][f"bn{i}"]["var"],
                                   atol=1e-6, rtol=1e-5)
    # eval mode: the running statistics, and no update
    port.eval()
    before = port[0].batchnorm.running_mean.clone()
    ref_eval = flax_mlp.apply(mut | {"params": variables["params"]}, x, train=False)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), np.asarray(ref_eval),
                               atol=2e-5, rtol=1e-5)
    assert torch.equal(port[0].batchnorm.running_mean, before)


def test_tconv_stats_fwd_matches_jax():
    y, vecs, KB, _ = _kernel_operands(0)
    y2, parts = stgcn_train.tconv_stats_fwd(torch.from_numpy(y), torch.from_numpy(vecs),
                                            torch.from_numpy(KB), T=T)
    for mode in ("ref", "interpret"):
        if mode == "ref":
            y2_j, parts_j = jax_train._tconv_stats_fwd_ref(y, vecs, KB, T=T)
        else:
            y2_j, parts_j = jax_train._tconv_stats_fwd(y, vecs, KB, T=T, interpret=True)
        np.testing.assert_allclose(y2.numpy(), np.asarray(y2_j), atol=1e-5, rtol=1e-5, err_msg=mode)
        np.testing.assert_allclose(parts.numpy(), np.asarray(parts_j), atol=1e-3, rtol=1e-5, err_msg=mode)
    assert np.all(y2.numpy()[:, W0:] == 0) and np.all(parts.numpy()[..., W0:] == 0)


def test_tconv_bwd_matches_jax():
    y, vecs, KB, dy2 = _kernel_operands(1)
    vecs[2] = 0.0
    KBT = np.ascontiguousarray(np.transpose(KB, (0, 2, 1)))
    args = [torch.from_numpy(a) for a in (dy2, y, vecs, KBT)]
    dpre, parts, dkb = stgcn_train.tconv_bwd_ref(*args, T=T)
    for mode in ("ref", "interpret"):
        if mode == "ref":
            ref = jax_train._tconv_bwd_ref(dy2, y, vecs, KBT, T=T)
        else:
            ref = jax_train._tconv_bwd(dy2, y, vecs, KBT, T=T, interpret=True)
        dp_j, parts_j, dkb_j = (np.asarray(r) for r in ref)
        np.testing.assert_allclose(dpre.numpy(), dp_j, atol=1e-5, rtol=1e-5, err_msg=mode)
        np.testing.assert_allclose(parts.numpy(), parts_j, atol=1e-3, rtol=1e-5, err_msg=mode)
        np.testing.assert_allclose(dkb.numpy(), dkb_j, atol=1e-2, rtol=1e-4, err_msg=mode)
    assert np.all(dpre.numpy()[:, W0:] == 0)
    # the wrapper (plain version on the CPU) returns the diagonal-block fold
    kernels.reset_launch_counts()
    dpre_w, parts_w, dtaps = stgcn_train.tconv_bwd(*args, T=T, C=C)
    assert not kernels.LAUNCHES
    assert torch.equal(dpre_w, dpre) and torch.equal(parts_w, parts)
    np.testing.assert_allclose(dtaps.numpy(), np.asarray(jax_train._fold_diag_blocks(dkb_j, C)),
                               atol=1e-2, rtol=1e-4)


@pytest.mark.parametrize("residual", [False, True])
def test_custom_backward_matches_autograd(residual):
    """FusedTrainLayer's hand-written backward == torch autograd of the
    identical forward built from the plain versions."""
    args = [torch.from_numpy(a) for a in layer_args(3, residual)]
    w = torch.from_numpy(np.random.RandomState(4).randn(B, T, Wp).astype(np.float32))
    results = []
    for fn in (stgcn_train.FusedTrainLayer.apply, stgcn_train.train_layer_ref):
        leaves = [a.clone().requires_grad_() for a in args]
        outs = fn(*leaves, residual, V, C, T)
        (outs[0] * w).sum().backward()
        results.append(([o.detach() for o in outs], [leaf.grad for leaf in leaves]))
    (outs_c, grads_c), (outs_p, grads_p) = results
    for a, b in zip(outs_c, outs_p):
        assert torch.equal(a, b)
    for name, a, b in zip(NAMES, grads_c, grads_p):
        if name == "cb":
            # BN2 absorbs per-channel shifts: the true gradient is 0, which
            # the hand-written backward returns exactly; autodiff gives noise
            assert torch.all(a == 0)
            assert b.abs().max() < 1e-4 * grads_p[8].abs().max()
            continue
        # autodiff also sees the pad columns of M / bias_col through the
        # batch statistics; the hand-written backward keeps them inert
        if name == "M":
            a, b = a[:W0, :W0], b[:W0, :W0]
        elif name == "bias_col":
            a, b = a[:W0], b[:W0]
        torch.testing.assert_close(a, b, atol=1e-5 * b.abs().max().item(), rtol=0, msg=name)


@pytest.mark.parametrize("residual", [False, True])
def test_layer_matches_jax_grad(jax_layer, residual):
    outs_j, grads_j, w = jax_layer[residual]
    leaves = [torch.from_numpy(a).requires_grad_() for a in layer_args(10 + residual, residual)]
    outs = stgcn_train.FusedTrainLayer.apply(*leaves, residual, V, C, T)
    (outs[0] * torch.from_numpy(w)).sum().backward()
    for name, a, b in zip(("out", "mean1", "var1", "mean2", "var2"), outs, outs_j):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=1e-5, rtol=1e-5, err_msg=name)
    for name, leaf, g in zip(NAMES, leaves, grads_j):
        got = leaf.grad.numpy()
        if name == "cb":
            assert np.all(got == 0) and np.all(g == 0)
            continue
        np.testing.assert_allclose(got, g, atol=1e-4 * np.abs(g).max(), rtol=0, err_msg=name)
    assert np.all(leaves[1].grad.numpy()[:, W0:] == 0) and np.all(leaves[1].grad.numpy()[W0:] == 0)


def test_fused_block_matches_module_path():
    """The port's fused train block against its module path (live BN) at
    the full 53-joint width: outputs, running stats, parameter gradients."""
    Vj, Cj, Tj, Bj = 53, 64, 16, 2
    A = torch.from_numpy(build_spatial_graph(Vj, max_hop=5))
    g = torch.Generator().manual_seed(0)
    block = STGCNBlock(Cj, Cj, A.shape[0], Vj, residual=True)
    block.reset_parameters(g)
    with torch.no_grad():
        for bn in (block.tcn[0], block.tcn[3]):
            bn.weight.uniform_(0.7, 1.3, generator=g)
            bn.bias.normal_(0, 0.1, generator=g)
        block.gcn.conv.bias.normal_(0, 0.1, generator=g)
        block.tcn[2].bias.normal_(0, 0.1, generator=g)
    imp = torch.empty_like(A).uniform_(0.7, 1.3, generator=g)
    x = torch.randn(Bj, Tj, Vj, Cj, generator=g) * 0.5
    w = torch.randn(Bj, Tj, Vj, Cj, generator=g)
    runs = {}
    for path in ("module", "fused"):
        blk = STGCNBlock(Cj, Cj, A.shape[0], Vj, residual=True)
        blk.load_state_dict(block.state_dict())
        blk.train()
        if path == "module":
            out = blk(x, A * imp)
        else:
            out = blk.apply_fused_train(x.reshape(Bj, Tj, Vj * Cj), A * imp, Tj)
            out = out[..., : Vj * Cj].reshape(Bj, Tj, Vj, Cj)
        (out * w).sum().backward()
        runs[path] = (out.detach(), {k: v.clone() for k, v in blk.state_dict().items()},
                      {k: p.grad for k, p in blk.named_parameters()})
    (out_m, sd_m, g_m), (out_f, sd_f, g_f) = runs["module"], runs["fused"]
    torch.testing.assert_close(out_f, out_m, atol=1e-4, rtol=1e-4)
    for k in sd_m:
        torch.testing.assert_close(sd_f[k], sd_m[k], atol=1e-5, rtol=1e-5, msg=k)
    for k in g_m:
        if k == "tcn.2.bias":
            assert torch.all(g_f[k] == 0)  # the module path gives rounding noise here
            assert g_m[k].abs().max() < 1e-3 * g_m["tcn.3.bias"].abs().max()
            continue
        torch.testing.assert_close(g_f[k], g_m[k], atol=1e-4 * g_m[k].abs().max().item(), rtol=0, msg=k)


def test_block_diag_taps_matches_jax():
    taps = np.random.RandomState(5).randn(3, C, C).astype(np.float32)
    np.testing.assert_array_equal(block_diag_taps(torch.from_numpy(taps)).numpy(),
                                  np.asarray(jax_train._block_diag_taps(jnp.asarray(taps))))
