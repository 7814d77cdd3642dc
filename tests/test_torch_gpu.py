"""CUDA kernels of the port against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips (inside the ``cuda_device``
fixture) where no card is present.  The file imports neither JAX nor the JAX
package, so it runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py configures JAX, which such a machine
may not have.)
"""

import numpy as np
import pytest
import torch

from pose2room_tpu_torch import kernels
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
from pose2room_tpu_torch.models.graph import SPARSE_JOINT_ORDER, build_spatial_graph
from pose2room_tpu_torch.ops import sampling, stgcn_fused, stgcn_sparse, stgcn_train
from torch_fps_clouds import FPS_KINDS, fps_cloud

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip where there is none (decided at run time, so
    every xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _operands(B, T, W0, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    Wp = stgcn_fused.pad_merged(W0)
    x = torch.zeros(B, T, Wp)
    x[..., :W0] = torch.relu(torch.randn(B, T, W0, generator=g))
    M = torch.zeros(Wp, Wp)
    M[:W0, :W0] = torch.randn(W0, W0, generator=g) * 0.05
    vecs = torch.zeros(8, Wp)
    vecs[:4, :W0] = torch.randn(4, W0, generator=g) * 0.1 + torch.tensor([1.0, 0, 1.0, 0])[:, None]
    taps = torch.randn(3, 64, 64, generator=g) * 0.1
    KB = torch.einsum("sio,pq->spiqo", taps, torch.eye(2)).reshape(3, 128, 128)
    return [t.to(dev) for t in (x, M, vecs, KB)]


@pytest.mark.parametrize("B,T,W0", [(1, 768, 3392), (2, 100, 3392), (3, 17, 192),
                                    (8, 768, 3392), (2, 200, 3392), (8, 200, 320)])
@pytest.mark.parametrize("residual", [True, False])
def test_epilogue_kernel_matches_plain(cuda_device, B, T, W0, residual):
    """T = 200 crosses the 128-row tile and ends inside one; B = 8 gives each
    block of the persistent grid several tiles."""
    x, M, vecs, KB = _operands(B, T, W0, cuda_device)
    t1 = stgcn_fused.graph_matmul_bn_relu(x, M, vecs[0], vecs[1])
    xr = x if residual else None
    before = kernels.LAUNCHES["stgcn_epilogue"]
    got = stgcn_fused.fused_epilogue(t1, xr, vecs, KB, residual=residual)
    assert kernels.LAUNCHES["stgcn_epilogue"] == before + 1
    ref = stgcn_fused.epilogue_merged_ref(t1, xr, vecs, KB, residual=residual)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    assert torch.all(got[..., W0:] == 0)


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("residual", [True, False])
def test_epilogue_kernel_same_bits_on_relaunch(cuda_device, B, residual):
    x, M, vecs, KB = _operands(B, 768, 3392, cuda_device, seed=3)
    t1 = stgcn_fused.graph_matmul_bn_relu(x, M, vecs[0], vecs[1])
    xr = x if residual else None
    first = stgcn_fused.fused_epilogue(t1, xr, vecs, KB, residual=residual)
    assert torch.equal(first, stgcn_fused.fused_epilogue(t1, xr, vecs, KB, residual=residual))


def test_first_block_unpadded_input(cuda_device):
    x, M, vecs, KB = _operands(2, 64, 3392, cuda_device)
    xu = x[..., :3392].contiguous()
    got = stgcn_fused.fused_stgcn_layer(xu, M, vecs, KB, residual=False)
    ref = stgcn_fused.stgcn_layer_merged_ref(xu, M, vecs, KB, residual=False)
    torch.cuda.synchronize()
    assert got.shape == (2, 64, 3456)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    assert torch.all(got[..., 3392:] == 0)


def test_epilogue_wrapper_rejects_bad_operands(cuda_device):
    x, M, vecs, KB = _operands(2, 16, 192, cuda_device)
    t1 = stgcn_fused.graph_matmul_bn_relu(x, M, vecs[0], vecs[1])
    with pytest.raises(TypeError):
        stgcn_fused.fused_epilogue(t1.double(), x.double(), vecs, KB, residual=True)
    with pytest.raises(ValueError):
        stgcn_fused.fused_epilogue(t1, x[..., :128], vecs, KB, residual=True)
    with pytest.raises(ValueError):
        stgcn_fused.fused_epilogue(t1.transpose(0, 1), x.transpose(0, 1), vecs, KB, residual=True)
    with pytest.raises(ValueError):
        stgcn_fused.fused_epilogue(t1, x.cpu(), vecs, KB, residual=True)
    # contiguous but off the 16-byte boundary that the kernel's cp.async needs
    shifted = torch.zeros(t1.numel() + 1, device=cuda_device)[1:].view(t1.shape)
    with pytest.raises(ValueError):
        stgcn_fused.fused_epilogue(shifted, x, vecs, KB, residual=True)


def _train_operands(B, T, W0, dev, seed=0):
    """Kernel 3/4 operands in the fold's layout: pad columns of y, dy2 and
    vecs zero, KB block-diagonal with one 64x64 tap."""
    g = torch.Generator().manual_seed(seed)
    Wp = stgcn_fused.pad_merged(W0)
    y = torch.zeros(B * T, Wp)
    y[:, :W0] = torch.randn(B * T, W0, generator=g) * 0.7
    dy2 = torch.zeros(B * T, Wp)
    dy2[:, :W0] = torch.randn(B * T, W0, generator=g) * 0.5
    vecs = torch.zeros(4, Wp)
    vecs[0, :W0] = 0.5 + torch.rand(W0, generator=g)
    vecs[1, :W0] = torch.randn(W0, generator=g) * 0.3
    vecs[2, :W0] = torch.randn(W0, generator=g) * 0.1
    KB = stgcn_fused.block_diag_taps(torch.randn(3, 64, 64, generator=g) * 0.15)
    return [t.to(dev) for t in (y, dy2, vecs, KB)]


def _assert_parts_close(parts, ref, magnitudes):
    """Column partials within 1e-5 of each column's scale: the sum of the
    magnitudes of its terms, which bounds the rounding of a sum taken in
    another order."""
    scale = torch.stack(magnitudes, dim=1).clamp_min(1e-6)
    assert ((parts - ref).abs() / scale).max().item() <= 1e-5


@pytest.mark.parametrize("B,T,W0", [(1, 768, 3392), (8, 768, 3392), (2, 100, 3392), (3, 17, 320),
                                    (2, 200, 3392), (8, 200, 3392), (8, 130, 192)])
def test_train_fwd_kernel_matches_plain(cuda_device, B, T, W0):
    """T = 200 and 130 cross the 128-row tile (130: a 128-row tile whose
    second 64-row part of partials lies past the clip)."""
    y, _, vecs, KB = _train_operands(B, T, W0, cuda_device)
    before = kernels.LAUNCHES["stgcn_train_fwd"]
    y2, parts = stgcn_train.tconv_stats_fwd(y, vecs, KB, T=T)
    assert kernels.LAUNCHES["stgcn_train_fwd"] == before + 1
    y2_ref, parts_ref = stgcn_train.tconv_stats_fwd_ref(y, vecs, KB, T=T)
    torch.cuda.synchronize()
    torch.testing.assert_close(y2, y2_ref, atol=1e-4, rtol=1e-4)
    y2_3 = y2_ref.reshape(B, T, -1)
    _assert_parts_close(parts, parts_ref, [y2_3.abs().sum(1), (y2_3 * y2_3).sum(1)])
    assert torch.all(y2[:, W0:] == 0) and torch.all(parts[..., W0:] == 0)


@pytest.mark.parametrize("B", [1, 8])
def test_train_fwd_kernel_same_bits_on_relaunch(cuda_device, B):
    """Fixed-order moments: a second launch gives the same bits."""
    y, _, vecs, KB = _train_operands(B, 768, 3392, cuda_device, seed=3)
    first = stgcn_train.tconv_stats_fwd(y, vecs, KB, T=768)
    again = stgcn_train.tconv_stats_fwd(y, vecs, KB, T=768)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("B,T,W0", [(1, 768, 3392), (8, 768, 3392), (2, 100, 3392), (3, 17, 320),
                                    (2, 200, 3392)])
def test_train_bwd_kernel_matches_plain(cuda_device, B, T, W0):
    """T = 200: a full and a partial 128-row tile per clip; B = 8 gives each
    block of the persistent grid several tiles."""
    y, dy2, vecs, KB = _train_operands(B, T, W0, cuda_device)
    KBT = KB.transpose(1, 2).contiguous()
    before = kernels.LAUNCHES["stgcn_train_bwd"]
    dpre, parts, dtaps = stgcn_train.tconv_bwd(dy2, y, vecs, KBT, T=T, C=64)
    assert kernels.LAUNCHES["stgcn_train_bwd"] == before + 1
    dpre_ref, parts_ref, dkb_ref = stgcn_train.tconv_bwd_ref(dy2, y, vecs, KBT, T=T)
    dtaps_ref = stgcn_train._fold_diag_blocks(dkb_ref, 64)
    torch.cuda.synchronize()
    torch.testing.assert_close(dpre, dpre_ref, atol=1e-4, rtol=1e-4)
    d3, y3 = dpre_ref.reshape(B, T, -1), y.reshape(B, T, -1)
    _assert_parts_close(parts, parts_ref, [d3.abs().sum(1), (d3 * y3).abs().sum(1)])
    torch.testing.assert_close(dtaps, dtaps_ref, atol=1e-4 * dtaps_ref.abs().max().item(), rtol=0)
    assert torch.all(dpre[:, W0:] == 0) and torch.all(parts[..., W0:] == 0)
    # fixed-order reductions: a second launch gives the same bits
    again = stgcn_train.tconv_bwd(dy2, y, vecs, KBT, T=T, C=64)
    assert all(torch.equal(a, b) for a, b in zip((dpre, parts, dtaps), again))


def test_train_wrappers_reject_bad_operands(cuda_device):
    y, dy2, vecs, KB = _train_operands(2, 16, 192, cuda_device)
    with pytest.raises(ValueError):
        stgcn_train.tconv_stats_fwd(y, vecs, KB, T=5)
    with pytest.raises(TypeError):
        stgcn_train.tconv_stats_fwd(y.double(), vecs, KB, T=16)
    with pytest.raises(ValueError):
        stgcn_train.tconv_bwd(dy2, y, vecs, KB, T=16, C=32)
    with pytest.raises(ValueError):
        stgcn_train.tconv_bwd(dy2, y, vecs.cpu(), KB, T=16, C=64)


def test_fused_train_layer_card_matches_cpu(cuda_device):
    """The whole custom-backward block on the card against the same block on
    the CPU (plain versions): outputs, stats and every gradient."""
    V, C, T, B = 53, 64, 64, 2
    W0, Wp = V * C, 3456
    g = torch.Generator().manual_seed(1)
    x = torch.zeros(B, T, Wp)
    x[..., :W0] = torch.randn(B, T, W0, generator=g) * 0.6
    M = torch.zeros(Wp, Wp)
    M[:W0, :W0] = torch.randn(W0, W0, generator=g) * 0.02
    bias_col = torch.zeros(Wp)
    bias_col[:W0] = torch.randn(W0, generator=g) * 0.1
    rest = [0.7 + torch.rand(C, generator=g), torch.randn(C, generator=g) * 0.2,
            torch.randn(3, C, C, generator=g) * 0.15, torch.randn(C, generator=g) * 0.1,
            0.7 + torch.rand(C, generator=g), torch.randn(C, generator=g) * 0.2]
    w = torch.randn(B, T, Wp, generator=g)
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        args = [t.to(dev).requires_grad_() for t in [x, M, bias_col, *rest]]
        outs = stgcn_train.FusedTrainLayer.apply(*args, True, V, C, T)
        (outs[0] * w.to(dev)).sum().backward()
        results.append(([o.detach().cpu() for o in outs], [a.grad.cpu() for a in args]))
    (outs_g, grads_g), (outs_c, grads_c) = results
    for a, b in zip(outs_g, outs_c):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    for i, (a, b) in enumerate(zip(grads_g, grads_c)):
        torch.testing.assert_close(a, b, atol=1e-3 * b.abs().max().item() + 1e-12, rtol=0, msg=f"grad {i}")
    assert torch.all(grads_g[6] == 0)  # conv bias: the analytic zero


def _sparse_operands(B, T, order, dev, seed=0):
    """Kernel 5 operands in the fold's layout: a random folded matrix on the
    support of A, permuted by ``order`` and packed into its nonzero tiles;
    x and vecs zero at the pad slot.  Returns (..., pad slot)."""
    g = torch.Generator().manual_seed(seed)
    support = np.zeros((54, 54), bool)
    support[:53, :53] = (build_spatial_graph() != 0).any(0)
    col_off, vlist = stgcn_sparse.sparse_tile_lists(support[:53, :53], order)
    M = torch.randn(54, 64, 54, 64, generator=g) * 0.05 * torch.from_numpy(support)[:, None, :, None]
    perm = torch.from_numpy(order.astype(np.int64))
    Mp = M[perm][:, :, perm].reshape(3456, 3456)
    pad = int(np.where(order == 53)[0][0])
    x = torch.randn(B, T, 3456, generator=g) * 0.5
    vecs = torch.zeros(8, 3456)
    vecs[0] = 0.5 + torch.rand(3456, generator=g)
    vecs[1] = torch.randn(3456, generator=g) * 0.3
    for t in (x, vecs):
        t[..., pad * 64:(pad + 1) * 64] = 0
    tiles = stgcn_sparse.gather_m_tiles(Mp, col_off, vlist).contiguous()
    ops = [t.to(dev) for t in (x, tiles, vecs, torch.from_numpy(col_off), torch.from_numpy(vlist))]
    return ops + [pad]


@pytest.mark.parametrize("B,T", [(1, 768), (8, 768), (2, 100), (3, 17)])
@pytest.mark.parametrize("natural", [False, True])
def test_sparse_kernel_matches_plain(cuda_device, B, T, natural):
    order = np.arange(54, dtype=np.int32) if natural else SPARSE_JOINT_ORDER
    x, tiles, vecs, col_off, vlist, pad = _sparse_operands(B, T, order, cuda_device)
    before = kernels.LAUNCHES["stgcn_sparse"]
    got = stgcn_sparse.sparse_graph_matmul_bn_relu(x, tiles, vecs, col_off, vlist)
    assert kernels.LAUNCHES["stgcn_sparse"] == before + 1
    ref = stgcn_sparse.sparse_graph_matmul_bn_relu_ref(x, tiles, vecs, col_off, vlist)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    assert torch.all(got[..., pad * 64:(pad + 1) * 64] == 0)
    # each output element is summed by one thread in a fixed order
    assert torch.equal(got, stgcn_sparse.sparse_graph_matmul_bn_relu(x, tiles, vecs, col_off, vlist))


def test_sparse_kernel_output_tile_without_entries(cuda_device):
    """Output tile 3's list emptied: it gets relu(0 * s1 + b1); at B = 1 the
    longer lists are cut into chunks, summed by their last chunk."""
    x, tiles, vecs, col_off, vlist, _ = _sparse_operands(1, 768, SPARSE_JOINT_ORDER, cuda_device)
    co, vl = col_off.cpu().numpy(), vlist.cpu().numpy()
    w = 3
    keep = torch.from_numpy(np.r_[0:co[w], co[w + 1]:len(vl)])
    co = co.copy()
    co[w + 1:] -= co[w + 1] - co[w]
    args = (x, tiles[keep.to(cuda_device)].contiguous(), vecs, torch.from_numpy(co).to(cuda_device),
            torch.from_numpy(vl[keep.numpy()]).to(cuda_device))
    got = stgcn_sparse.sparse_graph_matmul_bn_relu(*args)
    ref = stgcn_sparse.sparse_graph_matmul_bn_relu_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    empty = got[..., w * 128:(w + 1) * 128]
    assert torch.equal(empty, torch.relu(vecs[1, w * 128:(w + 1) * 128]).expand_as(empty))


def test_sparse_wrapper_rejects_bad_operands(cuda_device):
    x, tiles, vecs, col_off, vlist, _ = _sparse_operands(1, 16, SPARSE_JOINT_ORDER, cuda_device)
    with pytest.raises(TypeError):
        stgcn_sparse.sparse_graph_matmul_bn_relu(x.double(), tiles, vecs, col_off, vlist)
    with pytest.raises(TypeError):
        stgcn_sparse.sparse_graph_matmul_bn_relu(x, tiles, vecs, col_off.long(), vlist)
    with pytest.raises(ValueError):
        stgcn_sparse.sparse_graph_matmul_bn_relu(x, tiles[1:], vecs, col_off, vlist)
    with pytest.raises(ValueError):
        stgcn_sparse.sparse_graph_matmul_bn_relu(x, tiles, vecs, col_off.cpu(), vlist)


def test_sparse_generate_card_matches_cpu_small(cuda_device):
    cfg = P2RNetConfig(num_frames=96, num_seeds=64, num_proposals=16, num_gaussian=10, sparse_eval=True)
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 96, 53, 3) * 0.4).astype(np.float32)
    x[..., 0] += np.linspace(0, 3, 96, dtype=np.float32)[None, :, None]
    gpu = P2RNet(cfg, device=cuda_device)
    cpu = P2RNet(cfg, device="cpu")
    kernels.reset_launch_counts()
    a = gpu.generate(torch.from_numpy(x).to(cuda_device), folded=gpu.fold_eval())
    assert dict(kernels.LAUNCHES) == {"stgcn_sparse": 6, "stgcn_epilogue": 6, "fps": 1}
    b = cpu.generate(torch.from_numpy(x), folded=cpu.fold_eval())
    for key in ("seed_inds", "aggregated_vote_inds"):
        assert torch.equal(a[key].cpu(), b[key]), key
    for key in ("center", "size", "heading", "objectness_scores", "sem_cls_scores"):
        torch.testing.assert_close(a[key].cpu(), b[key], atol=5e-4, rtol=0)


@pytest.mark.parametrize("kind", FPS_KINDS)
@pytest.mark.parametrize("B,N,npoint", [(1, 512, 128), (32, 512, 128), (3, 2048, 64), (2, 40, 40),
                                        (300, 512, 128), (2, 1000, 100), (1, 2048, 2048), (2, 1, 1),
                                        (2, 31, 31), (2, 33, 33), (2, 500, 128), (1, 512, 1), (1, 512, 512),
                                        (3, 64, 16), (3, 50, 16)])
def test_fps_kernel_bit_exact(cuda_device, kind, B, N, npoint):
    """Each instantiation (4 warps of 4 and of 8 points a lane, 8 warps of
    8: N <= 512, <= 1024, <= 2048), more clips than SMs, ragged N, npoint 1
    and N; the last two shapes are the CPU tests' clouds."""
    xyz = torch.from_numpy(fps_cloud(kind, B, N, seed=N + B)).to(cuda_device)
    before = kernels.LAUNCHES["fps"]
    got = sampling.furthest_point_sample(xyz, npoint)
    again = sampling.furthest_point_sample(xyz, npoint)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fps"] == before + 2
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    assert torch.equal(got, again)
    assert torch.equal(got, sampling.fps_ref(xyz, npoint))
    assert torch.equal(got.cpu(), sampling.fps_ref(xyz.cpu(), npoint))
    if kind == "all_invalid":
        assert torch.all(got == 0)
    if kind == "one_valid" and npoint > 1 and N > 1:
        assert torch.all(got[:, 1:] == N // 2)


def test_fps_wrapper_rejects_bad_input(cuda_device):
    with pytest.raises(ValueError):
        sampling.furthest_point_sample(torch.zeros(1, 4096, 3, device=cuda_device), 8)
    with pytest.raises(TypeError):
        sampling.furthest_point_sample(torch.zeros(1, 64, 3, device=cuda_device, dtype=torch.float64), 8)


def test_generate_card_matches_cpu_small(cuda_device):
    cfg = P2RNetConfig(num_frames=96, num_seeds=64, num_proposals=16, num_gaussian=10)
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 96, 53, 3) * 0.4).astype(np.float32)
    x[..., 0] += np.linspace(0, 3, 96, dtype=np.float32)[None, :, None]
    gpu = P2RNet(cfg, device=cuda_device)
    cpu = P2RNet(cfg, device="cpu")
    kernels.reset_launch_counts()
    a = gpu.generate(torch.from_numpy(x).to(cuda_device), folded=gpu.fold_eval())
    assert kernels.LAUNCHES["stgcn_epilogue"] == 6 and kernels.LAUNCHES["fps"] == 1
    b = cpu.generate(torch.from_numpy(x), folded=cpu.fold_eval())
    for key in ("seed_inds", "aggregated_vote_inds"):
        assert torch.equal(a[key].cpu(), b[key]), key
    for key in ("center", "size", "heading", "objectness_scores", "sem_cls_scores"):
        torch.testing.assert_close(a[key].cpu(), b[key], atol=5e-4, rtol=0)


SMALL_CFG = dict(num_frames=96, num_seeds=64, num_proposals=16, num_gaussian=10)


def _walking_clip(B, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, 96, 53, 3) * 0.4).astype(np.float32)
    x[..., 0] += np.linspace(0, 3, 96, dtype=np.float32)[None, :, None]
    return torch.from_numpy(x)


def _on(noise, device):
    return {k: (eps.to(device), u.to(device)) for k, (eps, u) in noise.items()}


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("n", [1, 37, 99])
def test_generate_multi_mode_card_matches_cpu_small(cuda_device, B, n):
    """Multi-mode generate on the card against the CPU on the same noise
    (drawn on the CPU, copied to the card): 6 epilogue + 1 fps launches;
    indices equal; at most 1e-5 of the Bernoulli weights ``u < pi`` flipped
    between the two devices' pi; the box outputs within 5e-4 on the
    proposals whose masks agree in every head, the rest everywhere."""
    x = _walking_clip(B)
    gpu, cpu = P2RNet(P2RNetConfig(**SMALL_CFG), device=cuda_device), P2RNet(P2RNetConfig(**SMALL_CFG), device="cpu")
    noise = cpu.multi_noise(B, n, torch.Generator().manual_seed(n))
    kernels.reset_launch_counts()
    a = gpu.generate(x.to(cuda_device), multi_mode=True, n_samples=n, folded=gpu.fold_eval(),
                     noise=_on(noise, cuda_device))
    assert dict(kernels.LAUNCHES) == {"stgcn_epilogue": 6, "fps": 1}
    b = cpu.generate(x, multi_mode=True, n_samples=n, folded=cpu.fold_eval(), noise=noise)
    for key in ("seed_inds", "aggregated_vote_inds"):
        assert torch.equal(a[key].cpu(), b[key]), key
    flips, total, rows = 0, 0, torch.ones(B, SMALL_CFG["num_proposals"], dtype=torch.bool)
    for k, (_, u) in noise.items():
        ma, mb = u < a["pi"][k].cpu()[..., None], u < b["pi"][k][..., None]
        flips += int((ma != mb).sum())
        total += u.numel()
        rows &= (ma == mb).all(-1).all(-1)
    print(f"B={B} n={n}: {flips} of {total} Bernoulli weights flipped")
    assert flips <= 1e-5 * total
    for key in ("center", "size", "heading"):
        torch.testing.assert_close(a[key].cpu()[rows], b[key][rows], atol=5e-4, rtol=0)
        torch.testing.assert_close(a["pi"][key].cpu(), b["pi"][key], atol=5e-4, rtol=0)
    for key in ("objectness_scores", "sem_cls_scores"):
        torch.testing.assert_close(a[key].cpu(), b[key], atol=5e-4, rtol=0)


@pytest.mark.parametrize("B", [1, 8])
def test_generate_multi_mode_same_bits_on_relaunch(cuda_device, B):
    """The same noise gives the same bits on a relaunch; so does noise drawn
    on the card from a card generator of the same seed."""
    x = _walking_clip(B, seed=1).to(cuda_device)
    gpu = P2RNet(P2RNetConfig(**SMALL_CFG), device=cuda_device)
    folded = gpu.fold_eval()
    noise = gpu.multi_noise(B, 99, torch.Generator(device=cuda_device).manual_seed(7))
    assert all(eps.device.type == u.device.type == "cuda" for eps, u in noise.values())
    runs = [gpu.generate(x, multi_mode=True, n_samples=99, folded=folded, noise=noise) for _ in range(2)]
    runs += [gpu.generate(x, multi_mode=True, n_samples=99, folded=folded,
                          generator=torch.Generator(device=cuda_device).manual_seed(7)) for _ in range(2)]
    for other in runs[1:]:
        for key in ("center", "size", "heading", "objectness_scores", "sem_cls_scores"):
            assert torch.equal(runs[0][key], other[key]), key


def test_eval_mesh_ap_test_run_on_card(cuda_device, tmp_path):
    """An ``eval_mesh_ap`` sparse test run on the card (metre-sized boxes,
    remove_far_box off, a 0.25 m lattice) reports every key, the ``_mesh``
    ones included, within 1e-6 of the same run on the CPU, after 6
    stgcn_sparse + 6 epilogue + 1 fps launches a batch."""
    import os

    import yaml

    from pose2room_tpu_torch.config.loader import CONFIG
    from pose2room_tpu_torch.data import synth
    from pose2room_tpu_torch.data.dataset import SceneDataset
    from pose2room_tpu_torch.runners import test as test_runner

    model = P2RNet(P2RNetConfig(**SMALL_CFG, sparse_eval=True), device="cpu")
    with torch.no_grad():
        mu = model.detection.gmm_size.mdn.mu
        mu.fill_(2 * np.log(1.5) / mu.shape[0])
    weight = str(tmp_path / "model.pth")
    torch.save({"net": model.state_dict()}, weight)
    rng = np.random.RandomState(4)
    dataset = SceneDataset([synth.as_stored(*synth.make_scene(rng, n_objects=3, n_frames=120)) for _ in range(4)],
                           num_frames=96)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    results = {}
    for dev in ("cuda", "cpu"):
        config = yaml.safe_load(open(os.path.join(repo, "configs", "config_files", "p2rnet_test.yaml")))
        config["data"].update(num_frames=96, num_seeds=64, num_target=16, num_gaussian=10)
        config["model"]["sparse_eval"] = True
        config["test"].update(batch_size=2, remove_far_box=False, eval_mesh_ap=True, mesh_voxel_size=0.25)
        config["generation"]["dump_results"] = False
        config.update(finetune=True, weight=[weight], seed=42, device={"num_workers": 0},
                      log={**config["log"], "path": str(tmp_path / dev)})
        cfg = CONFIG(config, mode="test")
        try:
            kernels.reset_launch_counts()
            results[dev] = test_runner.run(cfg, device=dev, dataset=dataset)
            launches = dict(kernels.LAUNCHES)
        finally:
            cfg.close()
        if dev == "cuda":
            assert launches == {"stgcn_sparse": 12, "stgcn_epilogue": 12, "fps": 2}
    for t, want in results["cpu"].items():
        got = results["cuda"][t]
        assert list(got) == list(want) and "mAP_mesh" in got
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-6, (t, k)


# ---------------------------------------------------------------------------
# bf16 legs of kernels 1 and 5 (model.compute_dtype: bfloat16)
# ---------------------------------------------------------------------------

def _bf16_ordinal(t):
    """bf16 tensor -> int64 in value order: adjacent bf16 values differ by 1."""
    u = t.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
    return torch.where(u >= 0x8000, -(u & 0x7FFF), u)


def _assert_bf16_close(got, ref):
    """Both bf16, the same sums in another order: within 1 bf16 ulp wherever
    |ref| is above 1e-3 of its max (nearer 0 an f32 rounding moves more
    ulps), and within 2^-7 of the max everywhere (1 ulp of the max's
    binade)."""
    assert got.dtype == ref.dtype == torch.bfloat16
    scale = ref.float().abs().max()
    live = ref.float().abs() > 1e-3 * scale
    assert (_bf16_ordinal(got) - _bf16_ordinal(ref)).abs()[live].max().item() <= 1
    assert (got.float() - ref.float()).abs().max().item() <= scale.item() * 2 ** -7


@pytest.mark.parametrize("B,T,W0", [(1, 768, 3392), (8, 768, 3392), (2, 200, 3392), (3, 17, 192)])
@pytest.mark.parametrize("residual", [True, False])
def test_epilogue_bf16_kernel_matches_plain(cuda_device, B, T, W0, residual):
    x, M, vecs, KB = _operands(B, T, W0, cuda_device)
    xb, KBb = x.to(torch.bfloat16), KB.to(torch.bfloat16)
    t1 = stgcn_fused.graph_matmul_bn_relu(xb, M.to(torch.bfloat16), vecs[0], vecs[1])
    assert t1.dtype == torch.bfloat16
    xr = xb if residual else None
    before = dict(kernels.LAUNCHES)
    got = stgcn_fused.fused_epilogue(t1, xr, vecs, KBb, residual=residual)
    assert kernels.LAUNCHES["stgcn_epilogue_bf16"] == before.get("stgcn_epilogue_bf16", 0) + 1
    assert kernels.LAUNCHES["stgcn_epilogue"] == before.get("stgcn_epilogue", 0)
    ref = stgcn_fused.epilogue_merged_ref(t1, xr, vecs, KBb, residual=residual)
    torch.cuda.synchronize()
    _assert_bf16_close(got, ref)
    assert torch.all(got[..., W0:] == 0)
    assert torch.equal(got, stgcn_fused.fused_epilogue(t1, xr, vecs, KBb, residual=residual))


@pytest.mark.parametrize("B,T", [(1, 768), (8, 768), (3, 17)])
@pytest.mark.parametrize("natural", [False, True])
def test_sparse_bf16_kernel_matches_plain(cuda_device, B, T, natural):
    order = np.arange(54, dtype=np.int32) if natural else SPARSE_JOINT_ORDER
    x, tiles, vecs, col_off, vlist, pad = _sparse_operands(B, T, order, cuda_device)
    xb, tb = x.to(torch.bfloat16), tiles.to(torch.bfloat16)
    before = dict(kernels.LAUNCHES)
    got = stgcn_sparse.sparse_graph_matmul_bn_relu(xb, tb, vecs, col_off, vlist)
    assert kernels.LAUNCHES["stgcn_sparse_bf16"] == before.get("stgcn_sparse_bf16", 0) + 1
    assert kernels.LAUNCHES["stgcn_sparse"] == before.get("stgcn_sparse", 0)
    ref = stgcn_sparse.sparse_graph_matmul_bn_relu_ref(xb, tb, vecs, col_off, vlist)
    torch.cuda.synchronize()
    _assert_bf16_close(got, ref)
    assert torch.all(got[..., pad * 64:(pad + 1) * 64] == 0)
    assert torch.equal(got, stgcn_sparse.sparse_graph_matmul_bn_relu(xb, tb, vecs, col_off, vlist))


def test_sparse_bf16_output_tile_without_entries(cuda_device):
    x, tiles, vecs, col_off, vlist, _ = _sparse_operands(1, 768, SPARSE_JOINT_ORDER, cuda_device)
    co, vl = col_off.cpu().numpy(), vlist.cpu().numpy()
    w = 3
    keep = torch.from_numpy(np.r_[0:co[w], co[w + 1]:len(vl)])
    co = co.copy()
    co[w + 1:] -= co[w + 1] - co[w]
    args = (x.to(torch.bfloat16), tiles[keep.to(cuda_device)].to(torch.bfloat16).contiguous(), vecs,
            torch.from_numpy(co).to(cuda_device), torch.from_numpy(vl[keep.numpy()]).to(cuda_device))
    got = stgcn_sparse.sparse_graph_matmul_bn_relu(*args)
    ref = stgcn_sparse.sparse_graph_matmul_bn_relu_ref(*args)
    torch.cuda.synchronize()
    _assert_bf16_close(got, ref)
    empty = got[..., w * 128:(w + 1) * 128]
    want = torch.relu(vecs[1, w * 128:(w + 1) * 128]).to(torch.bfloat16)
    assert torch.equal(empty, want.expand_as(empty))


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("T", [768, 130, 50])
def test_sparse_bf16_kernel_batches_and_ragged_rows(cuda_device, B, T):
    """The wgmma leg of kernel 5 with (B = 1) and without the split-K cut, on
    row counts that 128 does not divide (T = 130, 50): within 1 bf16 ulp of
    the plain version, the pad slot 0, two launches the same bits."""
    x, tiles, vecs, col_off, vlist, pad = _sparse_operands(B, T, SPARSE_JOINT_ORDER, cuda_device, seed=B + T)
    xb, tb = x.to(torch.bfloat16), tiles.to(torch.bfloat16)
    got = stgcn_sparse.sparse_graph_matmul_bn_relu(xb, tb, vecs, col_off, vlist)
    again = stgcn_sparse.sparse_graph_matmul_bn_relu(xb, tb, vecs, col_off, vlist)
    ref = stgcn_sparse.sparse_graph_matmul_bn_relu_ref(xb, tb, vecs, col_off, vlist)
    torch.cuda.synchronize()
    _assert_bf16_close(got, ref)
    assert torch.all(got[..., pad * 64:(pad + 1) * 64] == 0)
    assert torch.equal(got, again)


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("T", [768, 200, 50, 17])
@pytest.mark.parametrize("residual", [True, False])
def test_epilogue_bf16_kernel_batches_and_ragged_rows(cuda_device, B, T, residual):
    """Kernel 1's bf16 leg (128-column items, double-buffered copies, the
    output staged in shared memory): T = 200, 50 and 17 end inside a
    128-row tile; within 1 bf16 ulp of the plain version, pad columns 0,
    two launches the same bits."""
    x, M, vecs, KB = _operands(B, T, 3392, cuda_device, seed=B * T)
    xb, KBb = x.to(torch.bfloat16), KB.to(torch.bfloat16)
    t1 = stgcn_fused.graph_matmul_bn_relu(xb, M.to(torch.bfloat16), vecs[0], vecs[1])
    xr = xb if residual else None
    got = stgcn_fused.fused_epilogue(t1, xr, vecs, KBb, residual=residual)
    again = stgcn_fused.fused_epilogue(t1, xr, vecs, KBb, residual=residual)
    ref = stgcn_fused.epilogue_merged_ref(t1, xr, vecs, KBb, residual=residual)
    torch.cuda.synchronize()
    _assert_bf16_close(got, ref)
    assert torch.all(got[..., 3392:] == 0)
    assert torch.equal(got, again)


def test_bf16_wrappers_reject_misaligned_or_strided(cuda_device):
    """A view that does not start on a 16-byte boundary, or is not
    contiguous, is refused before any launch (the kernels copy 16 bytes at a
    time)."""
    x, M, vecs, KB = _operands(2, 16, 192, cuda_device)
    xb, KBb = x.to(torch.bfloat16), KB.to(torch.bfloat16)
    t1 = stgcn_fused.graph_matmul_bn_relu(xb, M.to(torch.bfloat16), vecs[0], vecs[1])
    flat = torch.empty(t1.numel() + 8, dtype=torch.bfloat16, device=cuda_device)
    shifted = flat[1:1 + t1.numel()].view(t1.shape)
    shifted.copy_(t1)
    wide = torch.zeros(2, 16, 2 * t1.shape[-1], dtype=torch.bfloat16, device=cuda_device)[..., :t1.shape[-1]]
    before = dict(kernels.LAUNCHES)
    for bad in (shifted, wide):
        with pytest.raises(ValueError):
            stgcn_fused.fused_epilogue(bad, xb, vecs, KBb, residual=True)
        with pytest.raises(ValueError):
            stgcn_fused.fused_epilogue(t1, bad, vecs, KBb, residual=True)
    sx, tiles, svecs, col_off, vlist, _ = _sparse_operands(1, 16, SPARSE_JOINT_ORDER, cuda_device)
    sxb = sx.to(torch.bfloat16)
    flat = torch.empty(sxb.numel() + 8, dtype=torch.bfloat16, device=cuda_device)
    shifted = flat[1:1 + sxb.numel()].view(sxb.shape)
    for bad in (shifted, torch.cat([sxb, sxb], -1)[..., ::2]):
        with pytest.raises(ValueError):
            stgcn_sparse.sparse_graph_matmul_bn_relu(bad, tiles.to(torch.bfloat16), svecs, col_off, vlist)
    assert dict(kernels.LAUNCHES) == before


def test_bf16_wrappers_reject_mixed_dtypes(cuda_device):
    x, M, vecs, KB = _operands(2, 16, 192, cuda_device)
    xb = x.to(torch.bfloat16)
    t1 = stgcn_fused.graph_matmul_bn_relu(xb, M.to(torch.bfloat16), vecs[0], vecs[1])
    with pytest.raises(TypeError):  # taps in f32 with a bf16 chain
        stgcn_fused.fused_epilogue(t1, xb, vecs, KB, residual=True)
    with pytest.raises(TypeError):  # per-column vectors stay f32
        stgcn_fused.fused_epilogue(t1, xb, vecs.to(torch.bfloat16), KB.to(torch.bfloat16), residual=True)
    sx, tiles, svecs, col_off, vlist, _ = _sparse_operands(1, 16, SPARSE_JOINT_ORDER, cuda_device)
    with pytest.raises(TypeError):
        stgcn_sparse.sparse_graph_matmul_bn_relu(sx.to(torch.bfloat16), tiles, svecs, col_off, vlist)


@pytest.mark.parametrize("sparse", [False, True])
def test_generate_bf16_card_matches_cpu_small(cuda_device, sparse):
    cfg = P2RNetConfig(num_frames=96, num_seeds=64, num_proposals=16, num_gaussian=10,
                       compute_dtype="bfloat16", sparse_eval=sparse)
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 96, 53, 3) * 0.4).astype(np.float32)
    x[..., 0] += np.linspace(0, 3, 96, dtype=np.float32)[None, :, None]
    gpu = P2RNet(cfg, device=cuda_device)
    cpu = P2RNet(cfg, device="cpu")
    kernels.reset_launch_counts()
    a = gpu.generate(torch.from_numpy(x).to(cuda_device), folded=gpu.fold_eval())
    want = {"stgcn_epilogue_bf16": 6, "fps": 1}
    if sparse:
        want["stgcn_sparse_bf16"] = 6
    assert dict(kernels.LAUNCHES) == want
    b = cpu.generate(torch.from_numpy(x), folded=cpu.fold_eval())
    assert torch.equal(a["seed_inds"].cpu(), b["seed_inds"])
    for key in ("seed_features", "vote_xyz"):
        ref = b[key].float()
        assert (a[key].cpu().float() - ref).abs().max().item() <= 1e-2 * ref.abs().max().item(), key


def _train_operands_bf16(B, T, W0, dev, seed=0):
    """Kernel 3/4 operands in bf16 (y, dy2, KB; vecs f32)."""
    y, dy2, vecs, KB = _train_operands(B, T, W0, dev, seed)
    return y.to(torch.bfloat16), dy2.to(torch.bfloat16), vecs, KB.to(torch.bfloat16)


@pytest.mark.parametrize("B,T,W0", [(1, 768, 3392), (8, 768, 3392), (2, 50, 3392), (3, 17, 320),
                                    (2, 200, 3392), (8, 130, 192)])
def test_train_fwd_bf16_kernel_matches_plain(cuda_device, B, T, W0):
    """T = 50 and 17: clips that 16 does not divide; 130: a 128-row tile
    whose second 64-row part of partials lies past the clip.  y2 within 1
    bf16 ulp of the plain version; the moments within 1e-5 of each column's
    scale of the float64 moments of the kernel's own rounded y2."""
    y, _, vecs, KB = _train_operands_bf16(B, T, W0, cuda_device)
    before = dict(kernels.LAUNCHES)
    y2, parts = stgcn_train.tconv_stats_fwd(y, vecs, KB, T=T)
    assert kernels.LAUNCHES["stgcn_train_fwd_bf16"] == before.get("stgcn_train_fwd_bf16", 0) + 1
    assert kernels.LAUNCHES["stgcn_train_fwd"] == before.get("stgcn_train_fwd", 0)
    y2_ref, _ = stgcn_train.tconv_stats_fwd_ref(y, vecs, KB, T=T)
    torch.cuda.synchronize()
    _assert_bf16_close(y2, y2_ref)
    v = y2.double().reshape(B, T, -1)
    own = torch.stack([v.sum(1), (v * v).sum(1)], dim=1)
    _assert_parts_close(parts.double(), own, [v.abs().sum(1), (v * v).sum(1)])
    assert torch.all(y2[:, W0:] == 0) and torch.all(parts[..., W0:] == 0)
    again = stgcn_train.tconv_stats_fwd(y, vecs, KB, T=T)
    assert torch.equal(y2, again[0]) and torch.equal(parts, again[1])


@pytest.mark.parametrize("B,T,W0", [(1, 768, 3392), (8, 768, 3392), (2, 50, 3392), (3, 17, 320),
                                    (2, 200, 3392)])
def test_train_bwd_bf16_kernel_matches_plain(cuda_device, B, T, W0):
    """dpre within 1 bf16 ulp of the plain version, its moments (of the
    unrounded dpre) within 1e-5 of each column's scale, dtaps within 1e-4
    of its max; pad columns 0; the same bits on relaunch."""
    y, dy2, vecs, KB = _train_operands_bf16(B, T, W0, cuda_device)
    vecs[2] = 0.0
    KBT = KB.transpose(1, 2).contiguous()
    before = dict(kernels.LAUNCHES)
    dpre, parts, dtaps = stgcn_train.tconv_bwd(dy2, y, vecs, KBT, T=T, C=64)
    assert kernels.LAUNCHES["stgcn_train_bwd_bf16"] == before.get("stgcn_train_bwd_bf16", 0) + 1
    assert kernels.LAUNCHES["stgcn_train_bwd"] == before.get("stgcn_train_bwd", 0)
    dpre_ref, parts_ref, dkb_ref = stgcn_train.tconv_bwd_ref(dy2, y, vecs, KBT, T=T)
    dtaps_ref = stgcn_train._fold_diag_blocks(dkb_ref, 64)
    torch.cuda.synchronize()
    _assert_bf16_close(dpre, dpre_ref)
    d3, y3 = dpre_ref.float().reshape(B, T, -1), y.float().reshape(B, T, -1)
    _assert_parts_close(parts, parts_ref, [d3.abs().sum(1), (d3 * y3).abs().sum(1)])
    torch.testing.assert_close(dtaps, dtaps_ref, atol=1e-4 * dtaps_ref.abs().max().item(), rtol=0)
    assert torch.all(dpre[:, W0:] == 0) and torch.all(parts[..., W0:] == 0)
    again = stgcn_train.tconv_bwd(dy2, y, vecs, KBT, T=T, C=64)
    assert all(torch.equal(a, b) for a, b in zip((dpre, parts, dtaps), again))


@pytest.mark.parametrize("T", [768, 130, 50, 17])
@pytest.mark.parametrize("B", [1, 8, 32])
def test_train_bf16_legs_batches_and_ragged_rows(cuda_device, B, T):
    """Both bf16 legs (items of 128 rows x 64 columns on a persistent grid
    of two 8-warp blocks an SM, double-buffered copies; kernel 3's y2
    staged in shared memory and stored 16 bytes a thread, kernel 4's dpre
    stored from the registers) at full width for batches that leave the grid part idle or walk many items
    and clips that 128 does not divide: y2 and dpre within 1 bf16 ulp of
    the plain versions, kernel 3's moments within 1e-5 of each column's
    scale of the float64 moments of its own y2, kernel 4's (of the
    unrounded dpre) within 5e-7 of the sum of their terms' |a*b| of float64
    (the plain version's own f32 dt1 differs by more where dt1 cancels), the
    tap gradient within 1e-4 of its max, pad columns 0 in every output, the
    same bits on relaunch."""
    W0 = 3392
    y, dy2, vecs, KB = _train_operands_bf16(B, T, W0, cuda_device, seed=B + T)
    y2, parts = stgcn_train.tconv_stats_fwd(y, vecs, KB, T=T)
    y2_ref, _ = stgcn_train.tconv_stats_fwd_ref(y, vecs, KB, T=T)
    vecs_b = vecs.clone()
    vecs_b[2] = 0.0
    KBT = KB.transpose(1, 2).contiguous()
    dpre, dparts, dtaps = stgcn_train.tconv_bwd(dy2, y, vecs_b, KBT, T=T, C=64)
    dpre_ref, _, dkb_ref = stgcn_train.tconv_bwd_ref(dy2, y, vecs_b, KBT, T=T)
    dtaps_ref = stgcn_train._fold_diag_blocks(dkb_ref, 64)
    torch.cuda.synchronize()
    _assert_bf16_close(y2, y2_ref)
    v = y2.double().reshape(B, T, -1)
    _assert_parts_close(parts.double(), torch.stack([v.sum(1), (v * v).sum(1)], dim=1),
                        [v.abs().sum(1), (v * v).sum(1)])
    _assert_bf16_close(dpre, dpre_ref)
    live = (y.float() * vecs_b[0] + vecs_b[1] > 0).reshape(B, T, -1)
    d, K, y3 = dy2.double().reshape(B, T, -1), KBT.double(), y.double().reshape(B, T, -1)
    exact = mag = 0.0
    for s, ds in enumerate((stgcn_fused.shift_next(d), d, stgcn_fused.shift_prev(d))):
        exact = exact + stgcn_fused.tconv_group(ds, K[s])
        mag = mag + stgcn_fused.tconv_group(ds.abs(), K[s].abs())
    exact, mag = exact * live, mag * live
    m_exact = torch.stack([exact.sum(1), (exact * y3).sum(1)], dim=1)
    m_mag = torch.stack([mag.sum(1), (mag * y3.abs()).sum(1)], dim=1)
    used = m_mag > 0
    assert ((dparts.double() - m_exact).abs()[used] / m_mag[used]).max().item() <= 5e-7
    assert torch.all(dparts[~used] == 0)
    del d, K, y3, exact, mag, m_exact, m_mag, live
    torch.testing.assert_close(dtaps, dtaps_ref, atol=1e-4 * dtaps_ref.abs().max().item(), rtol=0)
    for out in (y2, dpre):
        assert torch.all(out[:, W0:] == 0)
    assert torch.all(parts[..., W0:] == 0) and torch.all(dparts[..., W0:] == 0)
    again = stgcn_train.tconv_stats_fwd(y, vecs, KB, T=T) + stgcn_train.tconv_bwd(dy2, y, vecs_b, KBT, T=T, C=64)
    assert all(torch.equal(a, b) for a, b in zip((y2, parts, dpre, dparts, dtaps), again))


@pytest.mark.parametrize("B,T", [(2, 768), (3, 50)])
def test_train_bf16_legs_agree_on_the_relu_mask(cuda_device, B, T):
    """Kernel 3's t1 and kernel 4's ReLU mask come from the same f32 y * s1 +
    sh1 (a product, then a sum): with the middle tap the identity and the
    others zero, y2 = t1 and dt1 = dy2 exactly, so y2 > 0 exactly where
    kernel 4 lets dy2 (nonzero everywhere in the joints) through."""
    W0 = 3392
    y, _, vecs, _ = _train_operands_bf16(B, T, W0, cuda_device, seed=7)
    vecs[2] = 0.0
    KB = torch.zeros(3, 128, 128, device=cuda_device)
    KB[1] = torch.eye(128, device=cuda_device)
    KB = KB.to(torch.bfloat16)
    dy2 = torch.zeros_like(y)
    dy2[:, :W0] = 1.0
    y2, _ = stgcn_train.tconv_stats_fwd(y, vecs, KB, T=T)
    dpre, _, _ = stgcn_train.tconv_bwd(dy2, y, vecs, KB.transpose(1, 2).contiguous(), T=T, C=64)
    torch.cuda.synchronize()
    t1 = torch.relu(y.float() * vecs[0] + vecs[1]).to(torch.bfloat16)
    assert torch.equal(y2, t1)
    assert torch.equal(y2[:, :W0] > 0, dpre[:, :W0] != 0)
    assert 0.2 < (dpre[:, :W0] != 0).double().mean().item() < 0.8


def test_train_bf16_wrappers_reject_bad_operands(cuda_device):
    y, dy2, vecs, KB = _train_operands_bf16(2, 16, 192, cuda_device)
    KBT = KB.transpose(1, 2).contiguous()
    with pytest.raises(TypeError):  # float16 has no leg
        stgcn_train.tconv_stats_fwd(y.half(), vecs, KB.half(), T=16)
    with pytest.raises(TypeError):  # taps in f32 with a bf16 chain
        stgcn_train.tconv_stats_fwd(y, vecs, KB.float(), T=16)
    with pytest.raises(TypeError):  # per-column vectors stay f32
        stgcn_train.tconv_stats_fwd(y, vecs.to(torch.bfloat16), KB, T=16)
    with pytest.raises(TypeError):  # dy2 in f32 with a bf16 y
        stgcn_train.tconv_bwd(dy2.float(), y, vecs, KBT, T=16, C=64)
    with pytest.raises(TypeError):
        stgcn_train.tconv_bwd(dy2.half(), y.half(), vecs, KBT.half(), T=16, C=64)


def _bulk_ok(a, b):
    """The JAX package's bulk band for tensors that cross bf16 roundings at
    other points (tests/test_stgcn_train.py:270-283): errors over
    max(|b|, 1e-3), median < 3e-2, under 2% beyond 7e-2, max < 0.5."""
    err = (a.double() - b.double()).abs() / max(b.double().abs().max().item(), 1e-3)
    return err.median().item() < 3e-2 and (err > 7e-2).double().mean().item() < 0.02 and err.max().item() < 0.5


def test_fused_train_layer_bf16_card_matches_cpu(cuda_device):
    """The bf16 custom-backward block on the card against the CPU (plain
    versions).  The two sum y = x @ M in other orders, so some of y's bf16
    roundings differ and every rounding and ReLU downstream can amplify
    one (an output near a cancellation moves many ulps; a flipped ReLU
    mask moves dx by the incoming gradient).  So: at most 1e-3 of the
    output's elements differ, the output and each gradient in the JAX
    package's bulk band, the statistics within 1e-3 of their max; one
    launch of each bf16 train leg and none of the f32 legs."""
    V, C, T, B = 53, 64, 64, 2
    W0, Wp = V * C, 3456
    g = torch.Generator().manual_seed(1)
    x = torch.zeros(B, T, Wp)
    x[..., :W0] = torch.randn(B, T, W0, generator=g) * 0.6
    M = torch.zeros(Wp, Wp)
    M[:W0, :W0] = torch.randn(W0, W0, generator=g) * 0.02
    bias_col = torch.zeros(Wp)
    bias_col[:W0] = torch.randn(W0, generator=g) * 0.1
    rest = [0.7 + torch.rand(C, generator=g), torch.randn(C, generator=g) * 0.2,
            torch.randn(3, C, C, generator=g) * 0.15, torch.randn(C, generator=g) * 0.1,
            0.7 + torch.rand(C, generator=g), torch.randn(C, generator=g) * 0.2]
    w = torch.randn(B, T, Wp, generator=g).to(torch.bfloat16).float()
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        args = [t.to(dev).to(torch.bfloat16 if i < 2 else torch.float32).requires_grad_()
                for i, t in enumerate([x, M, bias_col, *rest])]
        kernels.reset_launch_counts()
        outs = stgcn_train.FusedTrainLayer.apply(*args, True, V, C, T)
        (outs[0].float() * w.to(dev)).sum().backward()
        if dev.type == "cuda":
            assert dict(kernels.LAUNCHES) == {"stgcn_train_fwd_bf16": 1, "stgcn_train_bwd_bf16": 1}
        results.append(([o.detach().cpu() for o in outs], [a.grad.cpu().float() for a in args]))
    (outs_g, grads_g), (outs_c, grads_c) = results
    assert outs_g[0].dtype == torch.bfloat16
    assert (outs_g[0] != outs_c[0]).double().mean().item() <= 1e-3
    assert _bulk_ok(outs_g[0], outs_c[0])
    for a, b in zip(outs_g[1:], outs_c[1:]):
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item()
    for i, (a, b) in enumerate(zip(grads_g, grads_c)):
        if i != 6:
            assert _bulk_ok(a, b), f"grad {i}"
    assert torch.all(grads_g[6] == 0)  # conv bias: the analytic zero


def test_train_options_on_card(cuda_device, tmp_path, monkeypatch):
    """A SMALL train run on the card with ``train.freeze: [backbone]``,
    ``h2d_dtype: float16`` and ``profile_steps: 1`` (4 train steps of 1, 1
    val step of 2): 6 train_fwd + 6 train_bwd + 1 fps launches a train step
    (the frozen backbone still gets its backward), 6 epilogue + 1 fps a val
    step; every backbone parameter bit-identical; the trace names the three
    hand-written train kernels."""
    import glob
    import os

    import yaml

    from pose2room_tpu_torch.config.loader import CONFIG
    from pose2room_tpu_torch.data import synth
    from pose2room_tpu_torch.data.dataset import SceneDataset
    from pose2room_tpu_torch.runners import train as train_runner

    monkeypatch.chdir(tmp_path)  # the TensorBoard board writes to ./runs
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    config = yaml.safe_load(open(os.path.join(repo, "configs", "config_files", "p2rnet_train.yaml")))
    config["data"].update(num_frames=96, num_seeds=64, num_target=16, num_gaussian=10)
    config["train"].update(epochs=1, batch_size=1, freeze=["backbone"], h2d_dtype="float16")
    config["val"]["batch_size"] = 2
    config["optimizer"]["weight_decay"] = 0.01
    config["log"].update(path=str(tmp_path / "out"), profile_steps=1)
    rng = np.random.RandomState(2)
    scenes = [synth.as_stored(*synth.make_scene(rng, n_objects=3, n_frames=120)) for _ in range(6)]
    datasets = {"train": SceneDataset(scenes[:4], num_frames=96, augment=True),
                "val": SceneDataset(scenes[4:], num_frames=96)}
    initial = P2RNet(P2RNetConfig(num_frames=96, num_seeds=64, num_proposals=16, num_gaussian=10), device="cpu",
                     generator=torch.Generator().manual_seed(42)).state_dict()
    cfg = CONFIG(config, mode="train")
    try:
        kernels.reset_launch_counts()
        model, history = train_runner.run(cfg, device=cuda_device, datasets=datasets)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    finally:
        cfg.close()
    assert launches == {"stgcn_train_fwd": 24, "stgcn_train_bwd": 24, "stgcn_epilogue": 6, "fps": 5}
    assert np.isfinite(history[0]["train"]["total"])
    final = model.state_dict()
    names = [k for k, _ in model.named_parameters()]
    for k in names:
        if k.startswith("backbone."):
            assert torch.equal(final[k].cpu(), initial[k]), k
    # a head whose loss term has no positive proposal yet keeps a zero gradient
    moved = [k for k in names if not k.startswith("backbone.") and not torch.equal(final[k].cpu(), initial[k])]
    assert len(moved) > len([k for k in names if not k.startswith("backbone.")]) // 2
    (trace,) = glob.glob(os.path.join(cfg.save_path, "profile", "*.pt.trace.json"))
    with open(trace) as f:
        text = f.read()
    for name in ("train_fwd_kernel", "train_bwd_kernel", "fps_kernel"):
        assert name in text, name


# ---------------------------------------------------------------------------
# data parallel on the card: ranks spawned by tests/torch_ddp_worker.py
# ---------------------------------------------------------------------------

def _card_steps_case(B=4, seed=3):
    """SMALL-size weights, a batch of B synthetic clips and its MDN noise."""
    from pose2room_tpu_torch.data import synth
    from pose2room_tpu_torch.data.dataset import SceneDataset
    from pose2room_tpu_torch.data.loader import collate

    sizes = dict(num_frames=96, num_seeds=64, num_proposals=16, num_gaussian=10)
    rng = np.random.RandomState(seed)
    scenes = [synth.as_stored(*synth.make_scene(rng, n_objects=3, n_frames=120)) for _ in range(B)]
    dataset = SceneDataset(scenes, num_frames=sizes["num_frames"])
    batch = collate([dataset[i] for i in range(B)])
    batch.pop("sample_idx")
    model = P2RNet(P2RNetConfig(**sizes), device="cpu", generator=torch.Generator().manual_seed(seed))
    eps = {k: v.numpy() for k, v in model.mdn_eps(B, torch.Generator().manual_seed(seed + 1)).items()}
    return {"sizes": sizes, "state_dict": model.state_dict(), "batch": batch, "eps": eps,
            "optimizer": {"lr": 1e-3}}


def _one_process_steps(case, dev):
    """The card steps of torch_ddp_worker.card_steps in this process, on the
    whole batch."""
    from pose2room_tpu_torch.train.state import make_optimizer
    from pose2room_tpu_torch.train.step import batch_to_device, train_step

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        model = P2RNet(P2RNetConfig(**case["sizes"]), device=dev)
        model.load_state_dict(case["state_dict"])
        optimizer, _, _ = make_optimizer(model, case["optimizer"])
        batch = batch_to_device(case["batch"], dev)
        eps = {k: torch.from_numpy(v.copy()).to(dev) for k, v in case["eps"].items()}
        out = {"losses": [], "state": []}
        for i in range(2):
            losses, end_points = train_step(model, optimizer, batch, eps=eps)
            out["losses"].append({k: float(v) for k, v in losses.items()})
            if i == 0:
                out["grads"] = {k: p.grad.cpu() for k, p in model.named_parameters()}
                out["picks"] = {k: end_points[k].cpu() for k in ("seed_inds", "aggregated_vote_inds")}
            out["state"].append({k: v.cpu() for k, v in model.state_dict().items()})
        torch.cuda.synchronize()
        return out
    finally:
        torch.use_deterministic_algorithms(False)


def test_ddp_world_one_nccl_bit_equal(cuda_device, tmp_path):
    """One rank on NCCL (DDP with the summing hook, the collectives around
    kernels 3 and 4, the loss normalisers) equals the same two steps in one
    process bit for bit, with deterministic algorithms; 6 + 6 + 1 launches a
    step."""
    from torch_ddp_worker import Ranks

    case = _card_steps_case()
    ranks = Ranks(1, {"card_steps": case}, tmp_path, device="cuda")
    want = _one_process_steps(case, cuda_device)
    (got,) = [r["card_steps"] for r in ranks.results()]
    assert got["launches"] == {"stgcn_train_fwd": 12, "stgcn_train_bwd": 12, "fps": 2}
    assert got["losses"] == want["losses"]
    for k, v in want["grads"].items():
        assert torch.equal(got["grads"][k], v), k
    for i in range(2):
        for k, v in want["state"][i].items():
            assert torch.equal(got["state"][i][k], v), (i, k)


def _float64_grads(case):
    """The first step's gradients and discrete choices in one process on
    the CPU in float64: the referee of the f32 train band."""
    from pose2room_tpu_torch.train.state import make_optimizer
    from pose2room_tpu_torch.train.step import batch_to_device, train_step

    model = P2RNet(P2RNetConfig(**case["sizes"]), device="cpu").double()
    model.load_state_dict(case["state_dict"])
    optimizer, _, _ = make_optimizer(model, case["optimizer"])
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch_to_device(case["batch"], "cpu").items()}
    eps = {k: torch.from_numpy(v.copy()).double() for k, v in case["eps"].items()}
    _, end_points = train_step(model, optimizer, batch, eps=eps)
    return ({k: p.grad for k, p in model.named_parameters()},
            {k: end_points[k] for k in ("seed_inds", "aggregated_vote_inds")})


def test_ddp_world_two_gloo_on_one_card(cuda_device, tmp_path):
    """Two gloo ranks on cuda:0, 2 + 2, against one process at 4 on the same
    clips and noise: step-1 losses within 1e-4 relative; each gradient
    within 1e-3 of its max of the one process's, or no further from a CPU
    float64 step's than three times the one process's worst (ROADMAP §3's
    f32 train band); the running statistics after step 1 within 1e-4; both
    ranks' states bit-equal; 6 + 6 + 1 launches a step a rank.

    The band is the worst leaf's, not each leaf's own: at this size a ReLU
    input within rounding of zero can take another side in the two ranks
    than in one process, and every leaf upstream of it then moves by far
    more than one process's own error on that leaf, which has no such flip
    (ROADMAP §3).  The update through DDP is held in float64 by
    tests/test_torch_ddp.py."""
    from torch_ddp_worker import Ranks

    case = _card_steps_case()
    ranks = Ranks(2, {"card_steps": case}, tmp_path, device="cuda")
    want = _one_process_steps(case, cuda_device)
    grads64, picks64 = _float64_grads(case)
    got = [r["card_steps"] for r in ranks.results()]
    assert [g["card"] for g in got] == [0, 0]
    for g in got:
        assert g["launches"] == {"stgcn_train_fwd": 12, "stgcn_train_bwd": 12, "fps": 2}
    for i in range(2):
        for k, v in got[0]["state"][i].items():
            assert torch.equal(got[1]["state"][i][k], v), (i, k)

    def rel(a, b):
        return (a.double() - b.double()).abs().max().item() / max(b.double().abs().max().item(), 1e-30)

    for k, v in want["losses"][0].items():
        assert abs(got[0]["losses"][0][k] - v) <= 1e-4 * max(abs(v), 1e-3), k
    for k, v in picks64.items():
        assert torch.equal(want["picks"][k], v), k  # the referee takes the card's discrete choices
    held = [k for k in want["grads"] if not k.endswith("tcn.2.bias")]  # analytically zero
    worst = max(rel(want["grads"][k], grads64[k]) for k in held)
    for k in held:
        gap, err = rel(got[0]["grads"][k], want["grads"][k]), rel(got[0]["grads"][k], grads64[k])
        assert gap <= 1e-3 or err <= 3 * worst, (k, gap, err, worst)
    for k, v in want["state"][0].items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(got[0]["state"][0][k], v, atol=1e-4, rtol=1e-4, msg=k)


def test_tp_world_two_gloo_on_one_card(cuda_device, tmp_path):
    """device.model_parallel 2 on two gloo ranks on cuda:0, one model group
    computing the same 4 clips, against one process at 4 on the same clips
    and noise: step-1 losses within 1e-4 relative; each gradient (shards
    gathered) within 1e-3 of its max of the one process's, or no further
    from a CPU float64 step's than three times the one process's worst
    (test_ddp_world_two_gloo_on_one_card's band); running statistics after
    step 1 within 1e-4; each rank holds half of each of the 22 planned
    weights; the replicated tensors bit-equal on both ranks after two
    steps; 6 + 6 + 1 launches a step a rank."""
    from torch_ddp_worker import Ranks

    case = _card_steps_case()
    ranks = Ranks(2, {"tp_steps": dict(case, tp=2, paths=[True], device="cuda")}, tmp_path, device="cuda")
    want = _one_process_steps(case, cuda_device)
    grads64, picks64 = _float64_grads(case)
    got = [r["tp_steps"][True] for r in ranks.results()]
    for g in got:
        assert g["launches"] == {"stgcn_train_fwd": 12, "stgcn_train_bwd": 12, "fps": 2}
        halved = [k for k, shape in g["shapes"].items() if shape[0] * 2 == want["grads"][k].shape[0]]
        assert len(halved) == 22 and all(g["moment_shapes"][k] == g["shapes"][k] for k in halved)
    for k, v in got[0]["replicated"].items():
        assert torch.equal(got[1]["replicated"][k], v), k

    def rel(a, b):
        return (a.double() - b.double()).abs().max().item() / max(b.double().abs().max().item(), 1e-30)

    for k, v in want["losses"][0].items():
        assert abs(got[0]["losses"][0][k] - v) <= 1e-4 * max(abs(v), 1e-3), k
    for k, v in picks64.items():
        assert torch.equal(want["picks"][k], v), k  # the referee takes the card's discrete choices
    held = [k for k in want["grads"] if not k.endswith("tcn.2.bias")]  # analytically zero
    worst = max(rel(want["grads"][k], grads64[k]) for k in held)
    for k in held:
        gap, err = rel(got[0]["grads"][k], want["grads"][k]), rel(got[0]["grads"][k], grads64[k])
        assert gap <= 1e-3 or err <= 3 * worst, (k, gap, err, worst)
    for k, v in want["state"][0].items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(got[0]["state"][0][k], v, atol=1e-4, rtol=1e-4, msg=k)


def test_eval_nn_loss_card_matches_cpu(cuda_device):
    """eval_nn_loss on the card and on the CPU, same inputs: the assignments
    exactly equal, each term within 1e-4 relative."""
    from pose2room_tpu_torch.models.loss import eval_nn_assignment, eval_nn_loss

    g = torch.Generator().manual_seed(0)
    B, K, K2 = 8, 128, 10
    ep = {"center": torch.randn(B, K, 3, generator=g) * 2, "size": torch.randn(B, K, 3, generator=g),
          "heading": torch.randn(B, K, 2, generator=g), "sem_cls_scores": torch.randn(B, K, 22, generator=g)}
    mask = (torch.arange(K2)[None] < torch.randint(1, K2 + 1, (B, 1), generator=g)).float()
    gt = {"center_label": torch.randn(B, K2, 3, generator=g) * 2, "box_label_mask": mask,
          "size": torch.randn(B, K2, 3, generator=g), "heading": torch.randn(B, K2, 2, generator=g),
          "sem_cls_label": torch.randint(0, 22, (B, K2), generator=g)}
    card = lambda d: {k: v.to(cuda_device) for k, v in d.items()}  # noqa: E731
    got, want = eval_nn_loss(card(ep), card(gt)), eval_nn_loss(ep, gt)
    assert torch.equal(eval_nn_assignment(card(ep), card(gt))[1].cpu(), eval_nn_assignment(ep, gt)[1])
    for k, v in want.items():
        assert got[k].device.type == "cuda"
        assert abs(got[k].item() - v.item()) <= 1e-4 * max(abs(v.item()), 1e-6), k


@pytest.mark.parametrize("tf32", [False, True])
def test_three_nn_card_matches_cpu(cuda_device, tf32):
    """three_nn at B=8, 1024 unknowns, 256 known points with repeats: indices
    exactly equal on the card and the CPU, distances within 1e-5, also with
    TF32 switched on around the call (the flag is restored)."""
    from pose2room_tpu_torch.ops.interpolate import three_nn

    g = torch.Generator().manual_seed(1)
    unknown = torch.rand(8, 1024, 3, generator=g) * 8 - 4
    known = torch.rand(8, 256, 3, generator=g) * 8 - 4
    known[:, 100:110] = known[:, 10:20]
    want_d, want_i = three_nn(unknown, known)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        got_d, got_i = three_nn(unknown.to(cuda_device), known.to(cuda_device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert torch.equal(got_i.cpu(), want_i)
    torch.testing.assert_close(got_d.cpu(), want_d, atol=1e-5, rtol=1e-5)
