"""The dense graph GEMM of the f32 eval chain (csrc/stgcn_graph_gemm.cu), on
the CPU: the wrapper's dispatch and checks, the fold-time split of its B
operand, and its arithmetic emulated in its own order.

On a card, ``stgcn_fused.graph_gemm_bn_relu`` computes
relu((x @ M) * s1 + b1) in 3xTF32 on wgmma: each operand split into TF32
big and small halves (tconv_mma.cuh's split; B's once, at fold time, by
``gemm_b_operand``), three products a k8 step into a fresh tensor-core
accumulator whose adds truncate, folded into the f32 sum every
``SHIPPED_FOLD`` k8 steps.  The emulation (tests/torch_kernel_cases.py)
shows that:

* one full-width block at B=1, block 0 (K = 3392) and a residual block
  (K = 3456), stays within 2e-6 of sum |a*b| of float64, as the other 3xTF32
  kernels' tests hold, and its t1 within that of the plain version's;
* with the emulated product patched in, the SMALL dense ``generate`` meets
  the ``assert_generate_close`` bands against the JAX package, indices
  equal.

The kernel on the card against the plain version, and its launch counts,
are tests/test_torch_gpu.py's ``test_graph_gemm_*``.
"""

import numpy as np
import pytest
import torch

from pose2room_tpu_torch import kernels
from pose2room_tpu_torch.ops import stgcn_fused
from torch_golden import goldens  # noqa: F401  (a fixture)
from torch_kernel_cases import emulated_graph_gemm_acc, split
from torch_port_util import SMALL, assert_generate_close, port_model, to_numpy, walking_clip

SHIPPED_FOLD = 4  # csrc/stgcn_graph_gemm.cu: kFold
W0, WP = 3392, 3456


def _operands(seed, N, K, Ncols=WP):
    """x (N, K) >= 0 as after a ReLU, M (K, Ncols) zero past W0 in both
    dimensions (the fold's pad), s1, b1 zero at the pad columns."""
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn(N, K, generator=g))
    M = torch.zeros(K, Ncols)
    M[:min(K, W0), :min(Ncols, W0)] = torch.randn(min(K, W0), min(Ncols, W0), generator=g) * 0.02
    s1, b1 = torch.zeros(Ncols), torch.zeros(Ncols)
    s1[:W0] = 0.5 + torch.rand(min(Ncols, W0), generator=g)
    b1[:W0] = torch.randn(min(Ncols, W0), generator=g) * 0.1
    return x, M, s1, b1


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version(dtype):
    x, M, s1, b1 = _operands(0, 40, 256, 256)
    x, M = x.to(dtype).reshape(2, 20, 256), M.to(dtype)
    kernels.reset_launch_counts()
    got = stgcn_fused.graph_gemm_bn_relu(x, M, s1, b1)
    assert sum(kernels.LAUNCHES.values()) == 0
    assert got.dtype == dtype
    assert torch.equal(got, stgcn_fused.graph_matmul_bn_relu(x, M, s1, b1))


def test_wrapper_refuses_a_device_without_kernel():
    x = torch.empty(1, 8, 256, device="meta")
    M = torch.empty(256, 256, device="meta")
    with pytest.raises(ValueError, match="no graph GEMM kernel"):
        stgcn_fused.graph_gemm_bn_relu(x, M, torch.empty(256, device="meta"), torch.empty(256, device="meta"))


def _checked(K=256, Kb=256, Ncols=384, dtype=torch.float32, halves=2, vec=384, offset=0, transpose=False):
    """Operands for ``check_graph_gemm_operands``, with one thing wrong."""
    x = torch.zeros(2 * 8 * K + offset, dtype=dtype)[offset:].view(2, 8, K)
    if transpose:
        x = x.transpose(0, 1)
    return x, torch.zeros(halves, Ncols, Kb), torch.zeros(vec), torch.zeros(vec)


def test_check_accepts_block_zero_against_the_fold_operand():
    """Block 0: K = 3392 against the fold's B operand of K = 3456."""
    stgcn_fused.check_graph_gemm_operands(*_checked(K=W0, Kb=WP, Ncols=WP, vec=WP))


@pytest.mark.parametrize("bad,error", [
    (dict(K=240), ValueError),              # K not a multiple of 32
    (dict(K=288, Kb=256), ValueError),      # K past Kb
    (dict(Ncols=256, vec=256), ValueError),  # Ncols not a multiple of the 192-column tile
    (dict(halves=3), ValueError),           # not a big and a small half
    (dict(vec=128), ValueError),            # s1 of another width
    (dict(dtype=torch.float64), TypeError),
    (dict(offset=1), ValueError),           # off the 16-byte boundary TMA needs
    (dict(transpose=True), ValueError),     # not contiguous
])
def test_check_refuses_bad_operands(bad, error):
    with pytest.raises(error):
        stgcn_fused.check_graph_gemm_operands(*_checked(**bad))


# ---------------------------------------------------------------------------
# the fold-time split of B
# ---------------------------------------------------------------------------

def test_gemm_b_operand_is_the_kernel_split_of_m_transposed():
    """(2, Ncols, K): Mᵀ's TF32 big half, then its small half, the bits of
    tconv_mma.cuh's split; big + small is M to the split's precision."""
    _, M, _, _ = _operands(1, 8, WP)
    M[:4, :3] = torch.tensor([[1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -12), 0.0]] * 4)  # ties away from zero
    b = stgcn_fused.gemm_b_operand(M)
    assert b.shape == (2, WP, WP) and b.dtype == torch.float32 and b.is_contiguous()
    big, small = split(M.t().numpy())
    assert np.array_equal(b[0].numpy().view(np.uint32), big.view(np.uint32))
    assert np.array_equal(b[1].numpy().view(np.uint32), small.view(np.uint32))
    assert torch.all(b.view(torch.int32) & 0x1FFF == 0)  # both halves TF32: 10 explicit mantissa bits
    m = M.t().double()
    assert torch.all((m - b[0].double() - b[1].double()).abs() <= 2.0 ** -21 * m.abs())
    assert torch.all(b[1].abs() <= 2.0 ** -11 * b[0].abs())
    assert torch.all(b[:, W0:] == 0)  # pad columns of M give zero rows
    with pytest.raises(TypeError):
        stgcn_fused.gemm_b_operand(M.to(torch.bfloat16))


def test_cpu_fold_builds_no_gemm_operand():
    """The B operand is the kernel's alone: a CPU fold leaves it out (the
    card's fold holds 6 x 95.6 MB of it; tests/test_torch_gpu.py)."""
    from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig

    model = P2RNet(P2RNetConfig(num_frames=96, num_seeds=64, num_proposals=16, num_gaussian=10), device="cpu")
    folded = model.fold_eval()
    assert folded["gemm_b"] is None and len(folded["blocks"]) == 6


# ---------------------------------------------------------------------------
# the arithmetic, in the kernel's order
# ---------------------------------------------------------------------------

COLS = np.r_[0:128, WP - 128:WP]  # the first and the last column tile (its last 64 columns the pad)


@pytest.fixture(scope="module", params=[W0, WP], ids=["block0", "residual"])
def full_b1(request):
    """One full-width block at B=1 (768 rows, the whole K) on the first and
    the last 128-column tile; float64's product and sum |a*b| beside it."""
    K = request.param
    x, M, s1, b1 = _operands(5, 768, K)
    M, s1, b1 = M[:, COLS].contiguous(), s1[COLS], b1[COLS]
    xd, Md = x.double(), M.double()
    return x, M, s1, b1, xd @ Md, xd.abs() @ Md.abs()


@pytest.mark.parametrize("fold", [SHIPPED_FOLD, 2, 1])
def test_emulated_graph_gemm_within_2e6_of_float64(full_b1, fold):
    """The shipped fold cadence and the two shorter ones: the f32 sum within
    2e-6 of sum |a*b| of float64, its bias far inside; the pad columns
    exactly 0; t1 (BN1 and the ReLU in f32, a product then a sum) within
    that of the plain version's, whose own product is f32 too."""
    x, M, s1, b1, exact, mag = full_b1
    acc = emulated_graph_gemm_acc(x, M, fold)
    live = mag > 0
    rel = (acc.double() - exact)[live] / mag[live]
    assert rel.abs().max().item() <= 2e-6
    assert abs(rel.mean().item()) <= 2e-8
    assert torch.all(acc[:, 192:] == 0)  # columns 3392.. of the last tile
    t1 = torch.relu(acc * s1 + b1)
    plain = stgcn_fused.graph_matmul_bn_relu(x, M, s1, b1)
    t1_exact = torch.relu(exact * s1.double() + b1.double())
    bound = 2e-6 * s1.double().abs() * mag + 2.0 ** -22 * ((exact * s1.double()).abs() + b1.double().abs()) + 1e-30
    assert torch.all((t1.double() - t1_exact).abs() <= bound)
    assert torch.all((plain.double() - t1_exact).abs() <= bound)
    assert torch.all(t1[:, 192:] == 0)


def test_generate_small_with_emulated_graph_gemm_matches_jax(goldens, monkeypatch):
    """The SMALL dense eval chain with the graph GEMM's 3xTF32 product in
    all six blocks: indices equal to the JAX package's, floats in its
    bands."""
    payload = goldens.flax_payload(SMALL["num_gaussian"], seed=3)
    x = walking_clip(np.random.RandomState(0), 2, SMALL["num_frames"])
    ref = goldens.jax_generate_small(False)  # JAX's generate on these weights and clips
    widths = []

    def emulated(h, M, s1, b1):
        widths.append(M.shape[0])
        B, T, K = h.shape
        acc = emulated_graph_gemm_acc(h.reshape(B * T, K), M, SHIPPED_FOLD)
        return torch.relu(acc * s1 + b1).reshape(B, T, -1)

    monkeypatch.setattr(stgcn_fused, "graph_matmul_bn_relu", emulated)
    model = port_model(SMALL, payload)
    got = to_numpy(model.generate(torch.from_numpy(x), folded=model.fold_eval()))
    assert widths == [W0] + [WP] * 5  # block 0 contracts the unpadded input
    assert_generate_close(got, ref)
