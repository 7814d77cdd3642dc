"""The arithmetic of kernels 1 and 3 (csrc/tconv_mma.cuh), emulated on the CPU.

On the card the ST-GCN temporal conv runs on the tensor cores in 3xTF32:
every operand a splits into big = rna_tf32(a) and small = rna_tf32(a - big),
and each k-step of 8 sums small*big, big*small and big*big into a fresh
fragment that an f32 add folds into the accumulator.  The emulation
(numpy, tests/torch_kernel_cases.py) rounds to 10 explicit mantissa bits
with ties away from zero, forms the products in float64 and rounds every
sum to f32; this file shows that:

* one full-width block at B=1 stays within 2e-6 of sum |a*b| of the plain
  f32 version (``epilogue_merged_ref``);
* with the emulated conv patched in for ``tconv_group``, the SMALL dense and
  sparse ``generate`` still meet the ``assert_generate_close`` bands against
  the JAX package, indices equal.
"""

import jax
import numpy as np
import pytest
import torch

from pose2room_tpu.models import P2RNet as JaxP2RNet
from pose2room_tpu_torch.ops import stgcn_fused
from torch_kernel_cases import KSTEP, emulated_kernel_tconv, kstep_accumulate, split
from torch_golden import goldens  # noqa: F401  (a fixture)
from torch_port_util import (
    SMALL,
    assert_generate_close,
    port_model,
    to_numpy,
    walking_clip,
)


def emulated_tconv_group(h, tap):
    """``stgcn_fused.tconv_group`` in 3xTF32: each 128-column group of h
    (B, T, Wp) times one (128, 128) tap, in k-steps of 8."""
    B, T, Wp = h.shape
    a = h.detach().cpu().numpy().reshape(-1, stgcn_fused.LANE)
    b = tap.detach().cpu().numpy()
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, stgcn_fused.LANE, KSTEP):
        acc = kstep_accumulate(acc, a[:, k0:k0 + KSTEP], b[k0:k0 + KSTEP])
    return torch.from_numpy(acc.reshape(B, T, Wp))


def _block_operands(rng, T=768, W0=3392):
    """One full-width block at B=1 in the fold's layout."""
    Wp = stgcn_fused.pad_merged(W0)
    t1 = np.zeros((1, T, Wp), np.float32)
    t1[..., :W0] = np.maximum(rng.randn(1, T, W0), 0)
    x = np.zeros((1, T, Wp), np.float32)
    x[..., :W0] = np.maximum(rng.randn(1, T, W0), 0)
    vecs = np.zeros((8, Wp), np.float32)
    vecs[2, :W0] = rng.uniform(0.5, 1.5, W0)
    vecs[3, :W0] = rng.randn(W0) * 0.1
    taps = (rng.randn(3, 64, 64) * 0.1).astype(np.float32)
    KB = np.einsum("sio,pq->spiqo", taps, np.eye(2, dtype=np.float32)).reshape(3, 128, 128)
    return t1, x, vecs, KB


def _magnitude(t1, KB):
    """sum_s sum_k |t1[t+s-1, k]| |KB[s][k, n]| of the block, float64 (B=1)."""
    h = torch.from_numpy(np.abs(t1)).double()
    Ka = torch.from_numpy(np.abs(KB)).double()
    return (stgcn_fused.tconv_group(stgcn_fused.shift_prev(h), Ka[0]) + stgcn_fused.tconv_group(h, Ka[1])
            + stgcn_fused.tconv_group(stgcn_fused.shift_next(h), Ka[2]))[0].numpy()


def test_split_is_exact_to_tf32_bits(rng):
    a = (rng.randn(4096) * np.exp(rng.uniform(-20, 20, 4096))).astype(np.float32)
    a[:3] = [0.0, 1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -12)]  # a tie rounds away from zero
    big, small = split(a)
    assert big[1] == np.float32(1.0 + 2.0 ** -10) and big[2] == np.float32(-(1.0 + 2.0 ** -10))
    for part in (big, small):  # 10 explicit mantissa bits at most
        assert np.all(part.view(np.uint32) & np.uint32(0x1FFF) == 0)
    # big + small is a to ~2^-22 relative; the dropped bits are below small's precision
    np.testing.assert_array_less(np.abs(a.astype(np.float64) - big - small),
                                 2.0 ** -21 * np.abs(a.astype(np.float64)) + 1e-45)
    assert np.all(np.abs(small) <= 2.0 ** -11 * np.abs(big) + 1e-45)


@pytest.mark.parametrize("residual", [True, False])
def test_emulated_block_within_2e6_of_plain(rng, residual):
    """One full-width block at B=1: the kernels' 3xTF32 conv against the plain
    f32 one, and the epilogue with it against ``epilogue_merged_ref``."""
    t1, x, vecs, KB = _block_operands(rng)
    mag = _magnitude(t1, KB)
    emu = emulated_kernel_tconv(t1[0], KB)
    T1, KBt = torch.from_numpy(t1), torch.from_numpy(KB)
    plain = (stgcn_fused.tconv_group(stgcn_fused.shift_prev(T1), KBt[0]) + stgcn_fused.tconv_group(T1, KBt[1])
             + stgcn_fused.tconv_group(stgcn_fused.shift_next(T1), KBt[2]))[0].numpy()
    exact = (stgcn_fused.tconv_group(stgcn_fused.shift_prev(T1.double()), KBt[0].double())
             + stgcn_fused.tconv_group(T1.double(), KBt[1].double())
             + stgcn_fused.tconv_group(stgcn_fused.shift_next(T1.double()), KBt[2].double()))[0].numpy()
    live = mag > 0
    assert np.max(np.abs(emu - plain)[live] / mag[live]) <= 2e-6
    assert np.max(np.abs(emu - exact)[live] / mag[live]) <= 1e-6
    assert np.all(emu[~live] == 0)  # pad columns stay exactly 0

    xt = torch.from_numpy(x) if residual else None
    ref = stgcn_fused.epilogue_merged_ref(T1, xt, torch.from_numpy(vecs), KBt, residual=residual)[0].numpy()
    out = np.asarray(vecs[2] * emu + vecs[3], np.float32)
    if residual:
        out = out + x[0]
    out = np.maximum(out, 0)
    # the affine, the residual add and the ReLU move a difference by at most
    # |s2| times itself plus the rounding of the output
    bound = 2e-6 * np.abs(vecs[2]) * mag + 2.0 ** -23 * np.abs(ref)
    assert np.all(np.abs(out - ref) <= bound)


@pytest.mark.parametrize("sparse_eval", [False, True])
def test_generate_small_with_emulated_tconv_matches_jax(goldens, monkeypatch, sparse_eval):
    """The dense and the sparse eval chains at SMALL with the 3xTF32 conv in
    every block: indices equal to the JAX package's, floats in its bands."""
    payload = goldens.flax_payload(SMALL["num_gaussian"], seed=3)
    x = walking_clip(np.random.RandomState(0), 2, SMALL["num_frames"])
    ref = goldens.jax_generate_small(sparse_eval)  # JAX's generate on these weights and clips
    calls = []

    def counted(h, tap):
        calls.append(h.shape)
        return emulated_tconv_group(h, tap)

    monkeypatch.setattr(stgcn_fused, "tconv_group", counted)
    model = port_model(SMALL, payload, sparse_eval=sparse_eval)
    got = to_numpy(model.generate(torch.from_numpy(x), folded=model.fold_eval()))
    assert len(calls) == 6 * 3  # three taps in each of the six blocks
    assert_generate_close(got, ref)
