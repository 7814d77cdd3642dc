#!/usr/bin/env python3
"""Design variants of the bf16 legs of kernels 5 (block-sparse graph matmul,
on wgmma) and 1 (ST-GCN epilogue) on a card.

    python3 scripts/torch_bf16_variants.py [--parent DIR] [--generate] [variant ...]

Each variant is csrc/ with a text patch applied to one source, built with
the package's nvcc flags into pose2room_tpu_torch/_build/variants/bf16/ and
swapped in for the package's library, so the ops wrappers drive it as they
drive the shipped kernel; the shipped sources are not touched.  ``--parent
DIR`` adds the variant ``parent``: the csrc/ directory DIR (another tree's
kernels, e.g. the parent commit's from ``git archive``), which must keep the
same C entry points.  Variants (default: all, in turns base, ..., base):

* base        the shipped kernels;
* fold1, fold2  kernel 5 sums 1 or 2 k16 steps in one fresh accumulator
              before the IEEE fold (4 ship: one fold a stage);
* ring4, ring5  kernel 5 with a 4- or 5-stage ring (2 or 3 stages in
              flight; 6 ships, 4 in flight);
* nosplitk    kernel 5 never cuts a CSR list (at B=1 one unit per output
              tile and row block);
* waves2, waves3  kernel 5's bf16 leg cuts its lists so that the chunks
              fill the card about twice or three times (once ships);
* warps8      kernel 1 on 8 warps of 32 rows (16 of 16 rows ship);
* unroll3     kernel 1 with the taps' loop unrolled (rolled ships);
* sync1       kernel 1 waits for the next item's copies before computing
              this one (a single buffer in effect: no overlap);
* direct1     kernel 1 stores its output from registers as 4-byte bf16
              pairs, not through the shared-memory tile.

For each variant it prints kernel 5's bf16 leg (annealed order) at B in
{1, 8} and kernel 1's bf16 leg with the residual at B in {1, 8} and without
it at B=8: device time (CUDA events around 20 launches queued behind a
sleeping kernel), the largest gap to the plain version, and whether the
variant keeps the first variant's bits; with ``parent`` also the f32 legs
of both kernels.  Then, for kernel 5 with kFold 1, 2 and 4, its f32
accumulator before BN1 (a patch that stores it as f32) against float64 on
the same bf16 operands: the largest error and the mean signed error, both
over sum |a*b|, at B=1 (split-K) and B=8.  ``--generate`` also times the
B=32 bf16 ``generate`` of the dense and the sparse chain (full width, random
weights from seed 42) with the parent's and the shipped libraries (without
``--parent``: the first and the last variant's), in turns.  Needs a CUDA card.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (BF16, T, W0, cuda_ms, device_ms, epilogue_operands, float64_gap,  # noqa: E402
                        nvidia_smi, sparse_operands)
from pose2room_tpu_torch import kernels  # noqa: E402
from pose2room_tpu_torch.device import set_precision_policy  # noqa: E402
from pose2room_tpu_torch.models.graph import SPARSE_JOINT_ORDER  # noqa: E402
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig  # noqa: E402
from pose2room_tpu_torch.ops import stgcn_fused, stgcn_sparse  # noqa: E402

VARIANT_DIR = os.path.join(kernels.BUILD_DIR, "variants", "bf16")
# kernel 5's bf16 store of relu(acc * s1 + b1), and the f32 accumulator instead
BN_STORE = ("*reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * Wp + col) =\n"
            "            tconv_bf16::pack_rn(bn_relu(acc[4 * j + 2 * h], s.x, b.x), "
            "bn_relu(acc[4 * j + 2 * h + 1], s.y, b.y));")
ACC_STORE = ("*reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + static_cast<size_t>(row) * Wp + col) =\n"
             "            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);")
FOLD = "constexpr int kFold = 4;"
WAVES = "constexpr int kSplitWavesBf16 = 1;"
K1_STORE = "          *slot = *reinterpret_cast<const uint32_t*>(&o);"
K1_DIRECT = ("          const int t = a.t0 + row0 + mt * 16 + g + 8 * half;\n"
             "          if (t < T) *reinterpret_cast<__nv_bfloat162*>(out + (a.clip_row0 + t) * static_cast<size_t>(Wp)"
             " + a.col0 + jn * kC + n) = o;")
PATCHES = {  # variant: (source, [(old, new), ...])
    "base": (None, []),
    "fold1": ("stgcn_sparse.cu", [(FOLD, "constexpr int kFold = 1;")]),
    "fold2": ("stgcn_sparse.cu", [(FOLD, "constexpr int kFold = 2;")]),
    "ring4": ("stgcn_sparse.cu", [("constexpr int kRing = 6;", "constexpr int kRing = 4;")]),
    "ring5": ("stgcn_sparse.cu", [("constexpr int kRing = 6;", "constexpr int kRing = 5;")]),
    "nosplitk": ("stgcn_sparse.cu", [("  const bool cut = plan->cap < G;",
                                      "  plan->cap = G;\n  const bool cut = false;")]),
    "waves2": ("stgcn_sparse.cu", [(WAVES, "constexpr int kSplitWavesBf16 = 2;")]),
    "waves3": ("stgcn_sparse.cu", [(WAVES, "constexpr int kSplitWavesBf16 = 3;")]),
    "warps8": ("stgcn_epilogue.cu", [("constexpr int kWarpRows = 16;", "constexpr int kWarpRows = 32;")]),
    "unroll3": ("stgcn_epilogue.cu", [("constexpr int kTapUnroll = 1;", "constexpr int kTapUnroll = 3;")]),
    "sync1": ("stgcn_epilogue.cu", [
        ("    if (next < items) stage_item<kResidual>(sm, buf ^ 1, na, t1, x, vecs, T, Wp);\n    cp_async_commit();\n",
         "    if (next < items) stage_item<kResidual>(sm, buf ^ 1, na, t1, x, vecs, T, Wp);\n    cp_async_commit();\n"
         "    cp_async_wait<0>();\n")]),
    "direct1": ("stgcn_epilogue.cu", [(K1_STORE, K1_DIRECT), ("      if (a.t0 + r >= T) continue;", "      continue;")]),
    # the f32 accumulator of kernel 5's bf16 leg, at each fold interval
    "acc1": ("stgcn_sparse.cu", [(BN_STORE, ACC_STORE), (FOLD, "constexpr int kFold = 1;")]),
    "acc2": ("stgcn_sparse.cu", [(BN_STORE, ACC_STORE), (FOLD, "constexpr int kFold = 2;")]),
    "acc4": ("stgcn_sparse.cu", [(BN_STORE, ACC_STORE)]),
}
TIMED = ("base", "fold1", "fold2", "ring4", "ring5", "nosplitk", "waves2", "waves3", "warps8", "unroll3", "sync1",
         "direct1")
KERNELS = ("stgcn_sparse", "stgcn_epilogue")


def build(names, parent):
    """Build every variant's libraries, one nvcc process each, at once:
    {(variant, kernel): path}."""
    nvcc, procs = kernels._nvcc(), []
    for name in names:
        src = os.path.join(VARIANT_DIR, name)
        if os.path.isdir(src):
            shutil.rmtree(src)
        if name == "parent":
            shutil.copytree(parent, src)
        else:
            os.makedirs(src)
            target, patches = PATCHES[name]
            for fn in os.listdir(kernels.CSRC):
                with open(os.path.join(kernels.CSRC, fn)) as f:
                    text = f.read()
                if fn == target:
                    for old, new in patches:
                        if old not in text:
                            raise RuntimeError(f"variant {name}: patch does not apply to {fn}")
                        text = text.replace(old, new)
                with open(os.path.join(src, fn), "w") as f:
                    f.write(text)
        for kern in KERNELS:
            lib = os.path.join(src, f"lib{kern}.so")
            cmd = [nvcc, *kernels.NVCC_FLAGS, "-o", lib, os.path.join(src, f"{kern}.cu")]
            procs.append((name, kern, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                            stderr=subprocess.STDOUT, text=True)))
    paths = {}
    for name, kern, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} {kern}.cu:\n{log}")
        usage = [line.split("Function properties for")[-1].strip() if "properties" in line else line.strip()
                 for line in log.splitlines() if "registers" in line or "spill" in line or "properties" in line]
        if name in ("base", "parent"):
            print(f"built {name} {kern}:\n  " + "\n  ".join(usage))
        else:  # what a variant changes: serialized wgmma, spills
            notes = [line.strip()[:60] for line in log.splitlines()
                     if "C7514" in line or ("spill stores" in line and not line.strip().startswith("0 bytes"))]
            print(f"built {name} {kern}: {'; '.join(notes) or 'no spills, no serialized wgmma'}")
        paths[name, kern] = lib
    return paths


def swap_in(paths, name):
    """The wrappers load through kernels.load, which returns these."""
    for kern in KERNELS:
        kernels._libs[kern] = ctypes.CDLL(paths[name, kern])


def sparse_acc(lib, x, tiles, col_off, vlist):
    """An acc variant's output: the f32 accumulator (N, Wp) of kernel 5's
    bf16 leg, launched as the wrapper launches it, into an f32 buffer."""
    B, T_, Wp = x.shape
    nnz = tiles.shape[0]
    sizes = (ctypes.c_longlong * 2)()
    lib.p2r_stgcn_sparse_scratch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    kernels.check(lib.p2r_stgcn_sparse_scratch(B * T_, Wp, nnz, sizes), "scratch")
    partials = torch.empty(max(sizes[0], 1), dtype=torch.float32, device=x.device)
    counters = torch.zeros(max(sizes[1], 1), dtype=torch.int32, device=x.device)
    out = torch.zeros(B * T_, Wp, dtype=torch.float32, device=x.device)
    vecs = torch.zeros(8, Wp, device=x.device)
    fn = lib.p2r_stgcn_sparse_bf16
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    kernels.check(fn(x.data_ptr(), tiles.data_ptr(), vecs.data_ptr(), col_off.data_ptr(), vlist.data_ptr(),
                     out.data_ptr(), partials.data_ptr(), counters.data_ptr(), B * T_, Wp, nnz,
                     torch.cuda.current_stream().cuda_stream), "stgcn_sparse_bf16 acc")
    torch.cuda.synchronize()
    return out


def time_variants(names, paths, smi, with_f32):
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    sparse = {}
    for B in (1, 8):
        x, tiles, vecs, col_off, vlist = sparse_operands(B, SPARSE_JOINT_ORDER, g, dev)[:5]
        sparse[B] = (x.to(BF16), tiles.to(BF16), vecs, col_off, vlist) + ((x, tiles) if with_f32 else ())
    epi = {}
    for B in (1, 8):
        x, M, vecs, KB = epilogue_operands(B, g, dev)
        xb = x.to(BF16)
        t1 = stgcn_fused.graph_matmul_bn_relu(xb, M.to(BF16), vecs[0], vecs[1])
        epi[B] = (t1, xb, vecs, KB.to(BF16)) + ((stgcn_fused.graph_matmul_bn_relu(x, M, vecs[0], vecs[1]), x, KB)
                                                  if with_f32 else ())
    first = {}

    def one(key, fn, ref):
        got = fn()
        err = (got.float() - ref.float()).abs().max().item()
        same = torch.equal(got, first.setdefault(key, got))
        return f"{device_ms(fn):.4f} ms (gap {err:.1e}{'' if same else ', other bits'})"

    plain = {("k5", B): stgcn_sparse.sparse_graph_matmul_bn_relu_ref(*ops[:5]) for B, ops in sparse.items()}
    for B, ops in epi.items():
        for res in (True, False):
            plain["k1", B, res] = stgcn_fused.epilogue_merged_ref(ops[0], ops[1] if res else None, ops[2], ops[3],
                                                                  residual=res)
    for name in names:
        swap_in(paths, name)
        line = []
        for B, ops in sparse.items():
            line.append(f"k5 bf16 B={B} " + one(("k5", B), lambda: stgcn_sparse.sparse_graph_matmul_bn_relu(*ops[:5]),
                                                plain["k5", B]))
        for B, res in ((1, True), (8, True), (8, False)):
            t1, xb, vecs, KB = epi[B][:4]
            line.append(f"k1 bf16 B={B}{' res' if res else ''} " + one(
                ("k1", B, res), lambda: stgcn_fused.fused_epilogue(t1, xb if res else None, vecs, KB, residual=res),
                plain["k1", B, res]))
        if with_f32:
            for B, ops in sparse.items():
                x, tiles = ops[5:]
                fn = lambda: stgcn_sparse.sparse_graph_matmul_bn_relu(x, tiles, *ops[2:5])  # noqa: E731
                line.append(f"k5 f32 B={B} {device_ms(fn):.4f} ms")
            for B, ops in epi.items():
                t1, x, KB = ops[4:]
                fn = lambda: stgcn_fused.fused_epilogue(t1, x, ops[2], KB, residual=True)  # noqa: E731
                line.append(f"k1 f32 B={B} res {device_ms(fn):.4f} ms")
        print(f"[{smi}] {name:10s} " + "; ".join(line), flush=True)


def accumulator_bias(paths, smi):
    g = torch.Generator().manual_seed(1)
    dev = torch.device("cuda")
    for B in (1, 8):
        x, tiles, _, col_off, vlist, Mp = sparse_operands(B, SPARSE_JOINT_ORDER, g, dev)[:6]
        xb, tb = x.to(BF16), tiles.to(BF16)
        xd = xb.reshape(-1, xb.shape[-1]).double()
        Md = Mp.to(BF16).double()
        exact, mag = xd @ Md, xd.abs() @ Md.abs()
        live = mag > 0
        for fold in (1, 2, 4):
            acc = sparse_acc(ctypes.CDLL(paths[f"acc{fold}", "stgcn_sparse"]), xb, tb, col_off, vlist)
            a_max, a_bias = float64_gap(acc[live], exact[live], mag[live])
            print(f"[{smi}] kernel 5 bf16 f32 accumulator, kFold {fold}, B={B}: max {a_max:.3e}, bias {a_bias:.3e} "
                  f"of sum|a*b| (gate 5e-7 / 5e-8: {'met' if a_max <= 5e-7 and abs(a_bias) <= 5e-8 else 'missed'})",
                  flush=True)
        del xd, Md, exact, mag, live


def time_generate(paths, names, smi):
    """B=32 bf16 generate, dense and sparse chains, with the parent's and the
    shipped libraries (else the first and the last named variant's), in
    turns."""
    rng = np.random.RandomState(0)
    x = (rng.randn(32, T, W0 // 64, 3) * 0.4).astype(np.float32)
    x[..., 0] += np.linspace(0, 3, T, dtype=np.float32)[None, :, None]
    x = torch.from_numpy(x).cuda()
    for sparse in (False, True):
        cfg = P2RNetConfig(compute_dtype="bfloat16", sparse_eval=sparse)
        model = P2RNet(cfg, device="cuda", generator=torch.Generator().manual_seed(42))
        folded = model.fold_eval()
        runs = {}
        a, b = ("parent", "base") if "parent" in names else (names[0], names[-1])
        for name in (a, b, b, a):
            swap_in(paths, name)
            runs.setdefault(name, []).append(cuda_ms(lambda: model.generate(x, folded=folded), iters=3, warmup=1))
        print(f"[{smi}] B=32 bf16 {'sparse' if sparse else 'dense'} generate (CUDA events, means of 3, in turns "
              f"{a}/{b}/{b}/{a}): " + "; ".join(f"{n} {' / '.join(f'{t:.3f}' for t in ts)} ms"
                                                 for n, ts in runs.items()), flush=True)
        del model, folded


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", help="another tree's csrc/ directory, timed as the variant 'parent'")
    p.add_argument("--generate", action="store_true", help="also time the B=32 bf16 generate, both chains")
    p.add_argument("variants", nargs="*")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_bf16_variants: needs a CUDA card")
    set_precision_policy()
    names = args.variants or (["parent"] if args.parent else []) + ["base", *TIMED[1:], "base"] + (
        ["parent"] if args.parent else [])
    smi = nvidia_smi()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch {torch.__version__}", flush=True)
    paths = build(sorted(set(names) | {"acc1", "acc2", "acc4"}), args.parent)
    time_variants(names, paths, smi, with_f32="parent" in names)
    accumulator_bias(paths, smi)
    if args.generate:
        time_generate(paths, names, smi)


if __name__ == "__main__":
    main()
