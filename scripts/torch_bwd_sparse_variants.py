#!/usr/bin/env python3
"""Time design variants of kernels 4 (train backward) and 5 (block-sparse
graph matmul) on a card.

    python3 scripts/torch_bwd_sparse_variants.py [variant ...]

Each variant is csrc/ with a text patch applied to one source,
built with the package's nvcc flags into pose2room_tpu_torch/_build/variants/bwd_sparse/
and swapped in for the package's library, so the ops wrappers drive it as
they drive the shipped kernel; the shipped sources are not touched.
Variants (default: all, in turns base, ..., base):

* base        the shipped kernels;
* nograd      kernel 4 without the tap-gradient products (wrong dtaps;
              dt1, its epilogue and the staging alone);
* splitstage  kernel 5 splits each landed stage once into big and small
              TF32 planes in shared memory (one more stage of it) instead
              of splitting per fragment load;
* nosplitk    kernel 5 never cuts a CSR list (one unit per output tile and
              row block, still launched longest first);
* colswizzle  kernel 4 on the slab swizzle k ^ (((r & 3) << 3) | (r & 4)),
              free of bank conflicts for its column-wise reads (a patch of
              tconv_mma.cuh);
* cvtsplit    the TF32 rounding of the operand split by cvt.rna.tf32.f32
              instead of an integer add and a mask (the same bits; a patch of
              tconv_mma.cuh);
* stages3, stages6  kernel 5 with a 3- or 6-stage cp.async ring (4 ships);
* waves6      kernel 5 cuts its lists into twice as many chunks.

At the full width (T = 768, 53 joints x 64 channels padded to 3456) it
prints, per variant, kernel 4's device time at B in {1, 8} and kernel 5's
(annealed order) at B in {1, 8}, each with its largest gap to the plain
version and whether it keeps the first variant's bits.  Times are device
time: CUDA events around 20 launches queued behind a sleeping kernel.
Needs a CUDA card.
"""

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import C, T, device_ms, nvidia_smi, sparse_operands, train_kernel_operands  # noqa: E402
from pose2room_tpu_torch import kernels  # noqa: E402
from pose2room_tpu_torch.device import set_precision_policy  # noqa: E402
from pose2room_tpu_torch.models.graph import SPARSE_JOINT_ORDER  # noqa: E402
from pose2room_tpu_torch.ops import stgcn_sparse, stgcn_train  # noqa: E402

# the TF32 rounding of the operand split: shipped, and by cvt.rna.tf32.f32
CVT_NEW = "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
CVT_OLD = 'uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n  return r & 0xffffe000u;'
# kernel 5's stage split once into planes: the stage holds the big parts, one
# more buffer the small ones
SPLIT_PASS = """    float* stage = smem + (step % kStages) * kStageFloats;
    float* small = smem + kStages * kStageFloats;
    for (int i = tid; i < kStageFloats / 4; i += kThreads) {
      const float4 v = reinterpret_cast<float4*>(stage)[i];
      float4 b, t;
      b.x = __uint_as_float(tconv::rna_tf32(v.x));
      b.y = __uint_as_float(tconv::rna_tf32(v.y));
      b.z = __uint_as_float(tconv::rna_tf32(v.z));
      b.w = __uint_as_float(tconv::rna_tf32(v.w));
      t = make_float4(__uint_as_float(tconv::rna_tf32(v.x - b.x)), __uint_as_float(tconv::rna_tf32(v.y - b.y)),
                      __uint_as_float(tconv::rna_tf32(v.z - b.z)), __uint_as_float(tconv::rna_tf32(v.w - b.w)));
      reinterpret_cast<float4*>(stage)[i] = b;
      reinterpret_cast<float4*>(small)[i] = t;
    }
    __syncthreads();
    const float* As = stage;
    const float* Bs = stage + kAFloats;
    auto planes = [&](const float* big, int idx, uint32_t& hi, uint32_t& lo) {
      hi = __float_as_uint(big[idx]);
      lo = __float_as_uint(small[big - stage + idx]);
    };
"""
PATCHES = {  # variant: (source, [(old, new), ...])
    "base": (None, []),
    "nograd": ("stgcn_train_bwd.cu", [("      grad_tile(sm.tslab, ds, k_end, gacc);\n", "")]),
    "splitstage": ("stgcn_sparse.cu", [
        ("constexpr size_t kSmemBytes = kStages * kStageFloats * sizeof(float);",
         "constexpr size_t kSmemBytes = (kStages + 1) * kStageFloats * sizeof(float);"),
        ("    const float* As = smem + (step % kStages) * kStageFloats;\n    const float* Bs = As + kAFloats;\n",
         SPLIT_PASS),
        *((f"split({m}[{idx}], ", f"planes({m}, {idx}, ") for m, idx in (
            ("As", "a_index(r, kk + c)"), ("As", "a_index(r + 8, kk + c)"), ("As", "a_index(r, kk + c + 4)"),
            ("As", "a_index(r + 8, kk + c + 4)"), ("Bs", "b_index(kk + c, wcol + nt * 8 + g)"),
            ("Bs", "b_index(kk + c + 4, wcol + nt * 8 + g)"))),
    ]),
    "nosplitk": ("stgcn_sparse.cu", [("  const bool cut = plan->cap < G;", "  plan->cap = G;\n  const bool cut = false;")]),
    "colswizzle": ("tconv_mma.cuh", [("return r * kC + (k ^ ((r & 7) << 2));",
                                      "return r * kC + (k ^ (((r & 3) << 3) | (r & 4)));")]),
    "cvtsplit": ("tconv_mma.cuh", [(CVT_NEW, CVT_OLD)]),
    "stages3": ("stgcn_sparse.cu", [("constexpr int kStages = 4;", "constexpr int kStages = 3;")]),
    "stages6": ("stgcn_sparse.cu", [("constexpr int kStages = 4;", "constexpr int kStages = 6;")]),
    "waves6": ("stgcn_sparse.cu", [("constexpr int kSplitWaves = 3;", "constexpr int kSplitWaves = 6;")]),
}
KERNELS = ("stgcn_train_bwd", "stgcn_sparse")


def build(names):
    """Build every variant's libraries, one nvcc process each, at once:
    {(variant, kernel): path}."""
    nvcc, procs = kernels._nvcc(), []
    for name in names:
        src = os.path.join(kernels.BUILD_DIR, "variants", "bwd_sparse", name)
        os.makedirs(src, exist_ok=True)
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
        regs = [line.split(":")[-1].strip() for line in log.splitlines() if "registers" in line]
        print(f"built {name} {kern}: {'; '.join(regs)}")
        paths[name, kern] = lib
    return paths


def bwd_operands(B, g, dev):
    """Kernel 4's operands as chip_smoke.py builds them: (dy2, y, vecs, KBT)."""
    y, dy2, vecs, KB = train_kernel_operands(B, g, dev)
    vecs[2] = 0.0
    return dy2, y, vecs, KB.transpose(1, 2).contiguous()


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_bwd_sparse_variants: needs a CUDA card")
    set_precision_policy()
    names = sys.argv[1:] or ["base", *(n for n in PATCHES if n != "base"), "base"]
    smi = nvidia_smi()
    paths = build(sorted(set(names)))
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    bwd = {B: bwd_operands(B, g, dev) for B in (1, 8)}
    sparse = {B: sparse_operands(B, SPARSE_JOINT_ORDER, g, dev)[:5] for B in (1, 8)}
    plain = {("bwd", B): stgcn_train.tconv_bwd_ref(*ops, T=T) for B, ops in bwd.items()}
    plain.update({("sparse", B): stgcn_sparse.sparse_graph_matmul_bn_relu_ref(*ops) for B, ops in sparse.items()})
    first = {}  # the first variant's outputs: does a variant keep its bits?
    for name in names:
        for kern in KERNELS:  # the wrappers load through kernels.load, which returns these
            kernels._libs[kern] = ctypes.CDLL(paths[name, kern])
        line = []
        for B, ops in bwd.items():
            got = stgcn_train.tconv_bwd(*ops, T=T, C=C)
            err = (got[0] - plain["bwd", B][0]).abs().max().item()
            same = all(torch.equal(a, b) for a, b in zip(got, first.setdefault(("bwd", B), got)))
            ms = device_ms(lambda: stgcn_train.tconv_bwd(*ops, T=T, C=C))
            line.append(f"kernel 4 B={B} {ms:.4f} ms (dpre gap {err:.1e}{'' if same else ', other bits'})")
        for B, ops in sparse.items():
            got = stgcn_sparse.sparse_graph_matmul_bn_relu(*ops)
            err = (got - plain["sparse", B]).abs().max().item()
            same = torch.equal(got, first.setdefault(("sparse", B), got))
            ms = device_ms(lambda: stgcn_sparse.sparse_graph_matmul_bn_relu(*ops))
            line.append(f"kernel 5 B={B} {ms:.4f} ms (gap {err:.1e}{'' if same else ', other bits'})")
        print(f"[{smi}] {name:10s} " + "; ".join(line))

if __name__ == "__main__":
    main()
