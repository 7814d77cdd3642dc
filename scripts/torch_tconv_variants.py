#!/usr/bin/env python3
"""Time variants of the tensor-core temporal conv of kernels 1 and 3 on a card.

    python3 scripts/torch_tconv_variants.py [variant ...]

Each variant is csrc/ with a text patch applied to csrc/tconv_mma.cuh,
built with the package's nvcc flags into pose2room_tpu_torch/_build/variants/
and loaded with ctypes beside nothing else; the shipped sources are not
touched.  Variants (default: all, in turns base, ..., base):

* base     the shipped kernels;
* noflush  the three products of every k-step added straight into the
           accumulator (no fresh fragment): shows the tensor cores'
           truncating adds as a bias against float64;
* nosplit  small = big: three mma a k-step but one split per operand
           (wrong results; times the splits' share);
* onepass  big*big only (wrong results; times the two extra passes);
* nomma    no products at all (wrong results; the loads, the epilogue and
           the prologue alone);
* colswizzle the slab swizzle k ^ (((r & 3) << 3) | (r & 4)), free of bank
           conflicts for kernel 4's column-wise reads too;
* cvtsplit the TF32 rounding of the operand split by cvt.rna.tf32.f32
           instead of an integer add and a mask (the same bits).

At the full width (T = 768, 53 joints x 64 channels padded to 3456) and
B in {1, 8} it prints, per variant, kernel 1's device time with and without
the residual, kernel 3's, kernel 3's conv against float64 (largest error
and signed bias over sum |a*b|), and whether the two kernels' outputs keep
the first variant's bits.  Times are device time: CUDA events around 20
launches queued behind a sleeping kernel.  Needs a CUDA card.
"""

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pose2room_tpu_torch import kernels  # noqa: E402
from pose2room_tpu_torch.device import set_precision_policy  # noqa: E402
from pose2room_tpu_torch.ops import stgcn_fused  # noqa: E402

T, V, C = 768, 53, 64
W0, WP = V * C, 3456
FLUSHED = """          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(part, as[mt], bb0, bb1);
          mma_tf32(part, ab[mt], bs0, bs1);
          mma_tf32(part, ab[mt], bb0, bb1);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[i];
"""
# the TF32 rounding of the operand split: shipped, and by cvt.rna.tf32.f32
CVT_NEW = "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
CVT_OLD = 'uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n  return r & 0xffffe000u;'
PATCHES = {
    "base": [],
    "noflush": [(FLUSHED, """          mma_tf32(acc[mt][nt], as[mt], bb0, bb1);
          mma_tf32(acc[mt][nt], ab[mt], bs0, bs1);
          mma_tf32(acc[mt][nt], ab[mt], bb0, bb1);
""")],
    "nosplit": [("small = rna_tf32(x - __uint_as_float(big));", "small = big;")],
    "onepass": [(FLUSHED, FLUSHED.replace("""          mma_tf32(part, as[mt], bb0, bb1);
          mma_tf32(part, ab[mt], bs0, bs1);
""", ""))],
    "nomma": [(FLUSHED, "")],
    "cvtsplit": [(CVT_NEW, CVT_OLD)],
    "colswizzle": [("return r * kC + (k ^ ((r & 7) << 2));", "return r * kC + (k ^ (((r & 3) << 3) | (r & 4)));")],
}
SLEEP_CYCLES = 100_000_000


def build(names):
    """Build every variant's two libraries, one nvcc process each, at once."""
    nvcc, procs, libs = kernels._nvcc(), [], {}
    for name in names:
        src = os.path.join(kernels.BUILD_DIR, "variants", name)
        os.makedirs(src, exist_ok=True)
        for fn in os.listdir(kernels.CSRC):
            with open(os.path.join(kernels.CSRC, fn)) as f:
                text = f.read()
            for old, new in PATCHES[name]:
                if fn == "tconv_mma.cuh":
                    if old not in text:
                        raise RuntimeError(f"variant {name}: patch does not apply to {fn}")
                    text = text.replace(old, new)
            with open(os.path.join(src, fn), "w") as f:
                f.write(text)
        for kern in ("stgcn_epilogue", "stgcn_train_fwd"):
            lib = os.path.join(src, f"lib{kern}.so")
            cmd = [nvcc, *kernels.NVCC_FLAGS, "-o", lib, os.path.join(src, f"{kern}.cu")]
            procs.append((name, kern, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                            stderr=subprocess.STDOUT, text=True)))
    for name, kern, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} {kern}.cu:\n{log}")
        regs = [line.split(":")[-1].strip() for line in log.splitlines() if "registers" in line]
        print(f"built {name} {kern}: {'; '.join(regs)}")
        fn = getattr(ctypes.CDLL(lib), f"p2r_{kern}_f32")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (4 if kern == "stgcn_epilogue" else 3) + [ctypes.c_void_p]
        libs[name, kern] = fn
    return libs


def device_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def operands(B, g):
    """Kernel 1 (t1, x, vecs) and kernel 3 (y, vecs3) operands on the fold's
    layout, one KB: pad columns zero."""
    def cols(*shape, scale=1.0, shift=0.0):
        t = torch.zeros(*shape[:-1], WP)
        t[..., :W0] = torch.randn(*shape[:-1], W0, generator=g) * scale + shift
        return t

    t1, x = cols(B, T, WP).relu(), cols(B, T, WP).relu()
    vecs = torch.zeros(8, WP)
    vecs[2:4] = cols(2, WP, scale=0.1)
    vecs[2, :W0] += 1.0
    y = cols(B * T, WP, scale=0.7)
    vecs3 = torch.zeros(4, WP)
    vecs3[0] = cols(WP, scale=0.2, shift=1.0)
    vecs3[1:3] = cols(2, WP, scale=0.2)
    KB = stgcn_fused.block_diag_taps(torch.randn(3, C, C, generator=g) * 0.1)
    return [t.cuda() for t in (t1, x, vecs, y, vecs3, KB)]


def tconv_float64(t1, KB):
    h, K = t1.double(), KB.double()
    y, mag = 0.0, 0.0
    for s, hs in enumerate((stgcn_fused.shift_prev(h), h, stgcn_fused.shift_next(h))):
        y = y + stgcn_fused.tconv_group(hs, K[s])
        mag = mag + stgcn_fused.tconv_group(hs.abs(), K[s].abs())
    return y, mag


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_tconv_variants: needs a CUDA card")
    set_precision_policy()
    names = sys.argv[1:] or ["base", *(n for n in PATCHES if n != "base"), "base"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs = build(sorted(set(names)))
    g = torch.Generator().manual_seed(0)
    data = {B: operands(B, g) for B in (1, 8)}
    stream = torch.cuda.current_stream().cuda_stream
    first = {}  # the first variant's outputs: does a variant keep its bits?
    for name in names:
        epi, fwd = libs[name, "stgcn_epilogue"], libs[name, "stgcn_train_fwd"]
        for B, (t1, x, vecs, y, vecs3, KB) in data.items():
            out, y2 = torch.empty_like(t1), torch.empty_like(y)
            parts = torch.empty(B, -(-T // 64), 2, WP, device="cuda")
            res_ms = device_ms(lambda: epi(t1.data_ptr(), x.data_ptr(), vecs.data_ptr(), KB.data_ptr(),
                                           out.data_ptr(), B, T, WP, 1, stream))
            nores_ms = device_ms(lambda: epi(t1.data_ptr(), None, vecs.data_ptr(), KB.data_ptr(),
                                             out.data_ptr(), B, T, WP, 0, stream))
            fwd_ms = device_ms(lambda: fwd(y.data_ptr(), vecs3.data_ptr(), KB.data_ptr(), y2.data_ptr(),
                                           parts.data_ptr(), B, T, WP, stream))
            exact, mag = tconv_float64(torch.relu(y * vecs3[0] + vecs3[1]).reshape(B, T, WP), KB)
            d = (y2.reshape(B, T, WP).double() - exact - vecs3[2].double())[..., :W0]
            mag, sign = mag[..., :W0], torch.sign(exact[..., :W0])
            ref = first.setdefault(B, (out.clone(), y2.clone()))
            same = torch.equal(out, ref[0]) and torch.equal(y2, ref[1])
            print(f"[{smi}] {name:8s} B={B}: kernel 1 {res_ms:.4f} ms (residual) {nores_ms:.4f} ms (none); "
                  f"kernel 3 {fwd_ms:.4f} ms, conv vs float64: max {(d.abs() / mag).max().item():.2e}, "
                  f"bias {((d * sign).sum() / mag.sum()).item():.2e} of sum|a*b|"
                  f"{'' if same else '; other bits than the first variant'}")


if __name__ == "__main__":
    main()
