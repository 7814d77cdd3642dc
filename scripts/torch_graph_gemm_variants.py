#!/usr/bin/env python3
"""Time design variants of the dense graph GEMM (csrc/stgcn_graph_gemm.cu)
on a card.

    python3 scripts/torch_graph_gemm_variants.py [--generate] [variant ...]

Each variant is csrc/ with a text patch of stgcn_graph_gemm.cu's constants,
built with the package's nvcc flags into
pose2room_tpu_torch/_build/variants/graph_gemm/ and swapped in for the
package's library, so the ops wrapper drives it as it drives the shipped
kernel; the shipped sources are not touched.  Variants (default: all, in
turns base, ..., base):

* base      the shipped kernel (128 x 192 tiles, 3 stages, a producer
            warpgroup that hands its registers to the consumers by
            setmaxnreg 40 / 232, bands of 9 column tiles, fold 4);
* bn128     128 x 128 tiles (27 column tiles), 4 stages;
* fold2, fold1  a fresh accumulator every 2 or every k8 step (other bits);
* band6     bands of 6 column tiles;
* band18    no raster bands: row-major over all 18 column tiles.

At the full width (T = 768, K = 3456) it prints, per variant, the device
time at B in {1, 8, 32} with the largest gap to the plain version
(``graph_matmul_bn_relu``) and whether it keeps the first variant's bits,
and ptxas's registers and spills.  With ``--generate`` it then times the
dense f32 ``generate`` at B = 32 on the shipped kernel and on the plain
route, in turns.  Times are device time: CUDA events around 20 launches
queued behind a sleeping kernel.  Needs a CUDA card.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    DEMO_CLIP, T, WP, cuda_ms, device_ms, graph_gemm_operands, nvidia_smi, ptxas_usage, rotated_clip,
)
from pose2room_tpu_torch import kernels  # noqa: E402
from pose2room_tpu_torch.data.dataset import load_demo_clip  # noqa: E402
from pose2room_tpu_torch.device import set_precision_policy  # noqa: E402
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig  # noqa: E402
from pose2room_tpu_torch.ops import stgcn_fused  # noqa: E402

PATCHES = {  # variant: [(old, new), ...] of stgcn_graph_gemm.cu
    "base": [],
    "bn128": [("constexpr int kBN = 192;", "constexpr int kBN = 128;")],
    "fold2": [("constexpr int kFold = 4;", "constexpr int kFold = 2;")],
    "fold1": [("constexpr int kFold = 4;", "constexpr int kFold = 1;")],
    "band6": [("constexpr int kBand = 9;", "constexpr int kBand = 6;")],
    "band18": [("constexpr int kBand = 9;", "constexpr int kBand = 18;")],
}
KERNEL = "stgcn_graph_gemm"


def build(names):
    """Build every variant's library, one nvcc process each, at once:
    {variant: path}."""
    nvcc, procs = kernels._nvcc(), []
    for name in names:
        src = os.path.join(kernels.BUILD_DIR, "variants", "graph_gemm", name)
        os.makedirs(src, exist_ok=True)
        for fn in os.listdir(kernels.CSRC):
            with open(os.path.join(kernels.CSRC, fn)) as f:
                text = f.read()
            if fn == f"{KERNEL}.cu":
                for old, new in PATCHES[name]:
                    if old not in text:
                        raise RuntimeError(f"variant {name}: patch does not apply to {fn}")
                    text = text.replace(old, new)
            with open(os.path.join(src, fn), "w") as f:
                f.write(text)
        lib = os.path.join(src, f"lib{KERNEL}.so")
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-o", lib, os.path.join(src, f"{KERNEL}.cu")]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    paths = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} {KERNEL}.cu:\n{log}")
        for kernel, regs, frame, stores, loads in ptxas_usage(log):
            print(f"built {name} {kernel}: {regs} registers, {frame} bytes stack frame, {stores} bytes spill "
                  f"stores, {loads} bytes spill loads")
        paths[name] = lib
    return paths


def plain_route(x, M, s1, b1, b_split=None):
    """The parent's graph matmul: torch.matmul in f32, then BN1 and the ReLU."""
    return stgcn_fused.graph_matmul_bn_relu(x, M, s1, b1)


def time_generate(smi):
    """The dense f32 generate at B = 32 on the shipped kernel and on the
    plain route, in turns (kernel, plain, plain, kernel)."""
    clip = load_demo_clip(DEMO_CLIP, num_frames=T)
    angles = np.random.RandomState(1).uniform(0, 2 * np.pi, 32)
    x = torch.from_numpy(np.stack([rotated_clip(clip, a) for a in angles])).cuda()
    model = P2RNet(P2RNetConfig(), device="cuda")
    folded = model.fold_eval()
    shipped = stgcn_fused.graph_gemm_bn_relu
    times = []
    for route in ("kernel", "plain", "plain", "kernel"):
        stgcn_fused.graph_gemm_bn_relu = shipped if route == "kernel" else plain_route
        try:
            times.append(f"{route} {cuda_ms(lambda: model.generate(x, folded=folded), iters=10, warmup=2):.3f}")
        finally:
            stgcn_fused.graph_gemm_bn_relu = shipped
    print(f"[{smi}] dense f32 generate B=32 (CUDA events, means of 10), ms: {', '.join(times)}")


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_graph_gemm_variants: needs a CUDA card")
    set_precision_policy()
    args = sys.argv[1:]
    generate = "--generate" in args
    names = [a for a in args if a != "--generate"] or ["base", *(n for n in PATCHES if n != "base"), "base"]
    smi = nvidia_smi()
    paths = build(sorted(set(names)))
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    ops = {B: graph_gemm_operands(B, WP, g, dev) for B in (1, 8, 32)}
    plain = {B: stgcn_fused.graph_matmul_bn_relu(x, M, vecs[0], vecs[1]) for B, (x, M, vecs, _) in ops.items()}
    first = {}  # the first variant's outputs: does a variant keep its bits?
    for name in names:
        kernels._libs[KERNEL] = ctypes.CDLL(paths[name])  # the wrapper loads through kernels.load
        line = []
        for B, (x, M, vecs, b_split) in ops.items():
            run = lambda: stgcn_fused.graph_gemm_bn_relu(x, M, vecs[0], vecs[1], b_split)  # noqa: E731
            got = run()
            err = (got - plain[B]).abs().max().item()
            same = torch.equal(got, first.setdefault(B, got))
            ms = device_ms(run)
            flops = 2 * B * T * WP * WP
            line.append(f"B={B} {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s (gap {err:.1e}"
                        f"{'' if same else ', other bits'})")
        print(f"[{smi}] {name:8s} " + "; ".join(line), flush=True)
    kernels._libs.pop(KERNEL, None)
    if generate:
        del ops, plain, first
        torch.cuda.empty_cache()
        time_generate(smi)


if __name__ == "__main__":
    main()
