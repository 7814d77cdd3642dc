#!/usr/bin/env python3
"""Design variants of the bf16 legs of kernels 4 (ST-GCN train backward) and
3 (ST-GCN train forward) on a card.

    python3 scripts/torch_bf16_train_variants.py [--parent DIR] [--step] [variant ...]

Each variant is csrc/ with a text patch applied to one source, built with
the package's nvcc flags into pose2room_tpu_torch/_build/variants/train_bf16/
and swapped in for the package's library, so the ops wrappers drive it as
they drive the shipped kernel; the shipped sources are not touched.
``--parent DIR`` adds the variant ``parent``: the csrc/ directory DIR
(another tree's kernels, e.g. the parent commit's from ``git archive``),
which must keep the same C entry points.  The parent's legs are the
earlier design: kernel 4 on 8 warps in two roles (4 on dt1, 4 on the tap
gradient, 1 block an SM), kernel 3 on 64-column tiles, single-buffered,
with direct stores.  Variants (default: all, in turns base, ..., base):

* base            the shipped kernels;
* fold2, fold4    kernel 4 sums 2 or 4 k16 steps of the tap gradient in
                  one fresh fragment before the IEEE fold (1 ships): its
                  k-step loop replaced by FOLD_LOOP;
* sync4, sync3    kernel 4 / kernel 3 waits for the next item's copies
                  before computing this one (a single buffer in effect);
* gunroll2        kernel 4's tap-gradient loop unrolled by 2 k16 steps;
* itemre4         kernel 4 recomputes the item's coordinates each
                  iteration instead of carrying the next item's;
* pass1_4         kernel 4's dt1 in one pass over its warp's 32 columns
                  (two passes of 16 ship: 16 fewer live registers);
* tap1            both convs with the loop over the three taps rolled
                  (unrolled ships);
* t1u1_4, t1u3_4, t1u8_4  kernel 4's t1 pass with 1, 3 or all of its
                  16-byte steps in flight (2 ship: 3 and more spill);
* tidasm          kernel 4's tile_parts writer reads threadIdx.x afresh
                  (asm volatile), so no index is held across the item loop;
* t1lds           the t1 pass reads s1 / sh1 from shared memory per chunk,
                  not once into 16 registers;
* defer4, defer3  kernel 4's tile_parts / kernel 3's y2 stores and
                  tile_parts written at the next item's first barrier, one
                  barrier an item fewer;
* rows            the slab copies with a row loop of constant stride;
* direct3         kernel 3's y2 leaves from registers as 4-byte bf16 pairs,
                  not staged in a padded tile for 16-byte stores (as kernel
                  4's dpre leaves);
* ablations (timing only: they compute something else), each leaving out
  one part to show its share: noconv3, nodt1_4 (the conv), nograd4 (the tap
  gradient), not1_3, not1_4 (the t1 pass), nomom3 (the moments' shuffles),
  nostage3, nostage4 (the next item's copies), nostore3, nostore4 (the
  output's stores), nofold (the conv's IEEE folds: one accumulator).

For each variant it prints both legs at B in {1, 8} (full width, T=768):
device time (CUDA events around 20 launches queued behind a sleeping
kernel), the largest gap to the plain version, and whether the variant
keeps the first variant's bits (y2 and kernel 3's moments; dpre and kernel
4's moments; with the parent first, whether the redesign keeps the
parent's bits); with ``parent`` also the f32 legs.  Then kernel 4's tap
gradient at fold 1, 2 and 4 against float64 on the same bf16 operands: the
largest error and the mean signed error over sum |a*b| at B=1 and 8.
``--step`` also times the B=8 bf16 and f32 train steps (full width, random
weights from seed 42) with the parent's and the shipped libraries (without
``--parent``: the first and the last variant's), in turns.  Needs a CUDA
card.
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

from chip_smoke import (BF16, T, WP, C, device_ms, float64_gap, nvidia_smi,  # noqa: E402
                        tap_grad_float64, train_kernel_operands)
from pose2room_tpu_torch import kernels  # noqa: E402
from pose2room_tpu_torch.device import set_precision_policy  # noqa: E402
from pose2room_tpu_torch.ops import stgcn_train  # noqa: E402

VARIANT_DIR = os.path.join(kernels.BUILD_DIR, "variants", "train_bf16")
SYNC = ("    if (next < items) stage_item{sfx}(sm, buf ^ 1, na, {args}, vecs, T, Wp);\n    cp_async_commit();\n")
ZERO_ACC = ("for (int mt = 0; mt < 2; ++mt) for (int nt = 0; nt < sizeof(acc[0]) / sizeof(acc[0][0]); ++nt)"
            " for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;")
K3_CONV = "    tb::tconv_mma_kmajor<2, kNTBf16>(sm.slab[buf], sm.taps, row0, n0, acc);"
K4_CONV = "      tb::tconv_mma_kmajor<2, kPassNT>(sm.dslab[buf], sm.taps, w.rg * kWarpRowsBf16, n, acc);"
K4_GRAD = "    grad_item_bf16(sm, buf, min(kRows, (T - a.t0 + 15) / 16 * 16), gacc);\n"
T1 = "    tb::t1_pass<"
BUTTERFLY = "        for (int off = 4; off < 32; off <<= 1) {\n          sum[j] +="
NO_BUTTERFLY = "        for (int off = 32; off < 32; off <<= 1) {\n          sum[j] +="
K3_STORE = ("    *reinterpret_cast<uint4*>(y2 + (a.clip_row0 + a.t0 + r) * static_cast<size_t>(Wp) + a.col0 + 8 * q)"
            " =\n"
            "        *reinterpret_cast<const uint4*>(sm.tile + r * kOutStride + 8 * q);")
K3_TILE = "          *reinterpret_cast<__nv_bfloat162*>(sm.tile + r * kOutStride + n) = r2;"
K3_DIRECT = ("          if (a.t0 + r < T) *reinterpret_cast<__nv_bfloat162*>(y2 + (a.clip_row0 + a.t0 + r) * "
             "static_cast<size_t>(Wp) + a.col0 + n) = r2;")
K4_STORE = ("        *reinterpret_cast<__nv_bfloat162*>(dpre + (a.clip_row0 + a.t0 + r) * static_cast<size_t>(Wp)"
            " + a.col0 + k) =\n"
            "            tb::pack_rn(d0, d1);")
K4_GRAD_LOOP = "#pragma unroll 1\n  for (int k0 = 0; k0 < k_end; k0 += 16) {"
# kernel 4's tap gradient with {fold} k16 steps summed in one fresh fragment
# (the tensor cores' truncating adds) before the IEEE fold into gacc
FOLD_LOOP = """#pragma unroll 1
  for (int kg = 0; kg < k_end; kg += 16 * {fold}) {{
    uint32_t bf[{fold}][kGradNT / 2][4];  // [k-step][n-tile pair]: matrices 0, 1 and 2, 3 its two n-tiles
#pragma unroll
    for (int f = 0; f < {fold}; ++f)
#pragma unroll
      for (int p = 0; p < kGradNT / 2; ++p)
        if (kg + 16 * f < k_end)
          tb::ldmatrix_x4_trans(bf[f][p], ds + tb::swz64(kg + 16 * f + 1 + brow, (gn0 + 2 * p + (lane >> 4)) * 8));
#pragma unroll
    for (int mi = 0; mi < kGradMTBf16; ++mi) {{
      const int m = gm0 + mi;
      float part[kGradNT][4];
#pragma unroll
      for (int f = 0; f < {fold}; ++f) {{
        if (kg + 16 * f >= k_end) continue;  // rows past the clip add nothing
        uint32_t af[4];
        tb::ldmatrix_x4_trans(af, ts + tb::swz64(kg + 16 * f + m / 4 + lrow, (m % 4) * 16 + lcol));
#pragma unroll
        for (int nt = 0; nt < kGradNT; ++nt) {{
          const uint32_t b0 = bf[f][nt / 2][2 * (nt % 2)], b1 = bf[f][nt / 2][2 * (nt % 2) + 1];
          if (f == 0) {{
            tb::mma_bf16_fresh(part[nt], af, b0, b1);
          }} else {{
            tb::mma_bf16(part[nt], af, b0, b1);
          }}
        }}
      }}
#pragma unroll
      for (int nt = 0; nt < kGradNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) gacc[mi][nt][i] = __fadd_rn(gacc[mi][nt][i], part[nt][i]);
    }}
  }}"""


SLAB_LOOP = """  for (int i = threadIdx.x; i < (kRows + 2) * (kC / 8); i += Threads) {
    const int q = i % (kC / 8);
    const int r = i / (kC / 8);
    const int t = t0 - 1 + r;
    const bool valid = t >= 0 && t < T;
    const bf16* g = valid ? src + (clip_row0 + t) * static_cast<size_t>(Wp) + col0 + 8 * q : src;
    cp_async16(slab + slab_index(r, 8 * q), g, valid);
  }"""
SLAB_ROWS = """  const int q = threadIdx.x % (kC / 8);
  const bf16* base = src + clip_row0 * static_cast<size_t>(Wp) + col0 + 8 * q;
#pragma unroll
  for (int r = threadIdx.x / (kC / 8); r < kRows + 2; r += Threads / (kC / 8)) {
    const int t = t0 - 1 + r;
    const bool valid = t >= 0 && t < T;
    cp_async16(slab + slab_index(r, 8 * q), valid ? base + static_cast<size_t>(t) * Wp : src, valid);
  }"""
FOLD_PAIR = ("          mma_bf16_fresh(part, a[mt], b[0], b[1]);\n#pragma unroll\n"
             "          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], part[i]);\n"
             "          mma_bf16_fresh(part, a[mt], b[2], b[3]);\n#pragma unroll\n"
             "          for (int i = 0; i < 4; ++i) acc[mt][nt + 1][i] = __fadd_rn(acc[mt][nt + 1][i], part[i]);")
ACC_PAIR = ("          mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);\n"
            "          mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);")


T1_VECS = """  float s1[8], sh1[8];
  {
    const float4* p = reinterpret_cast<const float4*>(s1v + 8 * q);
    const float4* h = reinterpret_cast<const float4*>(sh1v + 8 * q);
    const float4 a = p[0], b = p[1], c = h[0], d = h[1];
    s1[0] = a.x; s1[1] = a.y; s1[2] = a.z; s1[3] = a.w; s1[4] = b.x; s1[5] = b.y; s1[6] = b.z; s1[7] = b.w;
    sh1[0] = c.x; sh1[1] = c.y; sh1[2] = c.z; sh1[3] = c.w; sh1[4] = d.x; sh1[5] = d.y; sh1[6] = d.z; sh1[7] = d.w;
  }
"""
T1_BODY = "    if (kChunks % Threads == 0 || i < kChunks) {\n"


def _grad_loop(text):
    """Kernel 4's k-step loop of the tap gradient, through its closing brace."""
    start = text.index(K4_GRAD_LOOP)
    return text[start:text.index("\n  }", start) + len("\n  }")]


def _fold(fold):
    return "stgcn_train_bwd.cu", [(_grad_loop, FOLD_LOOP.format(fold=fold))]


def _sync(sfx, args):
    old = SYNC.format(sfx=sfx, args=args)
    return old, old + "    cp_async_wait<0>();\n"


PATCHES = {  # variant: (source, [(old, new), ...]); old may be a function of the source text
    "base": (None, []),
    "fold2": _fold(2),
    "fold4": _fold(4),
    "sync4": ("stgcn_train_bwd.cu", [_sync("_bf16", "dy2, y")]),
    "sync3": ("stgcn_train_fwd.cu", [_sync("", "y")]),
    "gunroll2": ("stgcn_train_bwd.cu", [(K4_GRAD_LOOP, K4_GRAD_LOOP.replace("unroll 1", "unroll 2"))]),
    "direct3": ("stgcn_train_fwd.cu", [(K3_TILE, K3_DIRECT), (K3_STORE, "    (void)q;")]),
    # ablations, timing only (they compute something else): where the time goes
    "noconv3": ("stgcn_train_fwd.cu", [(K3_CONV, "    " + ZERO_ACC)]),
    "not1_3": ("stgcn_train_fwd.cu", [(T1, "    if (false) tb::t1_pass<")]),
    "nomom3": ("stgcn_train_fwd.cu", [(BUTTERFLY, NO_BUTTERFLY)]),
    "nostage3": ("stgcn_train_fwd.cu", [("    if (next < items) stage_item(", "    if (false) stage_item(")]),
    "nostore3": ("stgcn_train_fwd.cu", [(K3_STORE, "    (void)q;")]),
    "nograd4": ("stgcn_train_bwd.cu", [(K4_GRAD, "")]),
    "nodt1_4": ("stgcn_train_bwd.cu", [(K4_CONV, "    " + ZERO_ACC)]),
    "not1_4": ("stgcn_train_bwd.cu", [(T1, "    if (false) tb::t1_pass<")]),
    "nostage4": ("stgcn_train_bwd.cu", [("    if (next < items) stage_item_bf16(", "    if (false) stage_item_bf16(")]),
    "itemre4": ("stgcn_train_bwd.cu", [
        ("    const int next = item + stride;\n"
         "    const TileAt na = tile_at(next < items ? next : item, B, T);\n"
         "    if (next < items) stage_item_bf16(sm, buf ^ 1, na, dy2, y, vecs, T, Wp);\n",
         "    if (item + stride < items)\n"
         "      stage_item_bf16(sm, buf ^ 1, tile_at(item + stride, B, T), dy2, y, vecs, T, Wp);\n"
         "    a = tile_at(item, B, T);\n"),
        ("    a = na;\n  }", "  }")]),
    "pass1_4": ("stgcn_train_bwd.cu", [("constexpr int kDt1Passes = 2;", "constexpr int kDt1Passes = 1;")]),
    "nostore4": ("stgcn_train_bwd.cu", [(K4_STORE, "        (void)d1;")]),
    "tap1": ("tconv_bf16.cuh", [("#pragma unroll\n  for (int s = 0; s < 3; ++s) {\n    const bf16* tap",
                                 "#pragma unroll 1\n  for (int s = 0; s < 3; ++s) {\n    const bf16* tap")]),
    "t1u1_4": ("stgcn_train_bwd.cu", [("constexpr int kT1Unroll = 2;", "constexpr int kT1Unroll = 1;")]),
    "t1u3_4": ("stgcn_train_bwd.cu", [("constexpr int kT1Unroll = 2;", "constexpr int kT1Unroll = 3;")]),
    "t1u8_4": ("stgcn_train_bwd.cu", [("constexpr int kT1Unroll = 2;", "constexpr int kT1Unroll = 8;")]),
    "defer4": ("stgcn_train_bwd.cu", [
        ("    __syncthreads();  // this item has landed; red is read\n",
         "    __syncthreads();  // this item has landed; the last item's moment partials are complete\n"
         "    if (item != static_cast<int>(blockIdx.x / 2))\n"
         "      write_parts_bf16(sm, tile_at(item - stride, B, T), T, Wp, tile_parts);\n"),
        ("    __syncthreads();  // the item's moment partials are complete\n"
         "    write_parts_bf16(sm, a, T, Wp, tile_parts);\n", ""),
        ("  cp_async_wait<0>();\n\n  // the running sum",
         "  cp_async_wait<0>();\n  __syncthreads();\n"
         "  write_parts_bf16(sm, tile_at(item - stride, B, T), T, Wp, tile_parts);\n\n  // the running sum")]),
    "defer3": ("stgcn_train_fwd.cu", [
        ("    __syncthreads();  // this item has landed; the last item's y2 is stored and red read\n",
         "    __syncthreads();  // this item has landed; the last item's y2 tile and moment partials are complete\n"
         "    if (item != static_cast<int>(blockIdx.x / 2)) store_item(sm, tile_at(item - stride, B, T), T, Wp, y2, "
         "tile_parts);\n"),
        ("    __syncthreads();  // the item's y2 tile and moment partials are complete\n"
         "    store_item(sm, a, T, Wp, y2, tile_parts);\n", ""),
        ("    a = na;\n  }\n  cp_async_wait<0>();\n}",
         "    a = na;\n  }\n  cp_async_wait<0>();\n  __syncthreads();\n"
         "  store_item(sm, tile_at(item - stride, B, T), T, Wp, y2, tile_parts);\n}")]),
    "rows": ("tconv_bf16.cuh", [(SLAB_LOOP, SLAB_ROWS)]),
    "tidasm": ("stgcn_train_bwd.cu", [(
        "  const int h = threadIdx.x / (2 * kC);  // 64-row part of this item\n"
        "  const int moment = (threadIdx.x / kC) % 2;\n"
        "  const int col = threadIdx.x % kC;\n",
        "  unsigned tid;\n  asm volatile(\"mov.u32 %0, %%tid.x;\" : \"=r\"(tid));\n"
        "  const int h = tid / (2 * kC);  // 64-row part of this item\n"
        "  const int moment = (tid / kC) % 2;\n"
        "  const int col = tid % kC;\n")]),
    "t1lds": ("tconv_bf16.cuh", [(T1_VECS, ""), (T1_BODY, T1_BODY + T1_VECS.replace("\n  ", "\n      ")
                                                                  .replace("  float s1", "      float s1", 1))]),
    "nofold": ("tconv_bf16.cuh", [(FOLD_PAIR, ACC_PAIR)]),
}
TIMED = ("base", "fold2", "fold4", "gunroll2", "itemre4", "pass1_4", "tap1", "t1u1_4", "t1u3_4", "t1u8_4", "tidasm",
         "t1lds", "defer4", "defer3", "rows", "sync4", "sync3", "direct3")
ABLATIONS = ("noconv3", "not1_3", "nomom3", "nostage3", "nostore3", "nograd4", "nodt1_4", "not1_4", "nostage4",
             "nostore4", "nofold")
KERNELS = ("stgcn_train_fwd", "stgcn_train_bwd")


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
                        if callable(old):
                            old = old(text)
                        if old not in text:
                            raise RuntimeError(f"variant {name}: patch does not apply to {fn}: {old[:60]!r}")
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
        print(f"built {name} {kern}:\n  " + "\n  ".join(usage), flush=True)
        paths[name, kern] = lib
    return paths


def swap_in(paths, name):
    """The wrappers load through kernels.load, which returns these."""
    for kern in KERNELS:
        kernels._libs[kern] = ctypes.CDLL(paths[name, kern])


def operands(with_f32):
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    ops = {}
    for B in (1, 8):
        y, dy2, vecs, KB = train_kernel_operands(B, g, dev)
        vecs_b = vecs.clone()
        vecs_b[2] = 0.0
        f32 = (y, dy2, KB, KB.transpose(1, 2).contiguous()) if with_f32 else ()
        KBb = KB.to(BF16)
        ops[B] = (y.to(BF16), dy2.to(BF16), vecs, vecs_b, KBb, KBb.transpose(1, 2).contiguous()) + f32
    return ops


def time_variants(names, paths, ops, smi, with_f32):
    first = {}

    def same(key, outs):
        ref = first.setdefault(key, outs)
        return all(torch.equal(a, b) for a, b in zip(outs, ref))

    plain = {}
    for B, (yb, dy2b, vecs, vecs_b, KBb, KBTb) in ((B, o[:6]) for B, o in ops.items()):
        plain["k3", B] = stgcn_train.tconv_stats_fwd_ref(yb, vecs, KBb, T=T)[0]
        plain["k4", B] = stgcn_train.tconv_bwd_ref(dy2b, yb, vecs_b, KBTb, T=T)[0]
    for name in names:
        swap_in(paths, name)
        line = []
        for B, o in ops.items():
            yb, dy2b, vecs, vecs_b, KBb, KBTb = o[:6]
            k3 = lambda: stgcn_train.tconv_stats_fwd(yb, vecs, KBb, T=T)  # noqa: E731
            k4 = lambda: stgcn_train.tconv_bwd(dy2b, yb, vecs_b, KBTb, T=T, C=C)  # noqa: E731
            y2, parts = k3()
            dpre, dparts, _ = k4()
            torch.cuda.synchronize()
            e3 = (y2.float() - plain["k3", B].float()).abs().max().item()
            e4 = (dpre.float() - plain["k4", B].float()).abs().max().item()
            s3 = "" if same(("k3", B), (y2, parts)) else (
                ", other y2 bits" if not torch.equal(y2, first["k3", B][0]) else ", other moment bits")
            s4 = "" if same(("k4", B), (dpre, dparts)) else (
                ", other dpre bits" if not torch.equal(dpre, first["k4", B][0]) else ", other moment bits")
            line.append(f"k3 bf16 B={B} {device_ms(k3):.4f} ms (gap {e3:.1e}{s3})")
            line.append(f"k4 bf16 B={B} {device_ms(k4):.4f} ms (gap {e4:.1e}{s4})")
            if with_f32:
                y, dy2, KB, KBT = o[6:]
                line.append(f"k3 f32 B={B} {device_ms(lambda: stgcn_train.tconv_stats_fwd(y, vecs, KB, T=T)):.4f} ms")
                line.append(f"k4 f32 B={B} "
                            f"{device_ms(lambda: stgcn_train.tconv_bwd(dy2, y, vecs_b, KBT, T=T, C=C)):.4f} ms")
        print(f"[{smi}] {name:8s} " + "; ".join(line), flush=True)


def fold_bias(paths, ops, smi):
    """Kernel 4's tap gradient (an f32 output) at each fold interval against
    float64 on the same bf16 operands."""
    for B, o in ops.items():
        yb, dy2b, _, vecs_b, _, KBTb = o[:6]
        t1 = torch.relu(yb.float() * vecs_b[0] + vecs_b[1]).to(BF16).reshape(B, T, WP)
        exact, mag = tap_grad_float64(t1, dy2b.reshape(B, T, WP))
        for name, fold in (("base", 1), ("fold2", 2), ("fold4", 4)):
            if (name, "stgcn_train_bwd") not in paths:
                continue
            swap_in(paths, name)
            dtaps = stgcn_train.tconv_bwd(dy2b, yb, vecs_b, KBTb, T=T, C=C)[2]
            g_max, g_bias = float64_gap(dtaps, exact, mag)
            ok = g_max <= 5e-7 and abs(g_bias) <= 5e-8
            print(f"[{smi}] kernel 4 bf16 tap gradient, fold {fold}, B={B}: max {g_max:.3e}, bias {g_bias:.3e} "
                  f"of sum|a*b| (gate 5e-7 / 5e-8: {'met' if ok else 'missed'})", flush=True)
        del t1, exact, mag


def time_steps(paths, names, smi):
    """The B=8 train step in bf16 and f32 with two trees' kernels, in turns
    (CUDA events, median of 5 after 2 warm-ups each turn)."""
    from chip_smoke import scene_datasets, train_config
    from pose2room_tpu_torch.config.loader import CONFIG, mount_external_config
    from pose2room_tpu_torch.data.loader import collate
    from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
    from pose2room_tpu_torch.train.state import make_optimizer
    from pose2room_tpu_torch.train.step import batch_to_device, train_step
    import tempfile

    a, b = ("parent", "base") if "parent" in names else (names[0], names[-1])
    datasets = scene_datasets(seed=3, n_train=8, n_val=1)
    items = [datasets["train"].__getitem__(i, rng=np.random.RandomState(i)) for i in range(8)]
    batch = batch_to_device(collate(items), "cuda")
    with tempfile.TemporaryDirectory() as workdir:
        for dtype in ("bfloat16", "float32"):
            config = train_config(os.path.join(workdir, dtype))
            config["model"] = {**(config.get("model") or {}), "compute_dtype": dtype}
            cfg = CONFIG(config, mode="train")
            try:
                mount_external_config(cfg)
                model = P2RNet(P2RNetConfig.from_cfg(cfg), device="cuda", generator=torch.Generator().manual_seed(42))
                optimizer, _, _ = make_optimizer(model, cfg.config["optimizer"])
            finally:
                cfg.close()
            runs = {}
            for name in (a, b, b, a):
                swap_in(paths, name)
                for i in range(2):
                    train_step(model, optimizer, batch, generator=torch.Generator().manual_seed(i))
                torch.cuda.synchronize()
                turn = []
                for i in range(5):
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    train_step(model, optimizer, batch, generator=torch.Generator().manual_seed(10 + i))
                    end.record()
                    torch.cuda.synchronize()
                    turn.append(start.elapsed_time(end))
                runs.setdefault(name, []).append(float(np.median(turn)))
            print(f"[{smi}] B=8 {dtype} train step (CUDA events, median of 5, in turns {a}/{b}/{b}/{a}): "
                  + "; ".join(f"{n} {' / '.join(f'{t:.3f}' for t in ts)} ms" for n, ts in runs.items()), flush=True)
            del model, optimizer


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", help="another tree's csrc/ directory, timed as the variant 'parent'")
    p.add_argument("--step", action="store_true", help="also time the B=8 train step, bf16 and f32")
    p.add_argument("variants", nargs="*")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_bf16_train_variants: needs a CUDA card")
    set_precision_policy()
    names = args.variants or (["parent"] if args.parent else []) + ["base", *TIMED[1:], *ABLATIONS, "base"] + (
        ["parent"] if args.parent else [])
    smi = nvidia_smi()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch {torch.__version__}", flush=True)
    paths = build(sorted(set(names) | {"base", "fold2", "fold4"}), args.parent)
    ops = operands(with_f32="parent" in names)
    time_variants(names, paths, ops, smi, with_f32="parent" in names)
    fold_bias(paths, ops, smi)
    if args.step:
        time_steps(paths, names, smi)


if __name__ == "__main__":
    main()
