#!/usr/bin/env python3
"""Design variants of kernel 2 (furthest-point sampling) on a card, and the
instruction latencies behind its floor.

    python3 scripts/torch_fps_variants.py [--parent DIR] [--rounds R] [--generate] [variant ...]

Each variant is csrc/fps.cu with a text patch, built with the package's nvcc
flags into pose2room_tpu_torch/_build/variants/fps/ and swapped in for the
package's library, so ``sampling.furthest_point_sample`` drives it as it
drives the shipped kernel; the shipped source is not touched.  ``--parent
DIR`` adds the variant ``parent``: DIR is another tree's csrc/ (e.g. the
parent commit's, from ``git archive``), whose fps.cu keeps the same C entry
point.  Variants (default: all, the list run ``--rounds`` times, parent and
base first and last in each round):

* base     the shipped kernel (design (b)): four warps per clip at N <=
           512, 4 points a lane in a blocked layout, a tree argmax in the lane, two
           redux.sync steps across lanes (max of the score's bits, min of
           the index among the lanes holding it), each warp's winner in a
           double-buffered slot, one barrier a pick, every warp's tree over
           the slots; coordinates in shared memory as float4; each pick
           stored to device memory by one thread as it is made;
* a        design (a): one warp per clip at N <= 512, 16 points a lane, no
           barrier and no slots;
* a_end    design (a) with the picks stored at the end, as endstore;
* a_bfly   design (a) with the cross-lane step as one 5-level
           __shfl_xor_sync butterfly on a 64-bit key (the score's key with
           its sign bit flipped, then ~index);
* bfly     base with that butterfly;
* ballot   base with redux.sync for the max, then __ballot_sync / __ffs for
           the lowest lane holding it and one __shfl_sync of its index;
* vote     base with the index from one __ballot_sync a point slot;
* uniq     base with the warp's max, then a ballot: where one lane holds
           it, that lane stores its (key, index) to the slot, and only a
           tie across lanes takes the second redux.sync;
* lowlane  base with the warp's max, then a ballot, and the lowest lane
           holding the max stores its own (key, index) (lane order is
           index order): one reduction, the slot store the broadcast;
* atom     base with the cross-warp step as one 64-bit shared-memory
           atomicMax of (key, ~index) by the lanes holding their warp's max
           (one redux.sync a warp, no slots), triple-buffered;
* w2, w8, w16  2, 8 or 16 warps per clip at N <= 512, with 8, 2 or 1 points
           a lane;
* endstore the picks collected in shared memory and stored at the end in
           one coalesced pass;
* f3       coordinates in shared memory as three float arrays (three
           LDS.32 a pick, not one LDS.128);
* parent   the earlier design: one 512-thread block per clip, one point a
           thread, two block barriers and two shuffle trees a pick;
* nored    an ablation, timing only (it picks other points): no
           cross-lane step, each lane's own winner goes to the slot.

For each variant it prints ptxas's registers, stack frame and spills, then
its device time (CUDA events around 20 launches queued behind a sleeping
kernel) at B in {1, 8, 32} on chip_smoke.py's FPS cloud (N = 512, npoint =
128), each checked index for index against ``fps_ref`` on the card, and at
B = 1 with npoint = 2 (the fixed cost, for the cycles a pick by the slope),
and the ratio of each base run to the parent run next to it.  Then the latencies of
csrc/latency_probe.cu, the SM clock and the floor of 127 picks with each
variant's share of it.  ``--generate`` also times the f32 ``generate`` at B
= 1 and 32 (full width, random weights from seed 42) with the parent's and
the shipped library (without ``--parent``: the first and the last variant's),
in turns.  Needs a CUDA card.
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

from chip_smoke import (T, W0, cuda_ms, device_ms, fps_cloud, fps_latency_floor,  # noqa: E402
                        nvidia_smi, ptxas_usage, start_probe_build)
from pose2room_tpu_torch import kernels  # noqa: E402
from pose2room_tpu_torch.device import set_precision_policy  # noqa: E402
from pose2room_tpu_torch.ops import sampling  # noqa: E402

VARIANT_DIR = os.path.join(kernels.BUILD_DIR, "variants", "fps")
BATCHES = (1, 8, 32)

REDUX = """  const int best = __reduce_max_sync(kFull, key);
  const unsigned i = __reduce_min_sync(kFull, key == best ? static_cast<unsigned>(idx) : UINT_MAX);
  return make_int2(best, static_cast<int>(i));"""
BFLY = """  unsigned long long k = static_cast<unsigned long long>(static_cast<unsigned>(key) ^ 0x80000000u) << 32 |
                         static_cast<unsigned>(~idx);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, k, off);
    k = o > k ? o : k;
  }
  return make_int2(static_cast<int>(static_cast<unsigned>(k >> 32) ^ 0x80000000u), ~static_cast<int>(k));"""
BALLOT = """  const int best = __reduce_max_sync(kFull, key);
  const int src = __ffs(__ballot_sync(kFull, key == best)) - 1;  // lane order is index order
  return make_int2(best, __shfl_sync(kFull, idx, src));"""
# the index step by one __ballot_sync a point slot: the lowest lane holding
# the max at slot m is __ffs of its ballot, its index kPer * lane + m
VOTE_FN = ("template <int kWarps, int kPer>\n__global__",
           """template <int kPer>
__device__ __forceinline__ int2 warp_argmax_vote(int key, int at, int first) {
  const int best = __reduce_max_sync(kFull, key);
  int idx = INT_MAX;
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const unsigned b = __ballot_sync(kFull, key == best && at == m);
    idx = b ? min(idx, kPer * (__ffs(b) - 1) + m) : idx;
  }
  return make_int2(best, first + idx);
}

template <int kWarps, int kPer>
__global__""")
VOTE_CALL = ("    own[buf] = warp_argmax(l.x, l.y);",
             "    own[buf] = warp_argmax_vote<kPer>(l.x, l.y - base, (threadIdx.x & ~31) * kPer);")
# the warp's max, then, when one lane holds it (no tie across lanes), that
# lane stores its (key, index) and the index needs no second reduction
UNIQ = ("    own[buf] = warp_argmax(l.x, l.y);  // every lane stores its warp's winner: no branch", """    {
      const int best = __reduce_max_sync(kFull, l.x);
      const bool mine = l.x == best;
      const unsigned holders = __ballot_sync(kFull, mine);
      if (holders & (holders - 1))  // a tie across lanes: the least index
        own[buf] = make_int2(best, static_cast<int>(__reduce_min_sync(kFull, mine ? l.y : UINT_MAX)));
      else if (mine)
        own[buf] = l;
    }""")
# the warp's max, then the lowest lane holding it stores its own (key,
# index): lane order is index order, so it holds the least index; the slot
# store is the broadcast, and no second reduction is needed
LOWLANE = ("    own[buf] = warp_argmax(l.x, l.y);  // every lane stores its warp's winner: no branch", """    {
      const int best = __reduce_max_sync(kFull, l.x);
      const unsigned holders = __ballot_sync(kFull, l.x == best);
      if (l.x == best && (holders & lower) == 0) own[buf] = l;
    }""")
LOWER = ("  int old = 0;\n", "  int old = 0;\n  const unsigned lower = (1u << threadIdx.x % 32) - 1;  // the lanes below this one\n")
SLOTS = """    const int buf = (j & 1) * kWarps;
    own[buf] = warp_argmax(l.x, l.y);  // every lane stores its warp's winner: no branch
    __syncthreads();
    int2 all[kWarps];  // warps ascend in index, so the slots do too
#pragma unroll
    for (int v = 0; v < kWarps; ++v) all[v] = slots[buf + v];
    old = tree_argmax(all).y;"""
ONE_WARP = "    if constexpr (kWarps == 1) {\n      old = warp_argmax(l.x, l.y).y;\n    } else {\n" + SLOTS + "\n    }"
# one 64-bit shared atomicMax a warp (usually) on (key with its sign bit
# flipped, ~index), triple-buffered: pick j clears pick j + 1's word, which
# pick j - 2 used and every warp has read by barrier j - 1
ATOM = """    const int wmax = __reduce_max_sync(kFull, l.x);
    if (l.x == wmax)
      atomicMax(&best64[k3], static_cast<unsigned long long>(static_cast<unsigned>(l.x) ^ 0x80000000u) << 32 |
                                 static_cast<unsigned>(~l.y));
    const int next = k3 == 2 ? 0 : k3 + 1;
    if (threadIdx.x == 0) best64[next] = 0ull;
    __syncthreads();
    old = ~static_cast<int>(static_cast<unsigned>(best64[k3]));
    k3 = next;"""
DECL = "  __shared__ int2 slots[2 * kWarps];  // each warp's winner, double-buffered by pick\n"
ATOM_DECL = (DECL, DECL + "  __shared__ unsigned long long best64[3];\n"
             "  if (threadIdx.x < 3) best64[threadIdx.x] = 0ull;\n  int k3 = 0;\n")
PTS = "  extern __shared__ float4 pts[];  // [N] (x, y, z, 0)\n"
LAUNCH = "  if (N <= 512) return launch<4, 4>(xyz, out, B, N, npoint, s);"


def _at_512(layout):
    return LAUNCH, LAUNCH.replace("<4, 4>", layout)


PATCHES = {  # variant: [(old, new), ...] on fps.cu
    "base": [],
    "a": [_at_512("<1, 16>"), (SLOTS, ONE_WARP)],
    "a_bfly": [_at_512("<1, 16>"), (SLOTS, ONE_WARP), (REDUX, BFLY)],
    "bfly": [(REDUX, BFLY)],
    "ballot": [(REDUX, BALLOT)],
    "vote": [VOTE_FN, VOTE_CALL],
    "atom": [(SLOTS, ATOM), ATOM_DECL],
    "uniq": [UNIQ],
    "lowlane": [LOWLANE, LOWER],
    "w2": [_at_512("<2, 8>")],
    "w8": [_at_512("<8, 2>")],
    "w16": [_at_512("<16, 1>")],
    "endstore": [(PTS, PTS.replace("0)\n", "0), then the picks [npoint]\n")
                  + "  int* picks = reinterpret_cast<int*>(pts + N);\n"),
                 ("  if (threadIdx.x == 0) dst[0] = 0;", "  if (threadIdx.x == 0) picks[0] = 0;"),
                 ("    if (threadIdx.x == 0) dst[j] = old;\n  }\n}",
                  "    if (threadIdx.x == 0) picks[j] = old;\n  }\n  __syncthreads();\n"
                  "  for (int i = threadIdx.x; i < npoint; i += 32 * kWarps) dst[i] = picks[i];\n}"),
                 ("static_cast<size_t>(N) * sizeof(float4);",
                  "static_cast<size_t>(N) * sizeof(float4) + static_cast<size_t>(npoint) * sizeof(int);")],
    "f3": [(PTS, "  extern __shared__ float sx[];  // [N] x, then y, z\n  float* sy = sx + N;\n  float* sz = sy + N;\n"),
           ("    if (i < N) pts[i] = make_float4(px[m], py[m], pz[m], 0.f);",
            "    if (i < N) {\n      sx[i] = px[m];\n      sy[i] = py[m];\n      sz[i] = pz[m];\n    }"),
           ("    const float4 o = pts[old];", "    const float4 o = make_float4(sx[old], sy[old], sz[old], 0.f);")],
    # ablations, timing only (they pick other points): what a part costs
    "nored": [(REDUX, "  return make_int2(key, idx);")],  # no cross-lane step
}
PATCHES["a_end"] = PATCHES["a"] + PATCHES["endstore"]
ABLATIONS = ("nored",)


def build(names, parent):
    """Build every variant's fps library, one nvcc process each, at once;
    prints ptxas's usage of each instantiation.  Returns {variant: path}."""
    nvcc, procs = kernels._nvcc(), []
    for name in names:
        src = os.path.join(VARIANT_DIR, name)
        if os.path.isdir(src):
            shutil.rmtree(src)
        if name == "parent":
            shutil.copytree(parent, src)
        else:
            os.makedirs(src)
            with open(os.path.join(kernels.CSRC, "fps.cu")) as f:
                text = f.read()
            for old, new in PATCHES[name]:
                if old not in text:
                    raise RuntimeError(f"variant {name}: patch does not apply to fps.cu: {old[:60]!r}")
                text = text.replace(old, new)
            with open(os.path.join(src, "fps.cu"), "w") as f:
                f.write(text)
        lib = os.path.join(src, "libfps.so")
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-o", lib, os.path.join(src, "fps.cu")]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    paths = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} fps.cu:\n{log}")
        for kernel, regs, frame, stores, loads in ptxas_usage(log):
            print(f"built {name}: {kernel} {regs} registers, {frame} bytes stack frame, {stores} bytes spill "
                  f"stores, {loads} bytes spill loads", flush=True)
        paths[name] = lib
    return paths


def swap_in(paths, name):
    """The wrapper loads through kernels.load, which returns this."""
    kernels._libs["fps"] = ctypes.CDLL(paths[name])


def time_variants(names, paths, smi):
    """{variant: [{B: ms} per run]}, each run checked against fps_ref."""
    g = torch.Generator().manual_seed(0)
    clouds = {B: fps_cloud(B, g).cuda() for B in BATCHES}
    plain = {B: sampling.fps_ref(xyz, 128) for B, xyz in clouds.items()}
    runs = {}
    for name in names:
        swap_in(paths, name)
        times = {}
        for B, xyz in clouds.items():
            got = sampling.furthest_point_sample(xyz, 128)
            torch.cuda.synchronize()
            if name not in ABLATIONS and not torch.equal(got, plain[B]):
                bad = (got != plain[B]).nonzero()[0].tolist()
                raise RuntimeError(f"variant {name} B={B}: picks differ from fps_ref first at clip, pick {bad}")
            times[B] = device_ms(lambda: sampling.furthest_point_sample(xyz, 128))
        # the same clip with one pick after index 0: the fixed cost
        times["npoint2"] = device_ms(lambda: sampling.furthest_point_sample(clouds[1], 2))
        runs.setdefault(name, []).append(times)
        print(f"[{smi}] {name:8s} " + "  ".join(f"B={B} {times[B]:.4f} ms" for B in BATCHES)
              + f"  B=1 npoint=2 {times['npoint2']:.4f} ms"
              + ("  (ablation: picks not checked)" if name in ABLATIONS else "  (picks equal fps_ref)"), flush=True)
    return runs


def report_pairs(names, runs, smi):
    """Each base run against the parent run next to it in the turns."""
    if "parent" not in runs:
        return
    seq, count = [], {}
    for name in names:
        if name in ("parent", "base"):
            seq.append((name, runs[name][count.get(name, 0)]))
            count[name] = count.get(name, 0) + 1
    pairs = [(ta, tb) if na == "base" else (tb, ta) for (na, ta), (nb, tb) in zip(seq, seq[1:]) if na != nb]
    for i, (base, parent) in enumerate(pairs, 1):
        print(f"[{smi}] pair {i} (base / parent): " + "  ".join(
            f"B={B} {base[B]:.4f} / {parent[B]:.4f} ms = {base[B] / parent[B]:.3f}x" for B in BATCHES), flush=True)


def report_floor(floor, runs, smi):
    lat = floor["lat"]
    print(f"[{smi}] latencies (cycles a dependent op): " + ", ".join(f"{op} {c:.2f}" for op, c in lat.items()))
    f_ms = 127 * floor["pick_cycles"] / floor["sm_mhz"] * 1e-3
    print(f"[{smi}] SM clock {floor['sm_mhz']:.0f} MHz by nvidia-smi under load (max {floor['max_mhz']:.0f}, "
          f"clock64 / globaltimer {floor['timer_mhz']:.1f}); one pick LDS.128 {lat['LDS.128']:.2f} + 3 FADD "
          f"{3 * lat['FADD']:.2f} + FMUL {lat['FMUL']:.2f} + FMNMX {lat['FMNMX']:.2f} + 4 IMNMX "
          f"{4 * lat['IMNMX']:.2f} + REDUX {lat['REDUX']:.2f} = {floor['pick_cycles']:.2f} cycles; floor of 127 "
          f"picks {f_ms:.5f} ms", flush=True)
    for name, ts in runs.items():
        med = {k: np.median([t[k] for t in ts]) for k in ts[0]}
        slope = (med[1] - med["npoint2"]) / 126 * 1e3 * floor["sm_mhz"]
        print(f"[{smi}] {name:8s} share of the floor: " + "  ".join(
            f"B={B} {f_ms / med[B]:.3f} ({med[B] * 1e3 * floor['sm_mhz'] / 127:.1f} cycles a pick)" for B in BATCHES)
            + f"; by the slope from npoint 2 to 128 at B=1 {slope:.1f} cycles a pick, fixed "
            f"{med['npoint2'] * 1e3:.2f} us")


def time_generate(paths, names, smi):
    """f32 generate at B=1 and 32 with the parent's and the shipped library
    (else the first and the last named variant's), in turns."""
    from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig

    rng = np.random.RandomState(0)
    model = P2RNet(P2RNetConfig(), device="cuda", generator=torch.Generator().manual_seed(42))
    folded = model.fold_eval()
    a, b = ("parent", "base") if "parent" in names else (names[0], names[-1])
    for B, iters in ((1, 20), (32, 3)):
        x = (rng.randn(B, T, W0 // 64, 3) * 0.4).astype(np.float32)
        x[..., 0] += np.linspace(0, 3, T, dtype=np.float32)[None, :, None]
        x = torch.from_numpy(x).cuda()
        runs, inds = {}, {}
        for name in (a, b, b, a):
            swap_in(paths, name)
            runs.setdefault(name, []).append(cuda_ms(lambda: model.generate(x, folded=folded), iters=iters, warmup=2))
            inds[name] = model.generate(x, folded=folded)["aggregated_vote_inds"]
        same = torch.equal(inds[a], inds[b])
        print(f"[{smi}] B={B} f32 generate (CUDA events, means of {iters}, in turns {a}/{b}/{b}/{a}): "
              + "; ".join(f"{n} {' / '.join(f'{t:.3f}' for t in ts)} ms" for n, ts in runs.items())
              + f"; the same proposals: {same}", flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", help="another tree's csrc/ directory, timed as the variant 'parent'")
    p.add_argument("--rounds", type=int, default=2, help="times the list of variants is run")
    p.add_argument("--generate", action="store_true", help="also time the f32 generate at B=1 and 32")
    p.add_argument("variants", nargs="*")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_fps_variants: needs a CUDA card")
    set_precision_policy()
    ends = ["parent", "base"] if args.parent else ["base"]
    one = args.variants or ends + [n for n in PATCHES if n not in ("base", *ABLATIONS)] + list(ABLATIONS) + ends[::-1]
    names = one * args.rounds
    smi = nvidia_smi()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch {torch.__version__}", flush=True)
    probe = start_probe_build()
    paths = build(sorted(set(names)), args.parent)
    floor = fps_latency_floor(probe())
    runs = time_variants(names, paths, smi)
    report_pairs(names, runs, smi)
    report_floor(floor, runs, smi)
    if args.generate:
        time_generate(paths, names, smi)


if __name__ == "__main__":
    main()
