// Fused ST-GCN train backward: temporal-conv transpose + ReLU mask + BN1
// column moments + tap gradient, f32 and bf16 legs, Hopper (sm_90a).
//
// Replaces: pose2room_tpu/ops/stgcn_train.py:_bwd_kernel (Pallas, TPU),
// reached through _tconv_bwd once per ST-GCN block in the train step's
// backward.
//
// Computes, on merged activations (B*T, Wp) with Wp = 27*128 = 3456:
//   t1    = relu(y * s1 + sh1)                (recomputed; never stored)
//   dt1   = dy2[t+1] @ KBT[0] + dy2[t] @ KBT[1] + dy2[t-1] @ KBT[2]
//   dpre  = (t1 > 0) ? dt1 : 0
//   tile_parts[b, part] = per-column [sum(dpre), sum(dpre * y)] over the rows
//                         of 64-row part `part` (ROW_TILE in ops/stgcn_train.py)
//   tap_parts[block, s] = sum over the block's tiles of shift_s(t1)^T @ dy2,
//                         the joint's 64x64 diagonal block
// KBT (3,128,128) holds the transposed block-diagonal taps; the kernel reads
// only their diagonal 64x64 blocks.  The wrapper sums tile_parts over the
// parts of a clip and tap_parts over the blocks with fixed-order sums, so the
// tap gradient is the diagonal-block fold of the TPU kernel's dense dKB and
// repeated runs agree bit for bit (no float atomics).
//
// What bounds it on an H100: operations.  At B=8, dt1 and the tap gradient
// each need 2*6144*3456*192 = 8.15 GFLOP, 16.3 GFLOP in all: 0.243 ms as f32
// FMAs on the CUDA cores (67 TFLOP/s), 0.099 ms as three TF32 products each
// on the tensor cores (3xTF32, 495 TFLOP/s), while dy2, y and dpre move
// 255 MB (0.076 ms at 3.35 TB/s).
//
// Design: both products on the tensor cores in 3xTF32 (tconv_mma.cuh's
// arithmetic: each k-step's three products in a fresh fragment folded into
// the accumulator by an IEEE add), on tconv_mma.cuh's persistent,
// parity-split grid with 128-row tiles, one block of 8 warps an SM.  The
// block stages its joints' three transposed diagonal taps once, in reverse
// tap order, so that tconv_mma computes the transpose unchanged.  Per tile
// it stages slabs of dy2 and of y with the t-1/t+1 halo by cp.async (zero
// outside the clip), double-buffered: the next tile's copies run during this
// tile's products.  All threads build t1 from y into a third slab, rounded as
// a product then a sum (no FMA contraction), as kernel 3 and the plain
// version compute it, so the ReLU mask agrees bit for bit.  Then the warps
// split in two roles (warp-uniform, so each keeps only its own registers):
//   warps 0-3: dt1 = tconv_mma(dy2 slab, reversed taps), 32 rows each; the
//     mask, dpre, and the column moments, summed over a warp's rows by
//     shuffles and over the two warps of each 64-row part in a fixed order;
//   warps 4-7: the tap gradient as a GEMM with K over the tile's rows:
//     A = t1 slab^T at row offset s (read column-wise), B = the dy2 rows,
//     both with 2-way bank conflicts on tconv_mma.cuh's swizzle; the stacked (3*64) x 64 output is
//     cut into 12 m-tiles, 3 a warp, held in registers across every tile the
//     block walks (96 floats a thread) and written once per block.
// Shared memory: taps 48 KB, two dy2 and two y slabs and the t1 slab 33 KB
// each, 2 KB of moment partials: 212.5 KB.  Pad columns (3392..3455) come
// out exactly 0 because y, vecs and dy2 are 0 there.
//
// The bf16 leg (p2r_stgcn_train_bwd_bf16; model.compute_dtype: bfloat16)
// takes dy2, y, KBT and dpre in bf16 and vecs, tile_parts and tap_parts in
// f32, and rounds where the Pallas kernel's bf16 path rounds: dt1 from bf16
// dy2 and bf16 taps into an f32 accumulator; the mask pre > 0 with pre =
// y * s1 + sh1 in f32 from the bf16 y (a product then a sum); dpre rounded
// to nearest even into bf16, its column moments from the UNROUNDED f32
// dpre; the tap gradient from bf16 t1 = round(relu(pre)) and bf16 dy2 into
// f32.  Every product is one mma.sync.m16n8k16 into a fresh fragment folded
// in by an IEEE add (tconv_bf16.cuh): the tap gradient sums hundreds of
// k-steps a block into one accumulator, where the tensor cores' truncating
// adds would bias it most.  Bound: bytes (dy2, y and dpre are 127 MB at
// B=8, 0.038 ms at 3.35 TB/s; the 16.3 GFLOP are 0.016 ms at the bf16
// tensor-core rate).  What held an earlier design (8 warps an SM in two
// roles, 4 on dt1 and 4 on the tap gradient at 255 registers) at a fifth
// of that: the per-tile phases in series and the dt1 role on one warp a
// scheduler.  So (scripts/torch_bf16_train_variants.py measures each
// choice): items of 128 rows x 64 columns (one joint), blocks of 8 warps,
// two an SM, each walking the joints of one parity with its transposed
// diagonal tap block staged once, k-major, by cp.async; the dy2 and y
// slabs and s1 / sh1 double-buffered by cp.async; t1 built by all threads
// into its own slab; every warp then computes its dt1 tile (32 rows x 32
// columns, in two passes of 16 columns, on tconv_mma_kmajor: the earlier
// leg's sums in the same order, so dpre and the moments keep their bits),
// its epilogue (dpre stored from the registers: the two blocks' shared
// memory leaves no room to stage it), and then its 3 x 4 tiles of the block's (3 * 64) x 64 tap
// gradient over the item's rows (48 floats a thread, held across the
// block's items and written once), so the two accumulators are never live
// together and the leg fits 128 registers without spills (the t1 pass
// keeps 2 of its 16-byte steps in flight; with 3, ptxas spills a
// register).  The tap gradient folds every
// k16 step (fold 1): accumulating 2 or 4 steps in one fragment chains each
// mma on the last and measured slower (0.154 / 0.166 against 0.126 ms at
// B=8); fold 1's f32 sum is within 6.9e-9 of sum |a*b| of float64, bias
// -6.1e-11 (B=1) and -2.4e-11 (B=8), on an NVIDIA H100.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tconv_bf16.cuh"
#include "tconv_mma.cuh"

namespace {

using namespace tconv;

constexpr int kBwdThreads = 256;     // warps 0-3: dt1; warps 4-7: the tap gradient
constexpr int kRoleThreads = kBwdThreads / 2;
constexpr int kPartRows = 64;        // ROW_TILE: the row granularity of tile_parts
constexpr int kWarpsPerPart = kPartRows / (16 * kMT);
constexpr int kGradMT = 3 * kC / 16 / 4;  // m-tiles of the stacked (tap, channel) rows a warp owns
constexpr int kRedFloats = 4 * 2 * kC;    // [dt1 warp][moment][column]
constexpr size_t kSmemBytes = (kTapFloats + 5 * kSlabFloats + kRedFloats) * sizeof(float);

static_assert(kRows == 16 * kMT * (kRoleThreads / 32), "the dt1 warps cover the tile's rows");
static_assert(kBwdThreads == 2 * 2 * kC, "one thread per (part, moment, column) of a tile");

// every thread of the block; the two roles reach it from their own loops
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kBwdThreads) : "memory");
}

struct Bufs {
  const float* taps;
  float* dslab;  // [2][kSlabFloats] dy2
  float* yslab;  // [2][kSlabFloats] y
  float* tslab;  // t1 of the current tile
  float* red;
};

// The tile's two 64-row parts of column moments: its two dt1 warps' rows
// each, summed in a fixed order (one thread per part, moment and column).
__device__ __forceinline__ void write_tile_parts(const float* red, const TileAt& a, float* __restrict__ tile_parts,
                                                 int n_parts, int Wp) {
  const int h = threadIdx.x / (2 * kC);
  const int moment = (threadIdx.x / kC) % 2;
  const int col = threadIdx.x % kC;
  const int part = a.t0 / kPartRows + h;
  if (part < n_parts) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerPart; ++w) total += red[((h * kWarpsPerPart + w) * 2 + moment) * kC + col];
    tile_parts[((static_cast<size_t>(a.b) * n_parts + part) * 2 + moment) * Wp + a.col0 + col] = total;
  }
}

// The grad role's running sum, once per block: m-tile (3 * gwarp + mi) of
// the stacked (tap, input channel) rows of tap_parts[block].
__device__ __forceinline__ void write_tap_parts(const float (&gacc)[kGradMT][kNT][4], float* __restrict__ tap_parts) {
  const int gwarp = (threadIdx.x >> 5) - 4;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  float* out = tap_parts + static_cast<size_t>(blockIdx.x) * kTapFloats;
#pragma unroll
  for (int mi = 0; mi < kGradMT; ++mi) {
    const int m = kGradMT * gwarp + mi;
    const int s = m / 4;
    const int i = (m % 4) * 16 + g;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(out + (s * kC + i + 8 * half) * kC + nt * 8 + 2 * c) =
            make_float2(gacc[mi][nt][2 * half], gacc[mi][nt][2 * half + 1]);
  }
}

// dt1 of the warp's 32 rows, the mask, dpre and the warp's column moments
__device__ __forceinline__ void dt1_tile(const Bufs& sm, const float* ds, const float* ys,
                                         const TileAt& a, float* __restrict__ dpre, int T, int Wp) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int row0 = warp * 16 * kMT;
  float acc[kMT][kNT][4];
  tconv_mma(ds, sm.taps, row0, acc);

  float sum[kNT][2], dot[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int k = nt * 8 + 2 * c;
    sum[nt][0] = sum[nt][1] = dot[nt][0] = dot[nt][1] = 0.f;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + mt * 16 + g + 8 * half;
        const int t = a.t0 + r;
        if (t >= T) continue;
        const float2 tv = *reinterpret_cast<const float2*>(sm.tslab + slab_index(r + 1, k));
        const float2 yv = *reinterpret_cast<const float2*>(ys + slab_index(r + 1, k));
        const float d0 = tv.x > 0.f ? acc[mt][nt][2 * half] : 0.f;
        const float d1 = tv.y > 0.f ? acc[mt][nt][2 * half + 1] : 0.f;
        *reinterpret_cast<float2*>(dpre + (a.clip_row0 + t) * Wp + a.col0 + k) = make_float2(d0, d1);
        sum[nt][0] += d0;
        sum[nt][1] += d1;
        dot[nt][0] += d0 * yv.x;
        dot[nt][1] += d1 * yv.y;
      }
  }
  // sum over the warp's 8 row groups (lanes of equal c), then one lane per c writes
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        sum[nt][j] += __shfl_xor_sync(0xffffffffu, sum[nt][j], off);
        dot[nt][j] += __shfl_xor_sync(0xffffffffu, dot[nt][j], off);
      }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sm.red[(warp * 2 + 0) * kC + nt * 8 + 2 * c + j] = sum[nt][j];
        sm.red[(warp * 2 + 1) * kC + nt * 8 + 2 * c + j] = dot[nt][j];
      }
  }
}

// gacc[mi] += the tile's share of m-tile (3 * gwarp + mi) of the stacked
// tap gradient: rows (s, i0 .. i0 + 16) of dKB[s] = sum_r t1[r + s - 1]^T dy2[r]
__device__ __forceinline__ void grad_tile(const float* tslab, const float* ds, int k_end,
                                          float (&gacc)[kGradMT][kNT][4]) {
  const int gwarp = (threadIdx.x >> 5) - 4;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll 1
  for (int k0 = 0; k0 < k_end; k0 += 8) {
    uint32_t ab[kGradMT][4], as[kGradMT][4];
#pragma unroll
    for (int mi = 0; mi < kGradMT; ++mi) {
      const int m = kGradMT * gwarp + mi;
      const int r = k0 + c + m / 4;  // slab row of t1[t + s - 1] for tile row k0 + c, s = m / 4
      const int i = (m % 4) * 16 + g;
      split(tslab[slab_index(r, i)], ab[mi][0], as[mi][0]);
      split(tslab[slab_index(r, i + 8)], ab[mi][1], as[mi][1]);
      split(tslab[slab_index(r + 4, i)], ab[mi][2], as[mi][2]);
      split(tslab[slab_index(r + 4, i + 8)], ab[mi][3], as[mi][3]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      uint32_t bb0, bs0, bb1, bs1;
      split(ds[slab_index(k0 + c + 1, nt * 8 + g)], bb0, bs0);
      split(ds[slab_index(k0 + c + 5, nt * 8 + g)], bb1, bs1);
#pragma unroll
      for (int mi = 0; mi < kGradMT; ++mi) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, as[mi], bb0, bb1);
        mma_tf32(part, ab[mi], bs0, bs1);
        mma_tf32(part, ab[mi], bb0, bb1);
#pragma unroll
        for (int i = 0; i < 4; ++i) gacc[mi][nt][i] += part[i];
      }
    }
  }
}

// The walk over the block's tiles, as one role: staging, t1 and the moments'
// last sum are shared work (every thread, in both roles), the products are
// the role's.  kGrad: the tap gradient role.
template <bool kGrad>
__device__ __forceinline__ void walk(const Bufs& sm, const float* __restrict__ dy2,
                                     const float* __restrict__ y, const float* __restrict__ vecs,
                                     float* __restrict__ dpre, float* __restrict__ tile_parts,
                                     float* __restrict__ tap_parts, int B, int T, int Wp) {
  const int items = (Wp / kC / 2) * B * ((T + kRows - 1) / kRows);
  const int stride = gridDim.x / 2;
  const int n_parts = (T + kPartRows - 1) / kPartRows;
  const int q = threadIdx.x % (kC / 4);  // the float4 column this thread stages and turns into t1
  float gacc[kGradMT][kNT][4];  // the grad role's running sum (unused by the other)
  if constexpr (kGrad) {
#pragma unroll
    for (int mi = 0; mi < kGradMT; ++mi)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) gacc[mi][nt][i] = 0.f;
  }

  int item = blockIdx.x >> 1;
  TileAt a = tile_at(item, B, T);
  for (int buf = 0; item < items; item += stride, buf ^= 1) {
    const bool more = item + stride < items;
    const TileAt next = tile_at(more ? item + stride : item, B, T);
    const float* ds = sm.dslab + buf * kSlabFloats;
    const float* ys = sm.yslab + buf * kSlabFloats;
    if (more) {  // the next tile's copies run during this tile's products
      stage_slab<kBwdThreads>(sm.dslab + (buf ^ 1) * kSlabFloats, dy2, next.clip_row0, next.t0, T, Wp, next.col0);
      stage_slab<kBwdThreads>(sm.yslab + (buf ^ 1) * kSlabFloats, y, next.clip_row0, next.t0, T, Wp, next.col0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    block_sync();  // this tile's slabs have landed

    const float4 s1 = __ldg(reinterpret_cast<const float4*>(vecs + a.col0 + 4 * q));
    const float4 sh1 = __ldg(reinterpret_cast<const float4*>(vecs + Wp + a.col0 + 4 * q));
    for (int i = threadIdx.x; i < (kRows + 2) * (kC / 4); i += kBwdThreads) {
      const int r = i / (kC / 4);
      const int t = a.t0 - 1 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);  // t1 is 0 outside the clip
      if (t >= 0 && t < T) {
        v = *reinterpret_cast<const float4*>(ys + slab_index(r, 4 * q));
        v.x = fmaxf(__fadd_rn(__fmul_rn(v.x, s1.x), sh1.x), 0.f);
        v.y = fmaxf(__fadd_rn(__fmul_rn(v.y, s1.y), sh1.y), 0.f);
        v.z = fmaxf(__fadd_rn(__fmul_rn(v.z, s1.z), sh1.z), 0.f);
        v.w = fmaxf(__fadd_rn(__fmul_rn(v.w, s1.w), sh1.w), 0.f);
      }
      *reinterpret_cast<float4*>(sm.tslab + slab_index(r, 4 * q)) = v;
    }
    block_sync();  // t1 is built

    if constexpr (kGrad) {
      // rows past the clip hold dy2 = 0 and add nothing
      const int k_end = min(kRows, (T - a.t0 + 7) / 8 * 8);
      grad_tile(sm.tslab, ds, k_end, gacc);
    } else {
      dt1_tile(sm, ds, ys, a, dpre, T, Wp);
    }
    block_sync();  // the slabs are read and the moment partials written

    write_tile_parts(sm.red, a, tile_parts, n_parts, Wp);
    // red is written again only after the next tile's second block_sync
    a = next;
  }
  if constexpr (kGrad) write_tap_parts(gacc, tap_parts);
}

__global__ void __launch_bounds__(kBwdThreads, 1)
train_bwd_kernel(const float* __restrict__ dy2, const float* __restrict__ y,
                 const float* __restrict__ vecs, const float* __restrict__ kbt,
                 float* __restrict__ dpre, float* __restrict__ tile_parts,
                 float* __restrict__ tap_parts, int B, int T, int Wp) {
  extern __shared__ __align__(16) float smem[];
  Bufs sm;
  sm.taps = smem;  // taps[s] = KBT[2 - s] diagonal block
  sm.dslab = smem + kTapFloats;
  sm.yslab = sm.dslab + 2 * kSlabFloats;
  sm.tslab = sm.yslab + 2 * kSlabFloats;
  sm.red = sm.tslab + kSlabFloats;

  // the taps and the first tile's slabs: one copy group
  const TileAt a = tile_at(blockIdx.x >> 1, B, T);
  stage_taps<kBwdThreads>(smem, kbt, (blockIdx.x & 1) * kC, true);
  stage_slab<kBwdThreads>(sm.dslab, dy2, a.clip_row0, a.t0, T, Wp, a.col0);
  stage_slab<kBwdThreads>(sm.yslab, y, a.clip_row0, a.t0, T, Wp, a.col0);
  cp_async_commit();

  if (threadIdx.x < kRoleThreads) {
    walk<false>(sm, dy2, y, vecs, dpre, tile_parts, tap_parts, B, T, Wp);
  } else {
    walk<true>(sm, dy2, y, vecs, dpre, tile_parts, tap_parts, B, T, Wp);
  }
}

namespace tb = tconv_bf16;

// bf16 leg: an item is 128 rows x 64 columns (one joint) of one clip; a
// block has 8 warps, which share both products, and two blocks share an SM,
// each walking the joints of one parity with its one diagonal tap block.
constexpr int kWarpRowsBf16 = 32;                     // dt1: 32 rows x 32 columns a warp
constexpr int kRowGroups = kRows / kWarpRowsBf16;     // 4
constexpr int kThreadsBf16 = kRowGroups * 2 * 32;     // a row group's two column halves
constexpr int kNTBf16 = 4;
constexpr int kDt1Passes = 2;   // dt1 in column passes of kNTBf16 / kDt1Passes n-tiles: fewer live registers
constexpr int kT1Unroll = 2;    // the t1 pass with 2 of its 16-byte steps in flight: no spills
constexpr int kGradMTBf16 = 3;  // the tap gradient: 3 m-tiles of the stacked (tap, channel) rows a warp
constexpr int kGradNT = 4;      // and 4 n-tiles
struct alignas(16) SmemBf16 {
  tb::bf16 taps[tb::kTapElems];        // the parity's KBT[2 - s] diagonal block, k-major
  tb::bf16 dslab[2][tb::kSlabElems];   // [buffer]: dy2 rows t0 - 1 .. t0 + 128
  tb::bf16 yslab[2][tb::kSlabElems];   // [buffer]: y
  tb::bf16 tslab[tb::kSlabElems];      // t1 of the current item, rounded to bf16
  float vec[2][2][kC];                 // [buffer]: s1, sh1 of the item's columns
  float red[kRowGroups][2][kC];        // [row group][moment][column]
};
static_assert(kThreadsBf16 / 32 * kGradMTBf16 * kGradNT == 3 * (kC / 16) * (kC / 8),
              "the warps cover the stacked tap gradient");
static_assert(kThreadsBf16 == 2 * (kRows / kPartRows) * kC, "one thread per (part, moment, column)");
static_assert(kThreadsBf16 == kBwdThreads, "configure() sizes both legs' blocks");

// The warp's parts of an item, warp-uniform and recomputed where they are
// used (not held in registers across the item loop): its dt1 tile (row
// group, first column) and its tiles of the tap gradient (first m-tile,
// first n-tile).
struct Roles {
  int rg, n0, gm0, gn0;
};
__device__ __forceinline__ Roles roles() {
  const int warp = threadIdx.x >> 5;
  return {warp / 2, (warp % 2) * (8 * kNTBf16), kGradMTBf16 * (warp / 2), kGradNT * (warp % 2)};
}

// Start the copies of one item into buffer buf: its dy2 and y slabs (rows
// outside the clip zero-filled) and its s1, sh1.
__device__ __forceinline__ void stage_item_bf16(SmemBf16& sm, int buf, const TileAt& a,
                                                const tb::bf16* __restrict__ dy2, const tb::bf16* __restrict__ y,
                                                const float* __restrict__ vecs, int T, int Wp) {
  tb::stage_slab<kThreadsBf16>(sm.dslab[buf], dy2, a.clip_row0, a.t0, T, Wp, a.col0);
  tb::stage_slab<kThreadsBf16>(sm.yslab[buf], y, a.clip_row0, a.t0, T, Wp, a.col0);
  if (threadIdx.x < 2 * kC / 4) {  // 16 chunks of s1, of sh1
    const int row = threadIdx.x / (kC / 4);
    const int q = threadIdx.x % (kC / 4);
    tb::cp_async16(&sm.vec[buf][row][4 * q], vecs + static_cast<size_t>(row) * Wp + a.col0 + 4 * q, true);
  }
}

// gacc += the item's share of the warp's 3 x 4 tiles of the stacked tap
// gradient (m-tiles gm0.., rows (s, i) of dKB[s] = sum_r t1[r + s - 1]^T
// dy2[r]; n-tiles gn0..), 16 item rows a k-step.  A (16 x 16, m = input
// channel, k = row) is the t1 slab from row k0 + s on, stored k-major:
// ldmatrix.trans; B (16 x 8, k = row, n = output channel) the dy2 slab from
// row k0 + 1 on (item row 0 is slab row 1).  Each k-step's product goes
// into a fresh fragment (the tensor cores' truncating adds) that an IEEE
// add folds into gacc.
__device__ __forceinline__ void grad_item_bf16(SmemBf16& sm, int buf, int k_end,
                                               float (&gacc)[kGradMTBf16][kGradNT][4]) {
  const int gm0 = roles().gm0;
  const int gn0 = roles().gn0;
  const int lane = threadIdx.x & 31;
  const int lrow = (lane & 7) + ((lane >> 4) & 1) * 8;  // A: matrices 2, 3 hold k 8..15
  const int lcol = ((lane >> 3) & 1) * 8;                // A: matrices 1, 3 hold m 8..15
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;  // B: matrices 1, 3 hold k 8..15
  const tb::bf16* ts = sm.tslab;
  const tb::bf16* ds = sm.dslab[buf];
  // the A fragments of the 3 m-tiles held, B one n-tile pair at a time,
  // each product folded at once: 20 transient registers
#pragma unroll 1
  for (int k0 = 0; k0 < k_end; k0 += 16) {
    uint32_t af[kGradMTBf16][4];
#pragma unroll
    for (int mi = 0; mi < kGradMTBf16; ++mi) {
      const int m = gm0 + mi;
      tb::ldmatrix_x4_trans(af[mi], ts + tb::swz64(k0 + m / 4 + lrow, (m % 4) * 16 + lcol));
    }
#pragma unroll
    for (int p = 0; p < kGradNT / 2; ++p) {
      uint32_t bf[4];  // n-tiles gn0 + 2p (matrices 0, 1) and gn0 + 2p + 1 (2, 3)
      tb::ldmatrix_x4_trans(bf, ds + tb::swz64(k0 + 1 + brow, (gn0 + 2 * p + (lane >> 4)) * 8));
#pragma unroll
      for (int mi = 0; mi < kGradMTBf16; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float part[4];
          tb::mma_bf16_fresh(part, af[mi], bf[2 * h], bf[2 * h + 1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) gacc[mi][2 * p + h][i] = __fadd_rn(gacc[mi][2 * p + h][i], part[i]);
        }
    }
  }
}

// The epilogue of the warp's dt1 (32 rows x NT n-tiles from column n0, the
// earlier leg's sums in the same order): the mask (pre > 0 from the bf16 y,
// in f32), dpre rounded to bf16 and stored from the registers, and the
// warp's column moments of the unrounded dpre (each thread its rows, the
// warp's row groups by shuffles).
template <int NT>
__device__ __forceinline__ void dt1_epilogue_bf16(SmemBf16& sm, int buf, int n0, const TileAt& a, int T, int Wp,
                                                  const float (&acc)[2][NT][4], tb::bf16* __restrict__ dpre) {
  const int rg = roles().rg;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int row0 = rg * kWarpRowsBf16;
  const tb::bf16* ys = sm.yslab[buf];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int k = n0 + nt * 8 + 2 * c;
    const float2 s1 = *reinterpret_cast<const float2*>(&sm.vec[buf][0][k]);
    const float2 sh1 = *reinterpret_cast<const float2*>(&sm.vec[buf][1][k]);
    float sum[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + mt * 16 + g + 8 * half;
        if (a.t0 + r >= T) continue;
        const float2 yv = tb::unpack2(tb::ld32(ys + tb::slab_index(r + 1, k)));
        const float d0 = __fadd_rn(__fmul_rn(yv.x, s1.x), sh1.x) > 0.f ? acc[mt][nt][2 * half] : 0.f;
        const float d1 = __fadd_rn(__fmul_rn(yv.y, s1.y), sh1.y) > 0.f ? acc[mt][nt][2 * half + 1] : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(dpre + (a.clip_row0 + a.t0 + r) * static_cast<size_t>(Wp) + a.col0 + k) =
            tb::pack_rn(d0, d1);
        sum[0] += d0;
        sum[1] += d1;
        dot[0] += d0 * yv.x;
        dot[1] += d1 * yv.y;
      }
    // sum over the warp's 8 row groups (lanes of equal c), then one lane per c writes
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], off);
        dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], off);
      }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sm.red[rg][0][k + j] = sum[j];
        sm.red[rg][1][k + j] = dot[j];
      }
    }
  }
}

// Item a's rows of tile_parts, one value a thread: the sums of the two
// warps of each 64-row part in order.
__device__ __forceinline__ void write_parts_bf16(const SmemBf16& sm, const TileAt& a, int T, int Wp,
                                                 float* __restrict__ tile_parts) {
  const int h = threadIdx.x / (2 * kC);  // 64-row part of this item
  const int moment = (threadIdx.x / kC) % 2;
  const int col = threadIdx.x % kC;
  const int part = a.t0 / kPartRows + h;
  const int n_parts = (T + kPartRows - 1) / kPartRows;
  if (part < n_parts) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kPartRows / kWarpRowsBf16; ++w)
      total += sm.red[h * (kPartRows / kWarpRowsBf16) + w][moment][col];
    tile_parts[((static_cast<size_t>(a.b) * n_parts + part) * 2 + moment) * Wp + a.col0 + col] = total;
  }
}

// The taps, the dy2 and y slabs and s1 / sh1 come in by cp.async, the next
// item's while this one is computed; every thread builds t1; every warp
// computes its dt1 tile with its epilogue, then its share of the tap
// gradient (so the two accumulators are never live together); dpre leaves
// from the registers as bf16 pairs during the epilogue; three barriers an
// item.  Even blocks walk the even joints, odd blocks the odd ones
// (tile_at).
__global__ void __launch_bounds__(kThreadsBf16, 2)
train_bwd_kernel_bf16(const tb::bf16* __restrict__ dy2, const tb::bf16* __restrict__ y,
                      const float* __restrict__ vecs, const tb::bf16* __restrict__ kbt,
                      tb::bf16* __restrict__ dpre, float* __restrict__ tile_parts,
                      float* __restrict__ tap_parts, int B, int T, int Wp) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  SmemBf16& sm = *reinterpret_cast<SmemBf16*>(smem_bytes);

  const int items = (Wp / kLane) * B * ((T + kRows - 1) / kRows);  // of each parity
  const int stride = gridDim.x / 2;
  float gacc[kGradMTBf16][kGradNT][4];
#pragma unroll
  for (int mi = 0; mi < kGradMTBf16; ++mi)
#pragma unroll
    for (int nt = 0; nt < kGradNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) gacc[mi][nt][i] = 0.f;

  int item = blockIdx.x / 2;
  if (item >= items) return;
  tb::stage_taps_kmajor<kThreadsBf16>(sm.taps, kbt, (blockIdx.x & 1) * kC, true);
  TileAt a = tile_at(item, B, T);
  stage_item_bf16(sm, 0, a, dy2, y, vecs, T, Wp);
  cp_async_commit();

  for (int buf = 0; item < items; item += stride, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this item has landed; red is read
    const int next = item + stride;
    const TileAt na = tile_at(next < items ? next : item, B, T);
    if (next < items) stage_item_bf16(sm, buf ^ 1, na, dy2, y, vecs, T, Wp);
    cp_async_commit();

    tb::t1_pass<kThreadsBf16, kT1Unroll>(sm.tslab, sm.yslab[buf], sm.vec[buf][0], sm.vec[buf][1], a.t0, T);
    __syncthreads();  // t1 is built

#pragma unroll 1
    for (int pass = 0; pass < kDt1Passes; ++pass) {
      constexpr int kPassNT = kNTBf16 / kDt1Passes;
      const Roles w = roles();
      const int n = w.n0 + pass * 8 * kPassNT;
      float acc[2][kPassNT][4];
      tb::tconv_mma_kmajor<2, kPassNT>(sm.dslab[buf], sm.taps, w.rg * kWarpRowsBf16, n, acc);
      dt1_epilogue_bf16(sm, buf, n, a, T, Wp, acc, dpre);
    }
    // rows past the clip hold dy2 = 0 and t1 = 0 and add nothing
    grad_item_bf16(sm, buf, min(kRows, (T - a.t0 + 15) / 16 * 16), gacc);
    __syncthreads();  // the item's moment partials are complete
    write_parts_bf16(sm, a, T, Wp, tile_parts);
    a = na;
  }
  cp_async_wait<0>();

  // the running sum, once per block: tap_parts[block]
  const int gm0 = roles().gm0;
  const int gn0 = roles().gn0;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  float* out = tap_parts + static_cast<size_t>(blockIdx.x) * kTapFloats;
#pragma unroll
  for (int mi = 0; mi < kGradMTBf16; ++mi) {
    const int m = gm0 + mi;
    const int s = m / 4;
    const int i = (m % 4) * 16 + g;
#pragma unroll
    for (int nt = 0; nt < kGradNT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(out + (s * kC + i + 8 * half) * kC + (gn0 + nt) * 8 + 2 * c) =
            make_float2(gacc[mi][nt][2 * half], gacc[mi][nt][2 * half + 1]);
  }
}

// Resident blocks of `kernel` on the card, or a cudaError_t.
template <typename Kernel>
int configure(Kernel kernel, size_t smem, int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBwdThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *slots = per_sm * sms;
  return 0;
}

// [bf16]: resident blocks of each leg's kernel, configured at first use
int slots_or_error(bool bf16, int* slots) {
  static int cached[2] = {0, 0};
  int& slot = cached[bf16 ? 1 : 0];
  if (slot == 0) {
    const int err = bf16 ? configure(train_bwd_kernel_bf16, sizeof(SmemBf16), &slot)
                         : configure(train_bwd_kernel, kSmemBytes, &slot);
    if (err != 0) return err;
  }
  *slots = slot;
  return 0;
}

int blocks_or_error(bool bf16, int B, int T, int Wp) {
  int slots = 0;
  const int err = slots_or_error(bf16, &slots);
  return err != 0 ? -err : grid_size(B, T, Wp, slots);
}

}  // namespace

// The number of blocks the launch uses for these shapes (the first dimension
// of tap_parts), or minus a cudaError_t.
extern "C" int p2r_stgcn_train_bwd_blocks(int B, int T, int Wp) { return blocks_or_error(false, B, T, Wp); }

// The same for the bf16 leg.
extern "C" int p2r_stgcn_train_bwd_bf16_blocks(int B, int T, int Wp) { return blocks_or_error(true, B, T, Wp); }

// dy2, y, dpre: (B*T, Wp) contiguous f32, 16-byte aligned; vecs: (4, Wp) f32
// rows [s1, sh1, 0, 0]; kbt: (3, 128, 128) f32 transposed taps; tile_parts:
// (B, ceil(T/64), 2, Wp) f32; tap_parts: (blocks, 3, 64, 64) f32 with blocks
// from p2r_stgcn_train_bwd_blocks.  Wp % 128 == 0.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int p2r_stgcn_train_bwd_f32(const float* dy2, const float* y, const float* vecs,
                                       const float* kbt, float* dpre, float* tile_parts,
                                       float* tap_parts, int B, int T, int Wp, int blocks,
                                       void* stream) {
  const int expect = blocks_or_error(false, B, T, Wp);
  if (expect < 0) return -expect;
  if (blocks != expect) return static_cast<int>(cudaErrorInvalidValue);
  train_bwd_kernel<<<blocks, kBwdThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      dy2, y, vecs, kbt, dpre, tile_parts, tap_parts, B, T, Wp);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 leg.  dy2, y, dpre: (B*T, Wp) contiguous bf16, 16-byte aligned;
// vecs: (4, Wp) f32 rows [s1, sh1, 0, 0]; kbt: (3, 128, 128) bf16 transposed
// taps; tile_parts: (B, ceil(T/64), 2, Wp) f32; tap_parts: (blocks, 3, 64,
// 64) f32 with blocks from p2r_stgcn_train_bwd_bf16_blocks.  Wp % 128 == 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int p2r_stgcn_train_bwd_bf16(const __nv_bfloat16* dy2, const __nv_bfloat16* y, const float* vecs,
                                        const __nv_bfloat16* kbt, __nv_bfloat16* dpre, float* tile_parts,
                                        float* tap_parts, int B, int T, int Wp, int blocks, void* stream) {
  const int expect = blocks_or_error(true, B, T, Wp);
  if (expect < 0) return -expect;
  if (blocks != expect) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  train_bwd_kernel_bf16<<<blocks, kThreadsBf16, sizeof(SmemBf16), static_cast<cudaStream_t>(stream)>>>(
      dy2, y, vecs, kbt, dpre, tile_parts, tap_parts, B, T, Wp);
  return static_cast<int>(cudaGetLastError());
}
