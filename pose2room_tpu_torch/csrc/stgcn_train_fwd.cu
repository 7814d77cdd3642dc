// Fused ST-GCN train forward: BN1 affine + ReLU + temporal conv + column
// moments, f32 and bf16 legs, Hopper (sm_90a).
//
// Replaces: pose2room_tpu/ops/stgcn_train.py:_fwd_kernel (Pallas, TPU),
// reached through _tconv_stats_fwd once per ST-GCN block in the train step.
//
// Computes, on merged activations (B*T, Wp) with Wp = 27*128 = 3456:
//   t1  = relu(y * s1 + sh1)                 s1 = vecs[0], sh1 = vecs[1]
//   y2  = sum_s shift_s(t1) @ KB[s] + cb     cb = vecs[2]; tap s reads row
//                                            t+s-1, zero outside the clip
//   tile_parts[b, tile] = per-column [sum(y2), sum(y2^2)] over the rows of
//                         64-row tile `tile` (ROW_TILE in ops/stgcn_train.py)
// KB (3,128,128) is block-diagonal with one C x C tap per joint (C = 64); the
// kernel reads only the diagonal block at (col0 % 128).  The wrapper sums
// tile_parts over the tiles of a clip in a fixed order.
//
// What bounds it on an H100: bytes, in principle.  At B=8 the taps need
// 2*6144*3456*192 = 8.15 GFLOP, done as three TF32 products each (3xTF32,
// tconv_mma.cuh): 0.049 ms at 495 TFLOP/s, under the 0.051 ms that y and y2
// (170 MB) need at 3.35 TB/s.  In practice the mma.sync issue rate and the
// operand splits bound it (PERF.md).
//
// Design: tconv_mma.cuh's core on a persistent grid, as kernel 1
// (stgcn_epilogue.cu), with another prologue and epilogue.  The slab of y
// comes in by cp.async (the next tile's copy overlaps this tile's epilogue)
// and is turned into t1 in place: y*s1 + sh1 is rounded as a product then a
// sum (no FMA contraction), as the plain version and kernel 4 compute it, so
// kernel 4's ReLU mask agrees; halo rows outside the clip stay 0.  Moments,
// deterministic: each thread sums its rows, a butterfly of shuffles sums the
// warp's 8 row groups, and the warps of each 64-row part are summed in
// shared memory in a fixed order; a 128-row tile writes two rows of
// tile_parts.  Pad columns (3392..3455) come out exactly 0 because y and
// vecs are 0 there.
//
// The bf16 leg (p2r_stgcn_train_fwd_bf16; model.compute_dtype: bfloat16)
// takes y, KB and y2 in bf16 and vecs and tile_parts in f32, and rounds
// where the Pallas kernel's bf16 path rounds: t1 = relu(y * s1 + sh1) in f32
// (a product then a sum), rounded to nearest even into bf16 in the slab;
// each tap product from bf16 operands into an f32 accumulator (one
// mma.sync.m16n8k16 per 16-deep k-step into a fresh fragment, folded in by
// an IEEE add, tconv_bf16.cuh); y2 = acc + cb rounded to nearest even; the
// column moments from the ROUNDED y2, in f32, in the f32 leg's fixed order.
// Bound: bytes (2 bytes an element: y and y2 are 85 MB at B=8, 0.025 ms at
// 3.35 TB/s; the 8.15 GFLOP are 0.008 ms at the bf16 tensor-core rate).
// What held an earlier design (one slab buffer, 4 warps a tile, y2 stored
// as 4-byte pairs across 8 rows) at a quarter of that: one block's phases
// in series, copy, t1 pass, conv, stores, with nothing beside them.  So
// (scripts/torch_bf16_train_variants.py measures each choice): items of
// 128 rows x 64 columns (one joint), blocks of 8 warps (32 rows x 32
// columns each, the f32 leg's rows per warp), two an SM, so that one
// block's copies, t1 pass and stores overlap the other's conv; each block
// walks the joints of one parity with its diagonal tap block staged once,
// k-major, by cp.async; the y slab and s1 / sh1 / cb double-buffered by
// cp.async, the next item's copies in flight while this one is computed;
// the t1 pass in place, each thread's s1 / sh1 read once; the conv on
// tconv_mma_kmajor (fragments by ldmatrix, the tap loop unrolled); y2
// staged row-major in a padded tile and stored 16 bytes a thread.  The sums
// are the earlier leg's in the same order, and so are y2's and the
// moments' bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tconv_bf16.cuh"
#include "tconv_mma.cuh"

namespace {

using namespace tconv;

constexpr int kPartRows = 64;  // ROW_TILE: the row granularity of tile_parts
constexpr int kWarpsPerPart = kPartRows / (16 * kMT);
constexpr int kRedFloats = 4 * 2 * kC;  // [warp][moment][column]
constexpr size_t kSmemBytes = (kTapFloats + kSlabFloats + kRedFloats) * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
train_fwd_kernel(const float* __restrict__ y, const float* __restrict__ vecs,
                 const float* __restrict__ kb, float* __restrict__ y2,
                 float* __restrict__ tile_parts, int B, int T, int Wp) {
  extern __shared__ __align__(16) float smem[];
  float* taps = smem;
  float* slab = taps + kTapFloats;
  float* red = slab + kSlabFloats;

  const int items = (Wp / kC / 2) * B * ((T + kRows - 1) / kRows);
  const int stride = gridDim.x / 2;
  const int n_parts = (T + kPartRows - 1) / kPartRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int row0 = warp * 16 * kMT;
  // the float4 column this thread stages and turns into t1 (stage_slab's)
  const int q = threadIdx.x % (kC / 4);

  int item = blockIdx.x >> 1;
  TileAt a = tile_at(item, B, T);
  stage_taps(taps, kb, (blockIdx.x & 1) * kC);
  stage_slab(slab, y, a.clip_row0, a.t0, T, Wp, a.col0);
  cp_async_commit();

  for (; item < items; item += stride) {
    const bool more = item + stride < items;
    const TileAt next = tile_at(more ? item + stride : item, B, T);
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(vecs + a.col0 + 4 * q));
    const float4 sh1 = __ldg(reinterpret_cast<const float4*>(vecs + Wp + a.col0 + 4 * q));
    cp_async_wait<0>();
    __syncthreads();

    for (int i = threadIdx.x; i < (kRows + 2) * (kC / 4); i += kThreads) {
      const int r = i / (kC / 4);
      const int t = a.t0 - 1 + r;
      if (t < 0 || t >= T) continue;  // zero-filled, and t1 is 0 there
      float4* p = reinterpret_cast<float4*>(slab + slab_index(r, 4 * q));
      float4 v = *p;
      v.x = fmaxf(__fadd_rn(__fmul_rn(v.x, s1.x), sh1.x), 0.f);
      v.y = fmaxf(__fadd_rn(__fmul_rn(v.y, s1.y), sh1.y), 0.f);
      v.z = fmaxf(__fadd_rn(__fmul_rn(v.z, s1.z), sh1.z), 0.f);
      v.w = fmaxf(__fadd_rn(__fmul_rn(v.w, s1.w), sh1.w), 0.f);
      *p = v;
    }
    __syncthreads();

    float acc[kMT][kNT][4];
    tconv_mma(slab, taps, row0, acc);
    __syncthreads();  // every warp is done reading the slab
    if (more) {
      stage_slab(slab, y, next.clip_row0, next.t0, T, Wp, next.col0);
      cp_async_commit();
    }

    float sum[kNT][2], sumsq[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = a.col0 + nt * 8 + 2 * c;
      const float2 cb = __ldg(reinterpret_cast<const float2*>(vecs + 2 * static_cast<size_t>(Wp) + n));
      sum[nt][0] = sum[nt][1] = sumsq[nt][0] = sumsq[nt][1] = 0.f;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = a.t0 + row0 + mt * 16 + g + 8 * half;
          if (t >= T) continue;
          const float v0 = acc[mt][nt][2 * half] + cb.x;
          const float v1 = acc[mt][nt][2 * half + 1] + cb.y;
          *reinterpret_cast<float2*>(y2 + (a.clip_row0 + t) * Wp + n) = make_float2(v0, v1);
          sum[nt][0] += v0;
          sum[nt][1] += v1;
          sumsq[nt][0] += v0 * v0;
          sumsq[nt][1] += v1 * v1;
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
          sumsq[nt][j] += __shfl_xor_sync(0xffffffffu, sumsq[nt][j], off);
        }
    if (g == 0) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          red[(warp * 2 + 0) * kC + nt * 8 + 2 * c + j] = sum[nt][j];
          red[(warp * 2 + 1) * kC + nt * 8 + 2 * c + j] = sumsq[nt][j];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < (kRows / kPartRows) * 2 * kC; i += kThreads) {
      const int h = i / (2 * kC);  // 64-row part of this tile
      const int moment = (i / kC) % 2;
      const int col = i % kC;
      const int part = a.t0 / kPartRows + h;
      if (part >= n_parts) continue;
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsPerPart; ++w) total += red[((h * kWarpsPerPart + w) * 2 + moment) * kC + col];
      tile_parts[((static_cast<size_t>(a.b) * n_parts + part) * 2 + moment) * Wp + a.col0 + col] = total;
    }
    // red is written again only after the next tile's first __syncthreads
    a = next;
  }
}

namespace tb = tconv_bf16;

// bf16 leg: an item is 128 rows x 64 columns (one joint) of one clip; a
// block has 8 warps, each the conv of 32 rows x 32 columns (the f32 leg's
// rows per warp, so the same moment order), and two blocks share an SM,
// each walking the joints of one parity with its one diagonal tap block.
constexpr int kWarpRowsBf16 = 32;                         // 2 m-tiles
constexpr int kRowGroups = kRows / kWarpRowsBf16;         // 4
constexpr int kThreadsBf16 = kRowGroups * 2 * 32;         // a row group's two column halves
constexpr int kNTBf16 = 4;                                // 32 columns a warp
// y2's tile, staged for its 16-byte stores: row-major, a row padded by 16
// bytes (the pad shifts a row's banks by 4, so the fragment writes of 8
// rows x 4 words hit 32 distinct banks)
constexpr int kOutStride = kC + 8;
struct alignas(16) SmemBf16 {
  tb::bf16 taps[tb::kTapElems];        // the parity's KB diagonal block, k-major
  tb::bf16 slab[2][tb::kSlabElems];    // [buffer]: y rows t0 - 1 .. t0 + 128, then t1
  tb::bf16 tile[kRows * kOutStride];   // y2, rounded
  float vec[2][3][kC];                 // [buffer]: s1, sh1, cb of the item's columns
  float red[kRowGroups][2][kC];        // [row group][moment][column]
};
static_assert(kThreadsBf16 == 2 * (kRows / kPartRows) * kC, "one thread per (part, moment, column)");

// Start the copies of one item into buffer buf: its y slab (rows outside
// the clip zero-filled) and its s1, sh1, cb.
__device__ __forceinline__ void stage_item(SmemBf16& sm, int buf, const TileAt& a, const tb::bf16* __restrict__ y,
                                           const float* __restrict__ vecs, int T, int Wp) {
  tb::stage_slab<kThreadsBf16>(sm.slab[buf], y, a.clip_row0, a.t0, T, Wp, a.col0);
  if (threadIdx.x < 3 * kC / 4) {  // 16 chunks of each vector
    const int row = threadIdx.x / (kC / 4);
    const int q = threadIdx.x % (kC / 4);
    tb::cp_async16(&sm.vec[buf][row][4 * q], vecs + static_cast<size_t>(row) * Wp + a.col0 + 4 * q, true);
  }
}

// Item a's y2 from its staged tile, 16 bytes a thread, and its rows of
// tile_parts, one value a thread: the sums of the two warps of each 64-row
// part in order.
__device__ __forceinline__ void store_item(const SmemBf16& sm, const TileAt& a, int T, int Wp,
                                           tb::bf16* __restrict__ y2, float* __restrict__ tile_parts) {
  for (int i = threadIdx.x; i < kRows * (kC / 8); i += kThreadsBf16) {
    const int r = i / (kC / 8);
    const int q = i % (kC / 8);  // 16-byte chunk of the row segment
    if (a.t0 + r >= T) continue;
    *reinterpret_cast<uint4*>(y2 + (a.clip_row0 + a.t0 + r) * static_cast<size_t>(Wp) + a.col0 + 8 * q) =
        *reinterpret_cast<const uint4*>(sm.tile + r * kOutStride + 8 * q);
  }
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

// The taps, the y slabs and s1 / sh1 / cb come in by cp.async, the next
// item's while this one is computed; t1 is built in place; the conv is
// tconv_bf16.cuh's k-major core (the earlier leg's sums in the same order);
// y2 is staged in shared memory and leaves in 16-byte stores; the moments
// of the rounded y2 in the f32 leg's order (each thread its rows, the
// warp's row groups by shuffles, the two warps of a 64-row part in order).
// Even blocks walk the even joints, odd blocks the odd ones (tile_at).
__global__ void __launch_bounds__(kThreadsBf16, 2)
train_fwd_kernel_bf16(const tb::bf16* __restrict__ y, const float* __restrict__ vecs,
                      const tb::bf16* __restrict__ kb, tb::bf16* __restrict__ y2,
                      float* __restrict__ tile_parts, int B, int T, int Wp) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  SmemBf16& sm = *reinterpret_cast<SmemBf16*>(smem_bytes);

  const int items = (Wp / kLane) * B * ((T + kRows - 1) / kRows);  // of each parity
  const int stride = gridDim.x / 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int rg = warp / 2;                         // row group
  const int row0 = rg * kWarpRowsBf16;
  const int n0 = (warp % 2) * (8 * kNTBf16);       // column half

  int item = blockIdx.x / 2;
  if (item >= items) return;
  tb::stage_taps_kmajor<kThreadsBf16>(sm.taps, kb, (blockIdx.x & 1) * kC);
  TileAt a = tile_at(item, B, T);
  stage_item(sm, 0, a, y, vecs, T, Wp);
  cp_async_commit();

  for (int buf = 0; item < items; item += stride, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this item has landed; the last item's y2 is stored and red read
    const int next = item + stride;
    const TileAt na = tile_at(next < items ? next : item, B, T);
    if (next < items) stage_item(sm, buf ^ 1, na, y, vecs, T, Wp);
    cp_async_commit();

    tb::t1_pass<kThreadsBf16>(sm.slab[buf], sm.slab[buf], sm.vec[buf][0], sm.vec[buf][1], a.t0, T);
    __syncthreads();  // t1 is built

    float acc[2][kNTBf16][4];
    tb::tconv_mma_kmajor<2, kNTBf16>(sm.slab[buf], sm.taps, row0, n0, acc);
#pragma unroll
    for (int nt = 0; nt < kNTBf16; ++nt) {
      const int n = n0 + nt * 8 + 2 * c;
      const float2 cb = *reinterpret_cast<const float2*>(&sm.vec[buf][2][n]);
      float sum[2] = {0.f, 0.f}, sumsq[2] = {0.f, 0.f};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row0 + mt * 16 + g + 8 * half;
          const __nv_bfloat162 r2 = tb::pack_rn(__fadd_rn(acc[mt][nt][2 * half], cb.x),
                                                __fadd_rn(acc[mt][nt][2 * half + 1], cb.y));
          *reinterpret_cast<__nv_bfloat162*>(sm.tile + r * kOutStride + n) = r2;
          if (a.t0 + r >= T) continue;
          const float2 v = tb::unpack2(*reinterpret_cast<const uint32_t*>(&r2));  // BN2 sees the rounded y2
          sum[0] += v.x;
          sum[1] += v.y;
          sumsq[0] += v.x * v.x;
          sumsq[1] += v.y * v.y;
        }
      // sum over the warp's 8 row groups (lanes of equal c), then one lane per c writes
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], off);
          sumsq[j] += __shfl_xor_sync(0xffffffffu, sumsq[j], off);
        }
      if (g == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sm.red[rg][0][n + j] = sum[j];
          sm.red[rg][1][n + j] = sumsq[j];
        }
      }
    }
    __syncthreads();  // the item's y2 tile and moment partials are complete
    store_item(sm, a, T, Wp, y2, tile_parts);
    a = na;
  }
  cp_async_wait<0>();
}

// resident blocks of `kernel` on the card (cached by the caller)
template <typename Kernel>
cudaError_t resident_slots(Kernel kernel, size_t smem, int* slots, int threads = kThreads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *slots = per_sm * sms;
  return err;
}

}  // namespace

// y, y2: (B*T, Wp) contiguous f32, 16-byte aligned; vecs: (4, Wp) f32 rows
// [s1, sh1, cb, 0]; kb: (3, 128, 128) f32; tile_parts: (B, ceil(T/64), 2, Wp)
// f32.  Wp % 128 == 0.  Returns the cudaError_t of the launch (0 on success).
extern "C" int p2r_stgcn_train_fwd_f32(const float* y, const float* vecs, const float* kb,
                                       float* y2, float* tile_parts, int B, int T, int Wp,
                                       void* stream) {
  static int slots = 0;  // resident blocks on the card
  if (slots == 0) {
    const cudaError_t err = resident_slots(train_fwd_kernel, kSmemBytes, &slots);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  train_fwd_kernel<<<grid_size(B, T, Wp, slots), kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      y, vecs, kb, y2, tile_parts, B, T, Wp);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 leg.  y, y2: (B*T, Wp) contiguous bf16, 16-byte aligned; vecs:
// (4, Wp) f32 rows [s1, sh1, cb, 0]; kb: (3, 128, 128) bf16; tile_parts:
// (B, ceil(T/64), 2, Wp) f32.  Wp % 128 == 0.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int p2r_stgcn_train_fwd_bf16(const __nv_bfloat16* y, const float* vecs, const __nv_bfloat16* kb,
                                        __nv_bfloat16* y2, float* tile_parts, int B, int T, int Wp,
                                        void* stream) {
  static int slots = 0;  // resident blocks on the card
  if (slots == 0) {
    const cudaError_t err = resident_slots(train_fwd_kernel_bf16, sizeof(SmemBf16), &slots, kThreadsBf16);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (slots < 2) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int grid = grid_size(B, T, Wp, slots);
  if (grid == 0) return 0;
  train_fwd_kernel_bf16<<<grid, kThreadsBf16, sizeof(SmemBf16), static_cast<cudaStream_t>(stream)>>>(
      y, vecs, kb, y2, tile_parts, B, T, Wp);
  return static_cast<int>(cudaGetLastError());
}
