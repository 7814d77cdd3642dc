// Fused ST-GCN train forward: BN1 affine + ReLU + temporal conv + column
// moments, f32, Hopper (sm_90a).
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

#include <cuda_runtime.h>

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

}  // namespace

// y, y2: (B*T, Wp) contiguous f32, 16-byte aligned; vecs: (4, Wp) f32 rows
// [s1, sh1, cb, 0]; kb: (3, 128, 128) f32; tile_parts: (B, ceil(T/64), 2, Wp)
// f32.  Wp % 128 == 0.  Returns the cudaError_t of the launch (0 on success).
extern "C" int p2r_stgcn_train_fwd_f32(const float* y, const float* vecs, const float* kb,
                                       float* y2, float* tile_parts, int B, int T, int Wp,
                                       void* stream) {
  static bool configured = false;
  static int slots = 0;  // resident blocks on the card
  if (!configured) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmemBytes));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, train_fwd_kernel, kThreads, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    slots = per_sm * sms;
    configured = true;
  }
  train_fwd_kernel<<<grid_size(B, T, Wp, slots), kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      y, vecs, kb, y2, tile_parts, B, T, Wp);
  return static_cast<int>(cudaGetLastError());
}
