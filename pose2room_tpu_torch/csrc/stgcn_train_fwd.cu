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
//   tile_parts[b, tile] = per-column [sum(y2), sum(y2^2)] over the tile's rows
// KB (3,128,128) is block-diagonal with one C x C tap per joint (C = 64); the
// kernel reads only those diagonal blocks.  The wrapper sums tile_parts over
// the tiles of a clip in a fixed order.
//
// What bounds it on an H100: operations.  At B=8 the taps need
// 2*6144*3456*192 = 8.15 GFLOP of exact f32 FMAs (0.122 ms at 67 TFLOP/s)
// while y and y2 move 170 MB (0.051 ms at 3.35 TB/s).
//
// Design: kernel 1 (stgcn_epilogue.cu) with another prologue and epilogue.
// One block computes a 64-row x 64-column tile (one joint, one row chunk of
// one clip; a tile never crosses a clip).  It builds t1 from y in shared
// memory as a (64+2)-row slab with its t-1/t+1 halo (zero rows at the clip
// edges), next to the three 64x64 diagonal taps (48 KB).  Each of the 128
// threads keeps an 8x4 register tile of accumulators.  y*s1 + sh1 is rounded
// as a product then a sum (no FMA contraction), as the plain version
// computes it.  The column moments are summed per thread over its 8 rows,
// then over the 8 thread rows in shared memory in a fixed order.  Pad
// columns (3392..3455) come out exactly 0 because y and vecs are 0 there.
// Plain CUDA cores in f32: no tensor cores, no TMA (a later optimisation).

#include <cuda_runtime.h>

namespace {

constexpr int kC = 64;         // channels of one joint = width of a diagonal tap block
constexpr int kLane = 128;     // KB is (3, kLane, kLane)
constexpr int kRows = 64;      // output rows per block
constexpr int kThreads = 128;
constexpr int kTM = 8;         // rows per thread
constexpr int kTN = 4;         // columns per thread
constexpr int kThreadRows = kRows / kTM;
constexpr int kSlabStride = kC + 1;  // +1 staggers banks between thread rows

static_assert(kThreadRows * (kC / kTN) == kThreads, "thread tile must cover the block tile");
static_assert(2 * kC == kThreads, "one thread per (moment, column) in the final reduction");

constexpr size_t kTapFloats = 3 * kC * kC;
constexpr size_t kSlabFloats = (kRows + 2) * kSlabStride;
constexpr size_t kRedFloats = 2 * kThreadRows * kC;
constexpr size_t kSmemBytes = (kTapFloats + kSlabFloats + kRedFloats) * sizeof(float);

__global__ void __launch_bounds__(kThreads)
train_fwd_kernel(const float* __restrict__ y, const float* __restrict__ vecs,
                 const float* __restrict__ kb, float* __restrict__ y2,
                 float* __restrict__ tile_parts, int T, int Wp) {
  extern __shared__ __align__(16) float smem[];
  float* taps = smem;                // [3][kC][kC]
  float* slab = taps + kTapFloats;   // [kRows + 2][kSlabStride]
  float* red = slab + kSlabFloats;   // [2][kThreadRows][kC]

  const int col0 = blockIdx.x * kC;
  const int tile = blockIdx.y;
  const int t0 = tile * kRows;
  const size_t clip_row0 = static_cast<size_t>(blockIdx.z) * T;
  const int diag = col0 % kLane;  // offset of this joint's block on KB's diagonal

  for (int i = threadIdx.x; i < static_cast<int>(kTapFloats); i += kThreads) {
    const int s = i / (kC * kC);
    const int r = (i / kC) % kC;
    const int c = i % kC;
    taps[i] = kb[(static_cast<size_t>(s) * kLane + diag + r) * kLane + diag + c];
  }
  for (int i = threadIdx.x; i < (kRows + 2) * kC; i += kThreads) {
    const int r = i / kC;
    const int c = i % kC;
    const int t = t0 - 1 + r;
    float v = 0.f;
    if (t >= 0 && t < T) {
      const float pre = __fadd_rn(__fmul_rn(y[(clip_row0 + t) * Wp + col0 + c], vecs[col0 + c]),
                                  vecs[static_cast<size_t>(Wp) + col0 + c]);
      v = fmaxf(pre, 0.f);
    }
    slab[r * kSlabStride + c] = v;
  }
  __syncthreads();

  const int tx = threadIdx.x % (kC / kTN);
  const int ty = threadIdx.x / (kC / kTN);
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const float* tap = taps + s * kC * kC;
    const float* rows = slab + (ty * kTM + s) * kSlabStride;
#pragma unroll 4
    for (int k = 0; k < kC; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(tap + k * kC + tx * kTN);
      float a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = rows[i * kSlabStride + k];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        acc[i][0] += a[i] * w.x;
        acc[i][1] += a[i] * w.y;
        acc[i][2] += a[i] * w.z;
        acc[i][3] += a[i] * w.w;
      }
    }
  }

  const int c0 = col0 + tx * kTN;
  float cb[kTN], sum[kTN], sumsq[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    cb[j] = vecs[2 * static_cast<size_t>(Wp) + c0 + j];
    sum[j] = 0.f;
    sumsq[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int t = t0 + ty * kTM + i;
    if (t >= T) continue;
    const size_t base = (clip_row0 + t) * Wp + c0;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const float v = acc[i][j] + cb[j];
      y2[base + j] = v;
      sum[j] += v;
      sumsq[j] += v * v;
    }
  }
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    red[ty * kC + tx * kTN + j] = sum[j];
    red[(kThreadRows + ty) * kC + tx * kTN + j] = sumsq[j];
  }
  __syncthreads();

  const int moment = threadIdx.x / kC;
  const int c = threadIdx.x % kC;
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < kThreadRows; ++r) total += red[(moment * kThreadRows + r) * kC + c];
  const size_t n_tiles = gridDim.y;
  tile_parts[((static_cast<size_t>(blockIdx.z) * n_tiles + tile) * 2 + moment) * Wp + col0 + c] = total;
}

}  // namespace

// y, y2: (B*T, Wp) contiguous f32; vecs: (4, Wp) f32 rows [s1, sh1, cb, 0];
// kb: (3, 128, 128) f32; tile_parts: (B, ceil(T/64), 2, Wp) f32.
// Wp % 128 == 0.  Returns the cudaError_t of the launch (0 on success).
extern "C" int p2r_stgcn_train_fwd_f32(const float* y, const float* vecs, const float* kb,
                                       float* y2, float* tile_parts, int B, int T, int Wp,
                                       void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(Wp / kC, (T + kRows - 1) / kRows, B);
  train_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      y, vecs, kb, y2, tile_parts, T, Wp);
  return static_cast<int>(cudaGetLastError());
}
