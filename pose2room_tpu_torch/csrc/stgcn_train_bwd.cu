// Fused ST-GCN train backward: temporal-conv transpose + ReLU mask + BN1
// column moments + tap gradient, f32, Hopper (sm_90a).
//
// Replaces: pose2room_tpu/ops/stgcn_train.py:_bwd_kernel (Pallas, TPU),
// reached through _tconv_bwd once per ST-GCN block in the train step's
// backward.
//
// Computes, on merged activations (B*T, Wp) with Wp = 27*128 = 3456:
//   t1    = relu(y * s1 + sh1)                (recomputed; never stored)
//   dt1   = dy2[t+1] @ KBT[0] + dy2[t] @ KBT[1] + dy2[t-1] @ KBT[2]
//   dpre  = (t1 > 0) ? dt1 : 0
//   chunk_parts[b, chunk] = per-column [sum(dpre), sum(dpre * y)]
//   tap_parts[b, chunk, joint, s] = shift_s(t1)^T @ dy2 over the chunk's rows,
//                                   for the joint's 64x64 diagonal block
// KBT (3,128,128) holds the transposed block-diagonal taps; the kernel reads
// only their diagonal 64x64 blocks.  The wrapper reduces chunk_parts over the
// chunks and tap_parts over (clip, chunk, joint) with fixed-order sums, so
// the tap gradient is the diagonal-block fold of the TPU kernel's dense dKB
// and repeated runs agree bit for bit (no float atomics).
//
// What bounds it on an H100: operations.  At B=8, dt1 and the tap gradient
// each need 2*6144*3456*192 = 8.15 GFLOP of f32 FMAs, 16.3 GFLOP in all
// (0.243 ms at 67 TFLOP/s), while dy2, y and dpre move 255 MB (0.076 ms).
//
// Design: one block owns one joint's 64 columns over a chunk of up to four
// 64-row tiles of one clip.  Per tile it stages a (64+2)-row slab of dy2
// and one of t1 (both with the t-1/t+1 halo, zero outside the clip) beside
// the three 64x64 transposed taps, stored in reverse tap order so that the
// transpose runs the same loop as the forward.  Each of the 128 threads
// keeps an 8x4 tile of dt1 accumulators and, across the chunk's tiles, an
// 8x4 tile of each of the three tap gradients in registers.  y*s1 + sh1 is
// rounded as a product then a sum, as the plain version computes it, so the
// ReLU mask matches it exactly.  Pad columns (3392..3455) give exactly 0
// because y, vecs and dy2 are 0 there.  Plain CUDA cores, no tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int kC = 64;
constexpr int kLane = 128;
constexpr int kRows = 64;
constexpr int kTilesPerBlock = 4;   // ROW_TILE * BWD_TILES_PER_BLOCK rows in ops/stgcn_train.py
constexpr int kThreads = 128;
constexpr int kTM = 8;
constexpr int kTN = 4;
constexpr int kThreadRows = kRows / kTM;
constexpr int kSlabStride = kC + 1;

static_assert(kThreadRows * (kC / kTN) == kThreads, "thread tile must cover the block tile");
static_assert(2 * kC == kThreads, "one thread per (moment, column) in the final reduction");

constexpr size_t kTapFloats = 3 * kC * kC;
constexpr size_t kSlabFloats = (kRows + 2) * kSlabStride;
constexpr size_t kRedFloats = 2 * kThreadRows * kC;
constexpr size_t kSmemBytes = (kTapFloats + 2 * kSlabFloats + kRedFloats) * sizeof(float);

__global__ void __launch_bounds__(kThreads)
train_bwd_kernel(const float* __restrict__ dy2, const float* __restrict__ y,
                 const float* __restrict__ vecs, const float* __restrict__ kbt,
                 float* __restrict__ dpre, float* __restrict__ chunk_parts,
                 float* __restrict__ tap_parts, int T, int Wp) {
  extern __shared__ __align__(16) float smem[];
  float* taps = smem;                 // [3][kC][kC], taps[s] = KBT[2 - s] diagonal block
  float* dslab = taps + kTapFloats;   // [kRows + 2][kSlabStride] of dy2
  float* tslab = dslab + kSlabFloats; // [kRows + 2][kSlabStride] of t1
  float* red = tslab + kSlabFloats;   // [2][kThreadRows][kC]

  const int joint = blockIdx.x;
  const int col0 = joint * kC;
  const int chunk = blockIdx.y;
  const size_t clip_row0 = static_cast<size_t>(blockIdx.z) * T;
  const int diag = col0 % kLane;

  for (int i = threadIdx.x; i < static_cast<int>(kTapFloats); i += kThreads) {
    const int s = i / (kC * kC);
    const int r = (i / kC) % kC;
    const int c = i % kC;
    taps[i] = kbt[(static_cast<size_t>(2 - s) * kLane + diag + r) * kLane + diag + c];
  }

  const int tx = threadIdx.x % (kC / kTN);
  const int ty = threadIdx.x / (kC / kTN);
  const int c0 = col0 + tx * kTN;
  float gacc[3][kTM][kTN];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) gacc[s][i][j] = 0.f;
  float psum[kTN], pdot[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    psum[j] = 0.f;
    pdot[j] = 0.f;
  }

  const int n_tiles = (T + kRows - 1) / kRows;
  const int tile_end = min(n_tiles, (chunk + 1) * kTilesPerBlock);
  for (int tile = chunk * kTilesPerBlock; tile < tile_end; ++tile) {
    const int t0 = tile * kRows;
    __syncthreads();  // the previous tile's slabs are no longer read
    for (int i = threadIdx.x; i < (kRows + 2) * kC; i += kThreads) {
      const int r = i / kC;
      const int c = i % kC;
      const int t = t0 - 1 + r;
      float d = 0.f, tv = 0.f;
      if (t >= 0 && t < T) {
        const size_t idx = (clip_row0 + t) * Wp + col0 + c;
        d = dy2[idx];
        const float pre = __fadd_rn(__fmul_rn(y[idx], vecs[col0 + c]),
                                    vecs[static_cast<size_t>(Wp) + col0 + c]);
        tv = fmaxf(pre, 0.f);
      }
      dslab[r * kSlabStride + c] = d;
      tslab[r * kSlabStride + c] = tv;
    }
    __syncthreads();

    // dt1 = tconv^T(dy2): slab row i+s with reversed tap s
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float* tap = taps + s * kC * kC;
      const float* rows = dslab + (ty * kTM + s) * kSlabStride;
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

    // ReLU mask from the recomputed t1, dpre and its column moments
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int t = t0 + ty * kTM + i;
      if (t >= T) continue;
      const size_t base = (clip_row0 + t) * Wp + c0;
      const float* trow = tslab + (ty * kTM + i + 1) * kSlabStride + tx * kTN;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float d = trow[j] > 0.f ? acc[i][j] : 0.f;
        dpre[base + j] = d;
        psum[j] += d;
        pdot[j] += d * y[base + j];
      }
    }

    // tap gradient, diagonal block: gacc[s][i][o] += sum_r t1[r+s-1][i] * dy2[r][o]
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      float d[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) d[j] = dslab[(r + 1) * kSlabStride + tx * kTN + j];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const float* trow = tslab + (r + s) * kSlabStride + ty * kTM;
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float a = trow[i];
#pragma unroll
          for (int j = 0; j < kTN; ++j) gacc[s][i][j] += a * d[j];
        }
      }
    }
  }

  const size_t n_chunks = gridDim.y;
  const size_t slot = static_cast<size_t>(blockIdx.z) * n_chunks + chunk;
  float* tap_out = tap_parts + (slot * gridDim.x + joint) * 3 * kC * kC;
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float4 v = make_float4(gacc[s][i][0], gacc[s][i][1], gacc[s][i][2], gacc[s][i][3]);
      *reinterpret_cast<float4*>(tap_out + (s * kC + ty * kTM + i) * kC + tx * kTN) = v;
    }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    red[ty * kC + tx * kTN + j] = psum[j];
    red[(kThreadRows + ty) * kC + tx * kTN + j] = pdot[j];
  }
  __syncthreads();
  const int moment = threadIdx.x / kC;
  const int c = threadIdx.x % kC;
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < kThreadRows; ++r) total += red[(moment * kThreadRows + r) * kC + c];
  chunk_parts[(slot * 2 + moment) * Wp + col0 + c] = total;
}

}  // namespace

// dy2, y, dpre: (B*T, Wp) contiguous f32; vecs: (4, Wp) f32 rows
// [s1, sh1, 0, 0]; kbt: (3, 128, 128) f32 transposed taps;
// chunk_parts: (B, n_chunks, 2, Wp) f32; tap_parts: (B, n_chunks, Wp/64,
// 3, 64, 64) f32, n_chunks = ceil(T / 256).  Wp % 128 == 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int p2r_stgcn_train_bwd_f32(const float* dy2, const float* y, const float* vecs,
                                       const float* kbt, float* dpre, float* chunk_parts,
                                       float* tap_parts, int B, int T, int Wp, void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        train_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int rows_per_block = kRows * kTilesPerBlock;
  const dim3 grid(Wp / kC, (T + rows_per_block - 1) / rows_per_block, B);
  train_bwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      dy2, y, vecs, kbt, dpre, chunk_parts, tap_parts, T, Wp);
  return static_cast<int>(cudaGetLastError());
}
