// Block-sparse folded graph matmul + BN1 affine + ReLU for the eval chain,
// f32, Hopper (sm_90a).
//
// Replaces: pose2room_tpu/ops/stgcn_sparse.py:_kernel (Pallas, TPU), reached
// through sparse_graph_matmul_bn_relu once per ST-GCN block with
// model.sparse_eval on.
//
// Computes, on joint-permuted merged activations x (N = B*T, Wp) with
// Wp = 27*128 = 3456 and the folded graph matrix M given as its nonzero
// 128x128 tiles (packed (nnz, 128, 128), CSR by output column tile):
//   acc[n, w*128 + c] = sum over j in [col_off[w], col_off[w+1]) of
//                       (x[n, vlist[j]*128 : +128] @ tiles[j])[c]
//   out = relu(acc * s1 + b1)                s1 = vecs[0], b1 = vecs[1]
// An output tile with no entries gets relu(0 * s1 + b1).  acc * s1 + b1 is
// rounded as a product and then a sum (no FMA contraction), as the plain
// PyTorch version computes it.
//
// What bounds it on an H100: operations.  Per clip the 279 tiles of the
// default skeleton need 2*768*279*128*128 = 7.02 GFLOP of exact f32 FMAs
// (0.105 ms at 67 TFLOP/s) while x and out move 21.2 MB and the tiles 18.3 MB
// once per launch (0.012 ms at 3.35 TB/s at B=1).
//
// Design: the TPU kernel keeps a (R, 3456) row chunk of x resident in VMEM;
// on the H100 one row is 13.8 KB, so the chunk cannot stay in shared memory.
// Instead one block computes a 64-row x 128-column output tile (one output
// column tile w, one row chunk) and walks its CSR list: for each nonzero
// tile j it streams the x slab x[rows, vlist[j]*128 : +128] and the tile in
// k-steps of 32 through shared memory (25 KB), re-reading each x slab from
// L2 (the 18.3 MB of tiles and the row chunks fit the 50 MB L2).  The next
// k-step's global loads go to registers while the current one is multiplied.
// Each of the 128 threads keeps an 8x8 register tile of accumulators (rows
// ty*8..+8, columns tx*4..+4 and 64+tx*4..+4, so a quarter warp's 16-byte
// shared loads hit distinct banks).  Plain CUDA cores in f32: no tensor
// cores, no TMA (a later optimisation).

#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;    // tile edge
constexpr int kBM = 64;       // output rows per block
constexpr int kBK = 32;       // depth of one k-step
constexpr int kThreads = 128;
constexpr int kTM = 8;        // rows per thread
constexpr int kAStride = kBK + 4;  // As rows stay 16-byte aligned
constexpr int kStepsPerTile = kLane / kBK;
constexpr int kALoads = kBM * kBK / 4 / kThreads;    // float4 loads of x per thread and step
constexpr int kBLoads = kBK * kLane / 4 / kThreads;  // float4 loads of the tile

static_assert((kBM / kTM) * (kLane / 8) == kThreads, "thread tile must cover the block tile");
static_assert(kALoads * kThreads * 4 == kBM * kBK, "x slab loads");
static_assert(kBLoads * kThreads * 4 == kBK * kLane, "tile loads");

__device__ __forceinline__ float4 fma4(float a, float4 b, float4 acc) {
  acc.x += a * b.x;
  acc.y += a * b.y;
  acc.z += a * b.z;
  acc.w += a * b.w;
  return acc;
}

__device__ __forceinline__ float bn_relu(float acc, float s, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(acc, s), b), 0.f);
}

__global__ void __launch_bounds__(kThreads)
sparse_kernel(const float* __restrict__ x, const float* __restrict__ tiles,
              const float* __restrict__ vecs, const int* __restrict__ col_off,
              const int* __restrict__ vlist, float* __restrict__ out, int N, int Wp) {
  __shared__ __align__(16) float As[kBM * kAStride];  // [row][k] of the x slab
  __shared__ __align__(16) float Bs[kBK * kLane];     // [k][column] of the tile

  const int w = blockIdx.x;
  const int row0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lo = col_off[w];
  const int n_steps = (col_off[w + 1] - lo) * kStepsPerTile;

  float4 acc[kTM][2];
#pragma unroll
  for (int i = 0; i < kTM; ++i) acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 ra[kALoads], rb[kBLoads];
  auto load_step = [&](int step) {
    const int j = lo + step / kStepsPerTile;
    const int k0 = (step % kStepsPerTile) * kBK;
    const size_t xcol = static_cast<size_t>(__ldg(vlist + j)) * kLane + k0;
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int f = tid + i * kThreads;
      const int m = f / (kBK / 4);
      const int k4 = f % (kBK / 4);
      const int row = row0 + m;
      ra[i] = row < N ? __ldg(reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * Wp + xcol) + k4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float* tile = tiles + (static_cast<size_t>(j) * kLane + k0) * kLane;
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      rb[i] = __ldg(reinterpret_cast<const float4*>(tile) + tid + i * kThreads);
    }
  };

  if (n_steps > 0) load_step(0);
  for (int step = 0; step < n_steps; ++step) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int f = tid + i * kThreads;
      *reinterpret_cast<float4*>(As + (f / (kBK / 4)) * kAStride + 4 * (f % (kBK / 4))) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      reinterpret_cast<float4*>(Bs)[tid + i * kThreads] = rb[i];
    }
    __syncthreads();
    if (step + 1 < n_steps) load_step(step + 1);  // in flight during the products below

#pragma unroll
    for (int k = 0; k < kBK; k += 4) {
      float4 a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        a[i] = *reinterpret_cast<const float4*>(As + (ty * kTM + i) * kAStride + k);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + (k + kk) * kLane + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + (k + kk) * kLane + 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
          acc[i][0] = fma4(av, b0, acc[i][0]);
          acc[i][1] = fma4(av, b1, acc[i][1]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = w * kLane + h * 64 + tx * 4;
    const float4 s = *reinterpret_cast<const float4*>(vecs + c);
    const float4 b = *reinterpret_cast<const float4*>(vecs + Wp + c);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = row0 + ty * kTM + i;
      if (row >= N) continue;
      const float4 v = acc[i][h];
      *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * Wp + c) =
          make_float4(bn_relu(v.x, s.x, b.x), bn_relu(v.y, s.y, b.y),
                      bn_relu(v.z, s.z, b.z), bn_relu(v.w, s.w, b.w));
    }
  }
}

}  // namespace

// x, out: (N, Wp) contiguous f32; tiles: (nnz, 128, 128) f32; vecs: (8, Wp)
// f32; col_off: (Wp/128 + 1,) int32; vlist: (nnz,) int32 with entries in
// [0, Wp/128).  Wp % 128 == 0.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int p2r_stgcn_sparse_f32(const float* x, const float* tiles, const float* vecs,
                                    const int* col_off, const int* vlist, float* out,
                                    int N, int Wp, void* stream) {
  if (N == 0) return 0;
  const dim3 grid(Wp / kLane, (N + kBM - 1) / kBM);
  sparse_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, tiles, vecs, col_off, vlist, out, N, Wp);
  return static_cast<int>(cudaGetLastError());
}
