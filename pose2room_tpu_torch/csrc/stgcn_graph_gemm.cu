// Dense folded graph matmul + BN1 affine + ReLU of the f32 eval chain,
// Hopper (sm_90a): the graph GEMM.
//
// Replaces no TPU kernel.  The JAX package leaves this product to XLA's dot
// (pose2room_tpu/ops/stgcn_fused.py:_graph_matmul_bn_relu), and the port
// left it to torch.matmul in f32 (cuBLAS, on the CUDA cores) followed by
// three elementwise passes (* s1, + b1, ReLU) over the (B*T, 3456) product.
// At B = 32 those took ~81% of a dense generate's device time, the
// elementwise passes ~5 ms more; this kernel does both at once on the
// tensor cores.
//
// Computes, for one ST-GCN block of the dense eval chain (models/stgcn.py),
//   out[n, j] = relu((sum_k x[n, k] * M[k, j]) * s1[j] + b1[j])
// x: (N = B*T, K) f32 activations, K = 3392 (block 0, no entry pad) or 3456;
// M: the folded graph matrix (K rows of the lane-padded (3456, 3456));
// s1, b1 = vecs[0], vecs[1].  The product is rounded, then the sum (no FMA
// contraction), as the plain PyTorch version computes it.
//
// Arithmetic: 3xTF32, the split of tconv_mma.cuh (big = rna_tf32(a),
// small = rna_tf32(a - big)), three products a k8 step, small terms first,
// as in kernels 1, 3, 4 and 5.  B is M transposed (K-major, as TF32 wgmma
// takes both operands) and split once, at fold time
// (ops/stgcn_fused.py:gemm_b_operand): (2, Ncols, Kb) f32, its big half then
// its small half, the same bits as a split here.  A is split in the
// consumers' registers.  The tensor cores' f32 adds truncate (tconv_mma.cuh),
// so every kFold k8 steps go into a fresh accumulator (scale-d 0) that IEEE
// adds fold into the running f32 sum after wait_group 0.
//
// What bounds it on an H100: operations.  One block at B = 32 is
// 2 * 24576 * 3456 * 3456 = 587 GFLOP (576 for block 0), 3.51 TFLOP for the
// six: 21.3 ms a batch as three TF32 products each at 495 TFLOP/s (165
// effective), 52 ms as f32 FMAs on the CUDA cores (67 TFLOP/s).  Bytes: x
// and out 340 MB each, B 95.6 MB, once a launch: 0.23 ms at 3.35 TB/s.
//
// Design, to approach that bound:
// * a persistent grid, one block an SM, walks 128 x 192 output tiles
//   (u, u + grid, ...) in bands of kBand column tiles: a wave of 132 tiles
//   covers ~15 row tiles x 9 column tiles, whose A rows and B columns the
//   wave reads from L2 more than once (B's two halves, 95.6 MB, do not fit
//   the 50 MB L2; a wave's nine column tiles, 48 MB, nearly do);
// * a producer warpgroup, one thread of which keeps a ring of 3 stages full
//   with TMA: per 32-deep k stage a 128 x 32 box of x (rows past N read as
//   zeros) and 192 x 32 boxes of B's big and small halves, all in the
//   128-byte swizzle, completed on the stage's mbarrier; it runs ahead
//   across tiles, so a tile's epilogue overlaps the next one's loads.  It
//   gives its registers to the consumers (setmaxnreg 40 / 232: the two
//   96-float accumulators and the split fragment need ~220 a thread);
// * two consumer warpgroups, 64 rows of the tile each: per stage each thread
//   reads its A fragment of the four k8 steps from shared memory, splits
//   it, and issues three wgmma.m64n192k8 a step (A from registers, B from
//   the stage's descriptors); each warp releases the stage after the fold,
//   so the two warpgroups drift apart and one's fold runs while the other's
//   products do;
// * the epilogue applies s1, b1 and the ReLU to the f32 sum and stores t1
//   from the accumulator fragment (32 contiguous bytes a row a warp).
// Measured on an H100 (scripts/torch_graph_gemm_variants.py), a block at
// B = 32 / B = 1: 4.00-4.05 / 0.148-0.156 ms; 128 x 128 tiles 4.00 / 0.20
// (4.31-4.51 / 0.22-0.23 with a producer warp and no setmaxnreg: 168
// registers and a spill); bands of 6 or 18 column tiles 4.08 or 4.23; a
// fold every 2 or every k8 step 4.58 or 5.97 (the wait before each fold
// drains the warpgroup's products).
// Accuracy: kFold 4 (one fresh accumulator a stage, 12 truncating adds in
// it, the most a stage's A fragment in registers allows): this order,
// emulated at full width, is within 1.0e-7 of sum |a*b| of float64
// (tests/test_torch_graph_gemm.py holds it to the 3xTF32 kernels' 2e-6;
// one accumulator over the whole K reads 5.5e-6).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_tf32.cuh"

namespace {

namespace wg = wgmma_tf32;
namespace tma = wgmma_bf16;

constexpr int kBM = 128;                     // output rows of a tile: two warpgroups of 64
constexpr int kBN = 192;                     // output columns of a tile: 3456 = 18 x 192
constexpr int kBK = 32;                      // k of a stage: one 128-byte swizzled f32 row
constexpr int kStages = kBN == 128 ? 4 : 3;  // stages of the ring: 192 KB
constexpr int kFold = 4;                     // k8 steps summed in one fresh accumulator
constexpr int kBand = 9;                     // column tiles of a raster band
constexpr int kConsumers = 256;              // two warpgroups
// The producer is a whole warpgroup, so that it can hand registers to the
// consumers (setmaxnreg: 128 x 40 + 256 x 232 of the SM's 65,536).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kThreads = kConsumers + 128;
constexpr int kABytes = kBM * kBK * 4;       // 16 KB
constexpr int kBBytes = kBN * kBK * 4;       // one half of B, 24 KB
constexpr int kStageBytes = kABytes + 2 * kBBytes;
constexpr size_t kSmemBytes = kStages * kStageBytes + 1024;  // + slack to align the ring to 1 KB
constexpr int kAcc = kBN / 2;                // accumulator floats a thread

static_assert(kFold == 1 || kFold == 2 || kFold == 4, "a stage holds 4 k8 steps");
static_assert(kBN == 128 || kBN == 192, "wgmma_tf32.cuh writes out m64n128k8 and m64n192k8");

__device__ __forceinline__ float bn_relu(float a, float s, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(a, s), b), 0.f);
}

__device__ __forceinline__ void fold(float (&acc)[kAcc], float (&part)[kAcc]) {
  wg::fence_operand(part);  // read the product only after the wait
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// Row tile and column tile of tile u: bands of kBand column tiles (the last
// band narrower), row-major inside a band.
__device__ __forceinline__ void tile_at(int u, int n_rt, int n_ct, int& rt, int& ct) {
  const int band = u / (n_rt * kBand);
  const int first = band * kBand;
  const int width = n_ct - first < kBand ? n_ct - first : kBand;
  const int rem = u - band * n_rt * kBand;
  rt = rem / width;
  ct = first + rem % width;
}

__global__ void __launch_bounds__(kThreads, 1)
graph_gemm_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap b_map,
                  const float* __restrict__ s1, const float* __restrict__ b1, float* __restrict__ out, int N,
                  int K, int Ncols) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];  // kStages x [x box | B big | B small]
  __shared__ uint64_t full[kStages], empty[kStages];
  const int n_rt = (N + kBM - 1) / kBM;
  const int n_ct = Ncols / kBN;
  const int n_tiles = n_rt * n_ct;
  const int n_k = K / kBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tma::bar_init(&full[s], 1);                 // the producer's arrive, with the stage's bytes
      tma::bar_init(&empty[s], kConsumers / 32);  // every consumer warp, done with the stage
    }
    tma::bar_init_fence();
  }
  __syncthreads();

  // the ring starts on a 1024-byte boundary (the swizzle atoms of TMA and wgmma)
  const uint32_t raw = tma::smem_addr(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);

  if (tid >= kConsumers) {  // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid != kConsumers) return;
    int g = 0;  // stages issued
    for (int u = blockIdx.x; u < n_tiles; u += gridDim.x) {
      int rt, ct;
      tile_at(u, n_rt, n_ct, rt, ct);
      for (int kk = 0; kk < n_k; ++kk, ++g) {
        const int slot = g % kStages;
        if (g >= kStages) tma::bar_wait(&empty[slot], ((g / kStages) & 1) ^ 1);
        unsigned char* st = ring + slot * kStageBytes;
        tma::bar_arrive_tx(&full[slot], kStageBytes);
        tma::tma_load_2d(st, &x_map, &full[slot], kk * kBK, rt * kBM);  // rows past N: zeros
        tma::tma_load_2d(st + kABytes, &b_map, &full[slot], kk * kBK, ct * kBN);
        tma::tma_load_2d(st + kABytes + kBBytes, &b_map, &full[slot], kk * kBK, Ncols + ct * kBN);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int r0 = 64 * (warp >> 2) + 16 * (warp & 3) + g;  // this thread's rows of the tile: r0, r0 + 8
  const uint32_t ring_addr = tma::smem_addr(ring);
  float acc[kAcc];
  float part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) part[i] = 0.f;

  int gs = 0;  // stages consumed
  for (int u = blockIdx.x; u < n_tiles; u += gridDim.x) {
    int rt, ct;
    tile_at(u, n_rt, n_ct, rt, ct);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int kk = 0; kk < n_k; ++kk, ++gs) {
      const int slot = gs % kStages;
      tma::bar_wait(&full[slot], (gs / kStages) & 1);
      const float* xs = reinterpret_cast<const float*>(ring + slot * kStageBytes);
      const uint32_t bb = ring_addr + slot * kStageBytes + kABytes;  // B's big half
      const uint32_t bs = bb + kBBytes;                               // B's small half
      // this thread's A fragment of the stage's four k8 steps, split
      uint32_t ab[4][4], as[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wg::split(xs[wg::sw128_index(r0 + 8 * (i & 1), 8 * s + c + 4 * (i >> 1))], ab[s][i], as[s][i]);
#pragma unroll
      for (int s0 = 0; s0 < 4; s0 += kFold) {
        wg::fence();  // part was read by the last fold; the fragment was just written
#pragma unroll
        for (int f = 0; f < kFold; ++f) {
          const int s = s0 + f;
          wg::mma<kBN>(part, as[s], wg::desc_b(bb + 32 * s), f);  // f == 0: a fresh accumulator
          wg::mma<kBN>(part, ab[s], wg::desc_b(bs + 32 * s), 1);
          wg::mma<kBN>(part, ab[s], wg::desc_b(bb + 32 * s), 1);
        }
        wg::commit();
        wg::wait<0>();
        fold(acc, part);
      }
      if (lane == 0) tma::bar_arrive(&empty[slot]);
    }

    const int row0 = rt * kBM + r0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = ct * kBN + 8 * j + 2 * c;
      const float2 s = __ldg(reinterpret_cast<const float2*>(s1 + col));
      const float2 b = __ldg(reinterpret_cast<const float2*>(b1 + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= N) continue;
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * Ncols + col) =
            make_float2(bn_relu(acc[4 * j + 2 * h], s.x, b.x), bn_relu(acc[4 * j + 2 * h + 1], s.y, b.y));
      }
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A TMA map of a row-major f32 matrix (rows x cols, 16-byte aligned, rows
// cols * 4 bytes apart): boxes of box_rows x 32 elements, written to shared
// memory in the 128-byte swizzle; a box past the last row reads zeros.
int f32_map(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows, uint32_t box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 4};
  const cuuint32_t box[2] = {kBK, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks on the card (one an SM), set up once.
int grid_slots(int* slots) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(graph_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmemBytes));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, graph_gemm_kernel, kThreads, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cached = per_sm * sms;
  }
  *slots = cached;
  return 0;
}

}  // namespace

// x: (N, K) contiguous f32; b_split: (2, Ncols, Kb) contiguous f32, B's big
// then small half, row j holding column j of M along k (only k < K read);
// s1, b1: (Ncols,) f32; out: (N, Ncols) f32.  Every pointer 16-byte
// aligned; K % 32 == 0, K <= Kb, Kb % 4 == 0, Ncols % 192 == 0.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int p2r_graph_gemm_f32(const float* x, const float* b_split, const float* s1, const float* b1,
                                  float* out, int N, int K, int Kb, int Ncols, void* stream) {
  if (K <= 0 || K % kBK || K > Kb || Kb % 4 || Ncols <= 0 || Ncols % kBN || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  int slots = 0;
  int err = grid_slots(&slots);
  if (err != 0) return err;
  // TMA boxes: 128 rows x 32 columns of x (rows past N read as zeros) and
  // kBN rows x 32 columns of B seen as (2 * Ncols, Kb)
  CUtensorMap x_map, b_map;
  err = f32_map(&x_map, x, static_cast<uint64_t>(K), static_cast<uint64_t>(N), kBM);
  if (err == 0) err = f32_map(&b_map, b_split, static_cast<uint64_t>(Kb), 2ull * Ncols, kBN);
  if (err != 0) return err;
  const int n_tiles = ((N + kBM - 1) / kBM) * (Ncols / kBN);
  const int grid = n_tiles < slots ? n_tiles : slots;
  graph_gemm_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(x_map, b_map, s1, b1, out,
                                                                                       N, K, Ncols);
  return static_cast<int>(cudaGetLastError());
}
