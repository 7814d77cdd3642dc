// Block-sparse folded graph matmul + BN1 affine + ReLU for the eval chain,
// f32 and bf16 legs, Hopper (sm_90a).
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
// default skeleton need 2*768*279*128*128 = 7.02 GFLOP: 0.105 ms as f32 FMAs
// on the CUDA cores (67 TFLOP/s), 0.0425 ms as three TF32 products each on
// the tensor cores (3xTF32, 495 TFLOP/s), while x and out move 21.2 MB and
// the tiles 18.3 MB once per launch (0.012 ms at 3.35 TB/s at B=1).
//
// Design: the TPU kernel keeps a (R, 3456) row chunk of x resident in VMEM;
// on the H100 one row is 13.8 KB, so the chunk cannot stay in shared memory.
// A unit of work is one 128-row x 128-column output tile (one output column
// tile w, one row block) over a chunk of w's CSR list.  Its K sequence, the
// (tile j, 32-deep k-stage) pairs of the chunk, is known up front, so a
// 4-stage cp.async ring streams the x slab x[rows, vlist[j]*128 + k : +32]
// and the tile's rows k .. k+32 through 128 KB of shared memory, from L2 (the
// 18.3 MB of tiles and the rows in flight fit the 50 MB L2).  8 warps, each a
// 32 x 64 output tile, form the products with mma.sync m16n8k8 in 3xTF32 with
// tconv_mma.cuh's arithmetic: each operand split into big and small TF32
// parts, three products small terms first, each k-step's products in a
// fresh fragment folded into the f32 accumulator by an IEEE add (the tensor
// cores' own adds truncate).  XOR swizzles keep every fragment load on 32
// banks.  Splitting each landed stage once into big and small planes in
// shared memory, instead of per fragment load, was slower (a barrier-
// separated pass; the splitstage variant of
// scripts/torch_bwd_sparse_variants.py).
//
// Balance: the lists are uneven (5-20 tiles, annealed order), and at B=1
// there are only 6 row blocks, so the longest list would set the launch's
// length.  The lists are cut into chunks of at most `cap` tiles, cap chosen
// so that the chunks fill the card about three times (at B=8 no list is
// cut), and the units are launched longest first: the block scheduler then
// hands each free SM the longest unit left.  A cut list's chunks each write
// their partial to scratch; the last of them to finish (an integer counter,
// no float atomics) sums the partials in chunk order, so the bits do not
// depend on which finished last, and applies BN1 and the ReLU.  The pad slot
// (slot 36 of SPARSE_JOINT_ORDER) stays exactly 0: its x columns, tile rows
// and columns and vecs are 0.
//
// The bf16 leg (p2r_stgcn_sparse_bf16; model.compute_dtype: bfloat16) takes
// x, the tiles and out in bf16 and vecs in f32: the same units, schedule,
// split-K and chunk-ordered sum, one mma.sync.m16n8k16 bf16 product per
// k-step (no split; each in a fresh fragment, tconv_bf16.cuh), 64-deep
// stages (the same 32 KB a stage), the tile rows read as B fragments by
// ldmatrix.trans.  The split-K partials stay f32; the unit that finishes
// its list applies BN1 and the ReLU in f32 and rounds to bf16 once.  Bound:
// operations at B=1 (7.02 GFLOP: 7.1 us at 989 TFLOP/s; 19.8 MB moved: 5.9
// us at 3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tconv_bf16.cuh"
#include "tconv_mma.cuh"

namespace {

using tconv::cp_async_commit;
using tconv::cp_async_wait;
using tconv::mma_tf32;
using tconv::split;

using bf16 = __nv_bfloat16;

constexpr int kLane = 128;     // tile edge
constexpr int kBM = 128;       // output rows of a unit
constexpr int kStages = 4;
constexpr int kThreads = 256;  // 8 warps: 4 along the rows x 2 along the columns
constexpr int kMT = 2;         // 16-row m-tiles of a warp
constexpr int kNT = 8;         // 8-column n-tiles of a warp
constexpr int kStageBytes = 2 * kBM * 128;  // x slab [row][k] + tile rows [k][column], 128-byte rows
constexpr int kUnitFloats = kBM * kLane;    // one unit's partial
constexpr int kMaxCols = 64;                // output column tiles the schedule holds
constexpr int kMinChunk = 4;                // shortest chunk a list is cut into
constexpr int kMaxChunks = kMaxCols + kMaxCols * kMaxCols / kMinChunk;
constexpr int kSplitWaves = 3;              // the chunks fill the card about this many times
constexpr size_t kSmemBytes = kStages * kStageBytes;

static_assert(4 * 16 * kMT == kBM && 2 * 8 * kNT == kLane, "the warps cover the unit");

// One stage's shared-memory layout for an element type: a stage is kBK
// deep, so that an x slab row holds 128 bytes (8 chunks of 16 bytes) and the
// tile rows kBK x 128 elements the same 16 KB.  XOR swizzles keep every
// fragment load on 32 banks and every 16-byte copy aligned.
template <typename E>
struct Stage;

template <>
struct Stage<float> {
  static constexpr int kBK = 32;
  __device__ static int a_index(int r, int k) { return r * kBK + (k ^ ((r & 7) << 2)); }
  __device__ static int b_index(int k, int n) { return k * kLane + (n ^ ((k & 3) << 3)); }
};

template <>
struct Stage<bf16> {
  static constexpr int kBK = 64;
  __device__ static int a_index(int r, int k) { return tconv_bf16::swz64(r, k); }
  __device__ static int b_index(int k, int n) { return k * kLane + ((((n >> 3) ^ (k & 7))) << 3) + (n & 7); }
};

__device__ __forceinline__ float bn_relu(float acc, float s, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(acc, s), b), 0.f);
}

// The chunk schedule, the same in every block: column w's list of L tiles
// is cut into max(1, ceil(L / cap)) near-equal chunks, numbered in (column,
// chunk) order from cbase[w]; order[] lists the chunks longest first.
struct Schedule {
  int off[kMaxCols + 1];
  int cbase[kMaxCols + 1];
  int len[kMaxChunks];
  int order[kMaxChunks];
  int last;  // this block sums its column's partials
};

struct Chunk {
  int w, q, nq, j0, j1;
};

__device__ __forceinline__ Chunk chunk_at(const Schedule& sc, int c) {
  Chunk k;
  k.w = 0;
  while (sc.cbase[k.w + 1] <= c) ++k.w;
  k.nq = sc.cbase[k.w + 1] - sc.cbase[k.w];
  k.q = c - sc.cbase[k.w];
  const int lo = sc.off[k.w];
  const int L = sc.off[k.w + 1] - lo;
  k.j0 = lo + k.q * L / k.nq;
  k.j1 = lo + (k.q + 1) * L / k.nq;
  return k;
}

// The k-steps of one landed stage, f32: 3xTF32 m16n8k8 (tconv_mma.cuh).
__device__ __forceinline__ void stage_mma(const float* As, const float* Bs, int wrow, int wcol,
                                          float (&acc)[kMT][kNT][4]) {
  using L = Stage<float>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll
  for (int kk = 0; kk < L::kBK; kk += 8) {
    uint32_t ab[kMT][4], as[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int r = wrow + mt * 16 + g;
      split(As[L::a_index(r, kk + c)], ab[mt][0], as[mt][0]);
      split(As[L::a_index(r + 8, kk + c)], ab[mt][1], as[mt][1]);
      split(As[L::a_index(r, kk + c + 4)], ab[mt][2], as[mt][2]);
      split(As[L::a_index(r + 8, kk + c + 4)], ab[mt][3], as[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      uint32_t bb0, bs0, bb1, bs1;
      split(Bs[L::b_index(kk + c, wcol + nt * 8 + g)], bb0, bs0);
      split(Bs[L::b_index(kk + c + 4, wcol + nt * 8 + g)], bb1, bs1);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, as[mt], bb0, bb1);
        mma_tf32(part, ab[mt], bs0, bs1);
        mma_tf32(part, ab[mt], bb0, bb1);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[i];
      }
    }
  }
}

// The k-steps of one landed stage, bf16: one m16n8k16 product per k-step;
// A by 32-bit loads, B (tile rows over k) by ldmatrix.trans, two n-tiles a
// load.
__device__ __forceinline__ void stage_mma(const bf16* As, const bf16* Bs, int wrow, int wcol,
                                          float (&acc)[kMT][kNT][4]) {
  using L = Stage<bf16>;
  using tconv_bf16::ld32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll
  for (int kk = 0; kk < L::kBK; kk += 16) {
    uint32_t a[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int r = wrow + mt * 16 + g;
      a[mt][0] = ld32(As + L::a_index(r, kk + 2 * c));
      a[mt][1] = ld32(As + L::a_index(r + 8, kk + 2 * c));
      a[mt][2] = ld32(As + L::a_index(r, kk + 8 + 2 * c));
      a[mt][3] = ld32(As + L::a_index(r + 8, kk + 8 + 2 * c));
    }
#pragma unroll
    for (int nt = 0; nt < kNT; nt += 2) {
      // lane's row: k = kk + lane % 8 (+8 for matrices 1 and 3), n-tile nt (+1 for matrices 2 and 3)
      uint32_t b[4];
      tconv_bf16::ldmatrix_x4_trans(
          b, Bs + L::b_index(kk + (lane & 7) + ((lane >> 3) & 1) * 8, wcol + (nt + (lane >> 4)) * 8));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        tconv_bf16::mma_fold(acc[mt][nt], a[mt], b[0], b[1]);
        tconv_bf16::mma_fold(acc[mt][nt + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = tconv_bf16::pack_rn(a, b);
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
sparse_kernel(const E* __restrict__ x, const E* __restrict__ tiles,
              const float* __restrict__ vecs, const int* __restrict__ col_off,
              const int* __restrict__ vlist, E* __restrict__ out,
              float* __restrict__ partials, int* __restrict__ counters, int N, int Wp, int cap) {
  using L = Stage<E>;
  constexpr int kVec = 16 / sizeof(E);  // elements of one 16-byte copy
  constexpr int kStagesPerTile = kLane / L::kBK;
  extern __shared__ __align__(16) unsigned char smem[];  // kStages x [A slab | B rows]
  __shared__ Schedule sc;
  const int G = Wp / kLane;
  const int n_rb = (N + kBM - 1) / kBM;
  const int tid = threadIdx.x;

  for (int i = tid; i <= G; i += kThreads) sc.off[i] = col_off[i];
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int w = 0; w < G; ++w) {
      sc.cbase[w] = n;
      n += max(1, (sc.off[w + 1] - sc.off[w] + cap - 1) / cap);
    }
    sc.cbase[G] = n;
  }
  __syncthreads();
  const int n_chunks = sc.cbase[G];
  const int rank = blockIdx.x / n_rb;
  if (rank >= n_chunks) return;  // the grid counts the most chunks the lists could give
  for (int c = tid; c < n_chunks; c += kThreads) {
    const Chunk k = chunk_at(sc, c);
    sc.len[c] = k.j1 - k.j0;
  }
  __syncthreads();
  for (int c = tid; c < n_chunks; c += kThreads) {  // longest first, ties in chunk order
    int r = 0;
    for (int o = 0; o < n_chunks; ++o) r += sc.len[o] > sc.len[c] || (sc.len[o] == sc.len[c] && o < c);
    sc.order[r] = c;
  }
  __syncthreads();
  const Chunk k = chunk_at(sc, sc.order[rank]);
  const int row0 = (blockIdx.x % n_rb) * kBM;
  const int steps = (k.j1 - k.j0) * kStagesPerTile;

  auto issue = [&](int step) {  // start the copies of one stage
    E* As = reinterpret_cast<E*>(smem + (step % kStages) * kStageBytes);
    E* Bs = As + kBM * L::kBK;
    const int j = k.j0 + step / kStagesPerTile;
    const int k0 = (step % kStagesPerTile) * L::kBK;
    const size_t xcol = static_cast<size_t>(__ldg(vlist + j)) * kLane + k0;
    for (int i = tid; i < kBM * (L::kBK / kVec); i += kThreads) {
      const int r = i / (L::kBK / kVec);
      const int q = i % (L::kBK / kVec);
      const bool valid = row0 + r < N;  // rows past the end are zero-filled
      const E* src = valid ? x + static_cast<size_t>(row0 + r) * Wp + xcol + kVec * q : x;
      tconv_bf16::cp_async16(As + L::a_index(r, kVec * q), src, valid);
    }
    const E* tile = tiles + (static_cast<size_t>(j) * kLane + k0) * kLane;
    for (int i = tid; i < L::kBK * (kLane / kVec); i += kThreads) {
      const int kr = i / (kLane / kVec);
      const int q = i % (kLane / kVec);
      tconv_bf16::cp_async16(Bs + L::b_index(kr, kVec * q), tile + kr * kLane + kVec * q, true);
    }
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int wrow = (warp & 3) * 16 * kMT;
  const int wcol = (warp >> 2) * 8 * kNT;
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this stage has landed; the slot of the last one is free
    if (step + kStages - 1 < steps) issue(step + kStages - 1);
    cp_async_commit();
    const E* As = reinterpret_cast<const E*>(smem + (step % kStages) * kStageBytes);
    stage_mma(As, As + kBM * L::kBK, wrow, wcol, acc);
  }
  cp_async_wait<0>();

  if (k.nq > 1) {  // a cut list: leave the partial; the last chunk to finish sums them in order
    const int rb = blockIdx.x % n_rb;
    float* mine = partials + (static_cast<size_t>(sc.order[rank]) * n_rb + rb) * kUnitFloats;
    int e = 0;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) __stcg(mine + (e++) * kThreads + tid, acc[mt][nt][i]);
    __threadfence();
    __syncthreads();
    if (tid == 0) sc.last = atomicAdd(counters + k.w * n_rb + rb, 1) == k.nq - 1;
    __syncthreads();
    if (!sc.last) return;
    __threadfence();
    for (int q = 0; q < k.nq; ++q) {
      const float* p = partials + (static_cast<size_t>(sc.cbase[k.w] + q) * n_rb + rb) * kUnitFloats;
      e = 0;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v = __ldcg(p + (e++) * kThreads + tid);
            acc[mt][nt][i] = q == 0 ? v : acc[mt][nt][i] + v;
          }
    }
  }

#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = k.w * kLane + wcol + nt * 8 + 2 * c;
    const float2 s = __ldg(reinterpret_cast<const float2*>(vecs + col));
    const float2 b = __ldg(reinterpret_cast<const float2*>(vecs + Wp + col));
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + wrow + mt * 16 + g + 8 * half;
        if (row >= N) continue;
        store2(out + static_cast<size_t>(row) * Wp + col, bn_relu(acc[mt][nt][2 * half], s.x, b.x),
               bn_relu(acc[mt][nt][2 * half + 1], s.y, b.y));
      }
  }
}

struct Plan {
  int cap;            // longest chunk, in tiles
  int grid;           // blocks: row blocks x the most chunks the lists could give
  size_t scratch;     // floats of partials (0: no list is cut)
  int counters;       // ints of counters, zeroed by the caller
};

int make_plan(int N, int Wp, int nnz, Plan* plan) {
  static int slots = 0;  // resident blocks on the card, the fewer of the two legs'
  if (slots == 0) {
    int dev = 0, sms = 0, per_f32 = 0, per_bf16 = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(sparse_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmemBytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(sparse_kernel<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmemBytes));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_f32, sparse_kernel<float>, kThreads, kSmemBytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_bf16, sparse_kernel<bf16>, kThreads, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int per_sm = per_f32 < per_bf16 ? per_f32 : per_bf16;
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    slots = per_sm * sms;
  }
  const int G = Wp / kLane;
  if (G > kMaxCols || nnz > G * G) return static_cast<int>(cudaErrorInvalidValue);
  const int n_rb = (N + kBM - 1) / kBM;
  const long long work = static_cast<long long>(nnz) * n_rb;
  const long long per_unit = (work + static_cast<long long>(kSplitWaves) * slots - 1) / (kSplitWaves * slots);
  plan->cap = static_cast<int>(per_unit < kMinChunk ? kMinChunk : per_unit > G ? G : per_unit);
  // a list has at most G tiles: with cap >= G none is cut and there are G chunks
  const bool cut = plan->cap < G;
  const int max_chunks = cut ? G + nnz / plan->cap : G;
  plan->grid = max_chunks * n_rb;
  plan->scratch = cut ? static_cast<size_t>(max_chunks) * n_rb * kUnitFloats : 0;
  plan->counters = cut ? G * n_rb : 0;
  return 0;
}

}  // namespace

// The scratch the launch needs for these shapes: sizes[0] floats of
// partials and sizes[1] int32 counters that must be zero (0 and 0 when no
// list is cut).  Returns a cudaError_t (0 on success).
extern "C" int p2r_stgcn_sparse_scratch(int N, int Wp, int nnz, long long* sizes) {
  Plan plan;
  const int err = make_plan(N, Wp, nnz, &plan);
  if (err != 0) return err;
  sizes[0] = static_cast<long long>(plan.scratch);
  sizes[1] = plan.counters;
  return 0;
}

// x, out: (N, Wp) contiguous f32, 16-byte aligned; tiles: (nnz, 128, 128)
// f32; vecs: (8, Wp) f32; col_off: (Wp/128 + 1,) int32; vlist: (nnz,) int32
// with entries in [0, Wp/128); partials, counters: the scratch of
// p2r_stgcn_sparse_scratch (null when it is 0), counters zeroed.
// Wp % 128 == 0, Wp / 128 <= 64.  Returns the cudaError_t of the launch (0
// on success).
namespace {

template <typename E>
int launch(const E* x, const E* tiles, const float* vecs, const int* col_off, const int* vlist, E* out,
           float* partials, int* counters, int N, int Wp, int nnz, void* stream) {
  if (N == 0) return 0;
  Plan plan;
  const int err = make_plan(N, Wp, nnz, &plan);
  if (err != 0) return err;
  if (plan.scratch > 0 && (partials == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  sparse_kernel<E><<<plan.grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, tiles, vecs, col_off, vlist, out, partials, counters, N, Wp, plan.cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int p2r_stgcn_sparse_f32(const float* x, const float* tiles, const float* vecs,
                                    const int* col_off, const int* vlist, float* out,
                                    float* partials, int* counters, int N, int Wp, int nnz,
                                    void* stream) {
  return launch(x, tiles, vecs, col_off, vlist, out, partials, counters, N, Wp, nnz, stream);
}

// The bf16 leg: x, out (N, Wp) and tiles (nnz, 128, 128) contiguous bf16,
// 16-byte aligned; everything else as p2r_stgcn_sparse_f32, the partials
// f32 (the same scratch).
extern "C" int p2r_stgcn_sparse_bf16(const __nv_bfloat16* x, const __nv_bfloat16* tiles, const float* vecs,
                                     const int* col_off, const int* vlist, __nv_bfloat16* out,
                                     float* partials, int* counters, int N, int Wp, int nnz,
                                     void* stream) {
  return launch(x, tiles, vecs, col_off, vlist, out, partials, counters, N, Wp, nnz, stream);
}
