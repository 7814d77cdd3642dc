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
// x, the tiles and out in bf16 and vecs in f32, and forms its products with
// wgmma (wgmma_bf16.cuh), the only route to the bf16 tensor-core rate.
// Bound: operations at B=1 (7.02 GFLOP: 7.1 us at 989 TFLOP/s; 19.8 MB
// moved: 5.9 us at 3.35 TB/s).  Same units, split-K cut, longest-first
// order and chunk-ordered f32 sum as the f32 leg (its lists cut for one
// wave of the card, not three: kSplitWavesBf16), on another schedule:
// * a persistent grid, one block an SM, walks the longest-first unit list
//   (unit u, u + grid, ...);
// * a producer warp keeps a ring of kRing 32 KB stages full with TMA: per
//   64-deep stage one 128 x 64 box of x (K-major, rows past N read as
//   zeros) and two 64 x 64 boxes of tile rows (MN-major planes), all in the
//   128-byte swizzle, completed on the stage's mbarrier; it runs ahead
//   across units, so a unit's epilogue overlaps the next one's loads;
// * two consumer warpgroups, 64 rows of the unit each, one
//   wgmma.m64n128k16 per k16 step from shared memory (B transposed by the
//   instruction); each releases a stage on its own, so the two drift apart
//   and one's fold runs while the other's products do (with all threads
//   copying by cp.async and a block barrier a stage, they ran in step).
// Accuracy: the tensor cores' adds truncate (tconv_mma.cuh), so every
// kFold k16 steps go into a fresh accumulator (scale-d 0) that IEEE adds
// fold into the running f32 sum.  kFold is 4, one fold a stage: its f32
// accumulator is within 7.3e-8 of sum |a*b| of float64, bias -1.4e-9
// (scripts/torch_bf16_variants.py on an H100; fold 1: 1.4e-7, -2.6e-10),
// inside the port's rule for tensor-core kernels (5e-7, 5e-8).  Two fresh
// accumulators in turn, one folded while the other computes, made ptxas
// serialize every wgmma (C7514) and ran slower.  The split-K partials stay
// f32; the unit that finishes its list applies BN1 and the ReLU in f32 and
// rounds to bf16 once.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tconv_bf16.cuh"
#include "tconv_mma.cuh"
#include "wgmma_bf16.cuh"

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
constexpr int kSplitWaves = 3;              // the chunks fill the card about this many times (f32 leg)
// The bf16 leg's persistent grid balances its units itself; cut for more
// waves, the lists only add partials' traffic (at B=1: 0.0380 ms with one
// wave, 0.0474 with three, 0.0392 uncut; scripts/torch_bf16_variants.py).
constexpr int kSplitWavesBf16 = 1;
constexpr size_t kSmemBytes = kStages * kStageBytes;

static_assert(4 * 16 * kMT == kBM && 2 * 8 * kNT == kLane, "the warps cover the unit");

// One stage's shared-memory layout of the f32 leg: a stage is kBK deep, so
// that an x slab row holds 128 bytes (8 chunks of 16 bytes) and the tile
// rows kBK x 128 elements the same 16 KB.  XOR swizzles keep every fragment
// load on 32 banks and every 16-byte copy aligned.
template <typename E>
struct Stage;

template <>
struct Stage<float> {
  static constexpr int kBK = 32;
  __device__ static int a_index(int r, int k) { return r * kBK + (k ^ ((r & 7) << 2)); }
  __device__ static int b_index(int k, int n) { return k * kLane + (n ^ ((k & 3) << 3)); }
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

// The chunks of every list (sc.off, sc.cbase; every thread of the block
// calls it); returns their count.
__device__ __forceinline__ int schedule_chunks(Schedule& sc, const int* __restrict__ col_off, int G, int cap) {
  for (int i = threadIdx.x; i <= G; i += blockDim.x) sc.off[i] = col_off[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int w = 0; w < G; ++w) {
      sc.cbase[w] = n;
      n += max(1, (sc.off[w + 1] - sc.off[w] + cap - 1) / cap);
    }
    sc.cbase[G] = n;
  }
  __syncthreads();
  return sc.cbase[G];
}

// sc.order: the chunks longest first, ties in chunk order.
__device__ __forceinline__ void schedule_order(Schedule& sc, int n_chunks) {
  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
    const Chunk k = chunk_at(sc, c);
    sc.len[c] = k.j1 - k.j0;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
    int r = 0;
    for (int o = 0; o < n_chunks; ++o) r += sc.len[o] > sc.len[c] || (sc.len[o] == sc.len[c] && o < c);
    sc.order[r] = c;
  }
  __syncthreads();
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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
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

  const int n_chunks = schedule_chunks(sc, col_off, G, cap);
  const int rank = blockIdx.x / n_rb;
  if (rank >= n_chunks) return;  // the grid counts the most chunks the lists could give
  schedule_order(sc, n_chunks);
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

// ---------------------------------------------------------------------------
// bf16 leg: wgmma fed by TMA, persistent
// ---------------------------------------------------------------------------

namespace wg = wgmma_bf16;

constexpr int kRing = 6;                          // stages of the ring
constexpr int kFold = 4;                          // k16 steps summed in one fresh accumulator
constexpr int kConsumers = 256;                   // two warpgroups, 64 rows of the unit each
constexpr int kThreadsBf16 = kConsumers + 32;     // + the producer warp
constexpr int kPlaneBytes = 64 * 128;             // one 64-column plane of a stage's 64 tile rows
constexpr int kRingStageBytes = 2 * kBM * 128;    // 32 KB: x slab (128 rows x 64) | tile rows (2 planes)
constexpr size_t kSmemBytesBf16 = kRing * kRingStageBytes + 1024;  // + slack to align the ring to 1 KB

static_assert(kFold == 1 || kFold == 2 || kFold == 4, "a stage holds 4 k16 steps");

__device__ __forceinline__ void fold(float (&acc)[64], float (&part)[64]) {
  wg::fence_operand(part);  // read the product only after the wait
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// The 4 k16 steps of one landed stage, kFold to a fresh accumulator, each
// folded into acc once it is done.  a, b: the stage's A rows of this
// warpgroup and its tile-row planes.
__device__ __forceinline__ void stage_wgmma(uint32_t a, uint32_t b, float (&acc)[64], float (&part)[64]) {
#pragma unroll
  for (int s0 = 0; s0 < 4; s0 += kFold) {
    wg::fence();  // part was read by the last fold
#pragma unroll
    for (int f = 0; f < kFold; ++f)
      wg::mma_m64n128k16(part, wg::desc_a(a + 32 * (s0 + f)), wg::desc_b(b + 2048 * (s0 + f), kPlaneBytes), f);
    wg::commit();
    wg::wait<0>();
    fold(acc, part);
  }
}

__global__ void __launch_bounds__(kThreadsBf16, 1)
sparse_kernel_bf16(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap tile_map,
                   const float* __restrict__ vecs, const int* __restrict__ col_off, const int* __restrict__ vlist,
                   bf16* __restrict__ out, float* __restrict__ partials, int* __restrict__ counters, int N, int Wp,
                   int cap) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];  // kRing x [x slab | tile row planes]
  __shared__ Schedule sc;
  __shared__ uint64_t full[kRing], empty[kRing];
  const int G = Wp / kLane;
  const int n_rb = (N + kBM - 1) / kBM;
  const int tid = threadIdx.x;

  const int n_chunks = schedule_chunks(sc, col_off, G, cap);
  const int n_units = n_chunks * n_rb;
  if (blockIdx.x >= n_units) return;
  schedule_order(sc, n_chunks);
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      wg::bar_init(&full[s], 1);                // the producer's arrive, with the stage's bytes
      wg::bar_init(&empty[s], kConsumers / 32); // every consumer warp, done reading
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  // the ring starts on a 1024-byte boundary (the swizzle atoms of TMA and wgmma)
  const uint32_t raw = wg::smem_addr(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);

  if (tid >= kConsumers) {  // the producer warp: one thread keeps the ring full
    if (tid != kConsumers) return;
    int g = 0;  // stages issued
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const Chunk k = chunk_at(sc, sc.order[u / n_rb]);
      const int row0 = (u % n_rb) * kBM;
      for (int step = 0; step < (k.j1 - k.j0) * 2; ++step, ++g) {
        const int slot = g % kRing;
        if (g >= kRing) wg::bar_wait(&empty[slot], ((g / kRing) & 1) ^ 1);
        unsigned char* st = ring + slot * kRingStageBytes;
        const int j = k.j0 + step / 2;
        const int k0 = (step % 2) * 64;
        wg::bar_arrive_tx(&full[slot], kRingStageBytes);
        wg::tma_load_2d(st, &x_map, &full[slot], __ldg(vlist + j) * kLane + k0, row0);  // rows past N: zeros
        wg::tma_load_2d(st + kBM * 128, &tile_map, &full[slot], 0, j * kLane + k0);
        wg::tma_load_2d(st + kBM * 128 + kPlaneBytes, &tile_map, &full[slot], 64, j * kLane + k0);
      }
    }
    return;
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int wgi = warp >> 2;                     // warpgroup: rows 64 * wgi .. + 64 of the unit
  const int wrow = 64 * wgi + 16 * (warp & 3);   // this thread's rows: wrow + g, wrow + g + 8
  const uint32_t ring_addr = wg::smem_addr(ring);
  float acc[64];
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;

  int gs = 0;  // stages consumed
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int rb = u % n_rb;
    const int chunk = sc.order[u / n_rb];
    const Chunk k = chunk_at(sc, chunk);
    const int row0 = rb * kBM;
    const int steps = (k.j1 - k.j0) * 2;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int step = 0; step < steps; ++step, ++gs) {
      const int slot = gs % kRing;
      wg::bar_wait(&full[slot], (gs / kRing) & 1);
      const uint32_t st = ring_addr + slot * kRingStageBytes;
      stage_wgmma(st + wgi * 64 * 128, st + kBM * 128, acc, part);
      if (lane == 0) wg::bar_arrive(&empty[slot]);
    }

    if (k.nq > 1) {  // a cut list: leave the partial; the last chunk to finish sums them in order
      float* mine = partials + (static_cast<size_t>(chunk) * n_rb + rb) * kUnitFloats;
#pragma unroll
      for (int e = 0; e < 64; ++e) __stcg(mine + e * kConsumers + tid, acc[e]);
      __threadfence();
      wg::named_sync(1, kConsumers);
      if (tid == 0) sc.last = atomicAdd(counters + k.w * n_rb + rb, 1) == k.nq - 1;
      wg::named_sync(1, kConsumers);
      if (!sc.last) continue;
      __threadfence();
      for (int q = 0; q < k.nq; ++q) {
        const float* pp = partials + (static_cast<size_t>(sc.cbase[k.w] + q) * n_rb + rb) * kUnitFloats;
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const float v = __ldcg(pp + e * kConsumers + tid);
          acc[e] = q == 0 ? v : acc[e] + v;
        }
      }
    }

#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = k.w * kLane + 8 * j + 2 * c;
      const float2 s = __ldg(reinterpret_cast<const float2*>(vecs + col));
      const float2 b = __ldg(reinterpret_cast<const float2*>(vecs + Wp + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wrow + g + 8 * h;
        if (row >= N) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * Wp + col) =
            tconv_bf16::pack_rn(bn_relu(acc[4 * j + 2 * h], s.x, b.x), bn_relu(acc[4 * j + 2 * h + 1], s.y, b.y));
      }
    }
  }
}

struct Plan {
  int cap;            // longest chunk, in tiles
  int grid;           // blocks: row blocks x the most chunks the lists could give
  size_t scratch;     // floats of partials (0: no list is cut)
  int counters;       // ints of counters, zeroed by the caller
  int slots;          // resident blocks on the card: the bf16 leg's persistent grid at most
};

int make_plan(int N, int Wp, int nnz, int waves, Plan* plan) {
  static int slots = 0;  // resident blocks on the card, the fewer of the two legs'
  if (slots == 0) {
    int dev = 0, sms = 0, per_f32 = 0, per_bf16 = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(sparse_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmemBytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(sparse_kernel_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmemBytesBf16));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_f32, sparse_kernel<float>, kThreads, kSmemBytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_bf16, sparse_kernel_bf16, kThreadsBf16,
                                                          kSmemBytesBf16);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int per_sm = per_f32 < per_bf16 ? per_f32 : per_bf16;
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    slots = per_sm * sms;
  }
  const int G = Wp / kLane;
  if (G > kMaxCols || nnz > G * G) return static_cast<int>(cudaErrorInvalidValue);
  const int n_rb = (N + kBM - 1) / kBM;
  const long long work = static_cast<long long>(nnz) * n_rb;
  const long long per_unit = (work + static_cast<long long>(waves) * slots - 1) / (static_cast<long long>(waves) * slots);
  plan->cap = static_cast<int>(per_unit < kMinChunk ? kMinChunk : per_unit > G ? G : per_unit);
  // a list has at most G tiles: with cap >= G none is cut and there are G chunks
  const bool cut = plan->cap < G;
  const int max_chunks = cut ? G + nnz / plan->cap : G;
  plan->grid = max_chunks * n_rb;
  plan->scratch = cut ? static_cast<size_t>(max_chunks) * n_rb * kUnitFloats : 0;
  plan->counters = cut ? G * n_rb : 0;
  plan->slots = slots;
  return 0;
}

}  // namespace

// The scratch a launch of either leg needs for these shapes: sizes[0]
// floats of partials and sizes[1] int32 counters that must be zero (0 and
// 0 when no list is cut).  Returns a cudaError_t (0 on success).
extern "C" int p2r_stgcn_sparse_scratch(int N, int Wp, int nnz, long long* sizes) {
  Plan f32, bf16;
  int err = make_plan(N, Wp, nnz, kSplitWaves, &f32);
  if (err == 0) err = make_plan(N, Wp, nnz, kSplitWavesBf16, &bf16);
  if (err != 0) return err;
  sizes[0] = static_cast<long long>(f32.scratch > bf16.scratch ? f32.scratch : bf16.scratch);
  sizes[1] = f32.counters > bf16.counters ? f32.counters : bf16.counters;
  return 0;
}

namespace {

// cuTensorMapEncodeTiled, found through the runtime (no link to the driver library)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A TMA map of a row-major bf16 matrix (rows x cols, 16-byte aligned, rows
// cols * 2 bytes apart): boxes of box_rows x 64 elements, written to shared
// memory in the 128-byte swizzle; a box past the last row reads zeros.
int bf16_map(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows, uint32_t box_rows) {
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
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The plan of a launch, checked against the scratch it was given.
int plan_launch(int N, int Wp, int nnz, int waves, const float* partials, const int* counters, Plan* plan) {
  const int err = make_plan(N, Wp, nnz, waves, plan);
  if (err != 0) return err;
  if (plan->scratch > 0 && (partials == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// x, out: (N, Wp) contiguous f32, 16-byte aligned; tiles: (nnz, 128, 128)
// f32; vecs: (8, Wp) f32; col_off: (Wp/128 + 1,) int32; vlist: (nnz,) int32
// with entries in [0, Wp/128); partials, counters: the scratch of
// p2r_stgcn_sparse_scratch (null when it is 0), counters zeroed.
// Wp % 128 == 0, Wp / 128 <= 64.  Returns the cudaError_t of the launch (0
// on success).
extern "C" int p2r_stgcn_sparse_f32(const float* x, const float* tiles, const float* vecs,
                                    const int* col_off, const int* vlist, float* out,
                                    float* partials, int* counters, int N, int Wp, int nnz,
                                    void* stream) {
  if (N == 0) return 0;
  Plan plan;
  const int err = plan_launch(N, Wp, nnz, kSplitWaves, partials, counters, &plan);
  if (err != 0) return err;
  sparse_kernel<float><<<plan.grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, tiles, vecs, col_off, vlist, out, partials, counters, N, Wp, plan.cap);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 leg: x, out (N, Wp) and tiles (nnz, 128, 128) contiguous bf16,
// 16-byte aligned; everything else as p2r_stgcn_sparse_f32, the partials
// f32 (the same scratch).  A persistent grid of at most one block an SM.
extern "C" int p2r_stgcn_sparse_bf16(const __nv_bfloat16* x, const __nv_bfloat16* tiles, const float* vecs,
                                     const int* col_off, const int* vlist, __nv_bfloat16* out,
                                     float* partials, int* counters, int N, int Wp, int nnz,
                                     void* stream) {
  if (N == 0) return 0;
  Plan plan;
  const int err = plan_launch(N, Wp, nnz, kSplitWavesBf16, partials, counters, &plan);
  if (err != 0) return err;
  // TMA boxes: 128 rows x 64 columns of x (rows past N read as zeros), 64
  // rows x 64 columns of the tiles seen as (nnz * 128, 128)
  CUtensorMap x_map, tile_map;
  int e = bf16_map(&x_map, x, Wp, N, kBM);
  if (e == 0) e = bf16_map(&tile_map, nnz > 0 ? tiles : x, kLane, static_cast<uint64_t>(nnz > 0 ? nnz : 1) * kLane, 64);
  if (e != 0) return e;
  const int grid = plan.grid < plan.slots ? plan.grid : plan.slots;
  sparse_kernel_bf16<<<grid, kThreadsBf16, kSmemBytesBf16, static_cast<cudaStream_t>(stream)>>>(
      x_map, tile_map, vecs, col_off, vlist, out, partials, counters, N, Wp, plan.cap);
  return static_cast<int>(cudaGetLastError());
}
