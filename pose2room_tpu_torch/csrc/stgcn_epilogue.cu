// Fused ST-GCN block epilogue for the eval chain, f32 and bf16 legs, Hopper
// (sm_90a).
//
// Replaces: pose2room_tpu/ops/stgcn_fused.py:_epilogue_kernel (Pallas, TPU),
// reached through fused_epilogue / fused_stgcn_layer once per ST-GCN block.
//
// Computes, on merged activations (B*T, Wp) with Wp = 27*128 = 3456:
//   y2  = sum_s shift_s(t1) @ KB[s]        tap s reads row t+s-1, zero outside the clip
//   out = relu(y2 * s2 + b2' [+ x])        s2 = vecs[2], b2' = vecs[3]
// KB (3,128,128) is block-diagonal: every C x C diagonal block (C = 64 channels
// of one joint) holds the same temporal tap.  The kernel reads only the
// diagonal block at (col0 % 128); the plain PyTorch version multiplies the
// full 128x128 KB, which the fold (fold_eval_arrays) guarantees is zero off
// the diagonal.
//
// What bounds it on an H100: bytes, in principle.  Per clip and block the
// taps need 2*768*3456*192 = 1.02 GFLOP, done as three TF32 products each
// (3xTF32, tconv_mma.cuh): 6.2 us at 495 TFLOP/s, under the 9.5 us (no
// residual: 6.3 us) that t1, x and out need at 3.35 TB/s.  In practice the
// mma.sync issue rate, which is below wgmma's, and the operand splits bound
// it (PERF.md).
//
// Design: tconv_mma.cuh's core on a persistent grid.  A block stages its
// diagonal tap block once (cp.async) and walks row tiles (128 rows of one
// clip) of the joints that read it.  Each tile's slab of t1 with its
// halo comes in by cp.async (zero-filled outside the clip); the next tile's
// copy starts as soon as the warps are done reading the slab, so it
// overlaps this tile's epilogue, and the other resident block's work
// overlaps both.  Pad columns (3392..3455) come out exactly 0 because t1,
// x, s2 and b2' are 0 there.
//
// The bf16 leg (p2r_stgcn_epilogue_bf16; model.compute_dtype: bfloat16)
// takes t1, x, KB and out in bf16 and vecs in f32, and computes what the
// Pallas kernel's bf16 path computes: every tap product from bf16 operands
// into an f32 accumulator (one mma.sync.m16n8k16 per k-step, no split,
// tconv_bf16.cuh), then y2 * s2 + b2' [+ x widened to f32], the ReLU, and
// one round-to-nearest-even cast to bf16.  Bound: bytes (2 bytes an
// element: 10.6 MB, 15.9 MB with the residual, per clip: 3.2 / 4.8 us at
// 3.35 TB/s; the 1.02 GFLOP are 1.0 us at the bf16 tensor-core rate, so
// mma.sync stays: the taps read the slab at row offsets).  The design is
// for the memory side: an item is 128 rows x 128 columns (two joints, both
// diagonal tap blocks staged once per block), so every row segment moved
// is 256 bytes; a persistent grid of one 16-warp block an SM double-buffers
// everything an item reads (both t1 slabs, the residual tile, s2 and b2')
// in cp.async copies that run while the previous item is computed; the
// output tile is staged in shared memory (in place of the residual) and
// leaves in coalesced 16-byte stores.  The sums are the earlier leg's, in
// the same order, so the bits are too.

#include <cuda_runtime.h>

#include "tconv_bf16.cuh"
#include "tconv_mma.cuh"

namespace {

using namespace tconv;

constexpr size_t kSmemBytes = (kTapFloats + kSlabFloats) * sizeof(float);

template <bool kResidual>
__global__ void __launch_bounds__(kThreads, 2)
epilogue_kernel(const float* __restrict__ t1, const float* __restrict__ x,
                const float* __restrict__ vecs, const float* __restrict__ kb,
                float* __restrict__ out, int B, int T, int Wp) {
  extern __shared__ __align__(16) float smem[];
  float* taps = smem;
  float* slab = taps + kTapFloats;

  const int items = (Wp / kC / 2) * B * ((T + kRows - 1) / kRows);
  const int stride = gridDim.x / 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int row0 = warp * 16 * kMT;

  int item = blockIdx.x >> 1;
  TileAt a = tile_at(item, B, T);
  stage_taps(taps, kb, (blockIdx.x & 1) * kC);
  stage_slab(slab, t1, a.clip_row0, a.t0, T, Wp, a.col0);
  cp_async_commit();

  for (; item < items; item += stride) {
    const bool more = item + stride < items;
    const TileAt next = tile_at(more ? item + stride : item, B, T);
    cp_async_wait<0>();
    __syncthreads();

    float acc[kMT][kNT][4];
    tconv_mma(slab, taps, row0, acc);
    __syncthreads();  // every warp is done reading the slab
    if (more) {
      stage_slab(slab, t1, next.clip_row0, next.t0, T, Wp, next.col0);
      cp_async_commit();
    }

#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = a.col0 + nt * 8 + 2 * c;
      const float2 s2 = __ldg(reinterpret_cast<const float2*>(vecs + 2 * static_cast<size_t>(Wp) + n));
      const float2 b2 = __ldg(reinterpret_cast<const float2*>(vecs + 3 * static_cast<size_t>(Wp) + n));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = a.t0 + row0 + mt * 16 + g + 8 * half;
          if (t >= T) continue;
          const size_t idx = (a.clip_row0 + t) * Wp + n;
          float v0 = acc[mt][nt][2 * half] * s2.x + b2.x;
          float v1 = acc[mt][nt][2 * half + 1] * s2.y + b2.y;
          if (kResidual) {
            const float2 xv = __ldg(reinterpret_cast<const float2*>(x + idx));
            v0 += xv.x;
            v1 += xv.y;
          }
          *reinterpret_cast<float2*>(out + idx) = make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
    }
    a = next;
  }
}

namespace tb = tconv_bf16;

// bf16 leg: an item is 128 rows of one clip and one 128-column group (two
// joints, both diagonal tap blocks); each warp computes kWarpRows rows of
// one joint.  Shared memory, two buffers of each per-item array:
constexpr int kWarpRows = 16;                            // 16 warps: latency hiding, no spills
constexpr int kWarpsPerJoint = kRows / kWarpRows;
constexpr int kThreadsBf16 = 2 * kWarpsPerJoint * 32;
constexpr int kMTBf16 = kWarpRows / 16;
constexpr int kTapUnroll = 1;  // the taps' loop rolled: no spills under 128 registers a thread
constexpr int kTileElems = kRows * kC;  // one joint's 128 x 64 output (or residual) tile
struct alignas(16) SmemBf16 {
  tb::bf16 taps[2][tb::kTapElems];           // per joint: KB's diagonal block, transposed
  tb::bf16 slab[2][2][tb::kSlabElems];       // [buffer][joint]: t1 rows t0 - 1 .. t0 + 128
  tb::bf16 tile[2][2][kTileElems];           // [buffer][joint]: the residual in, the output out
  float vec[2][2][kLane];                    // [buffer]: s2, b2' of the item's 128 columns
};

__device__ __forceinline__ TileAt item_at(int item, int B, int T) {
  const int n_tiles = (T + kRows - 1) / kRows;
  const int per_column = B * n_tiles;
  TileAt a;
  a.col0 = (item / per_column) * kLane;
  const int f = item % per_column;
  a.b = f / n_tiles;
  a.clip_row0 = static_cast<size_t>(a.b) * T;
  a.t0 = (f % n_tiles) * kRows;
  return a;
}

// Start the copies of one item into buffer buf: both joints' t1 slabs (rows
// outside the clip zero-filled), the residual tile and the item's s2 / b2'.
template <bool kResidual>
__device__ __forceinline__ void stage_item(SmemBf16& sm, int buf, const TileAt& a, const tb::bf16* __restrict__ t1,
                                           const tb::bf16* __restrict__ x, const float* __restrict__ vecs, int T,
                                           int Wp) {
  for (int jn = 0; jn < 2; ++jn)
    tb::stage_slab<kThreadsBf16>(sm.slab[buf][jn], t1, a.clip_row0, a.t0, T, Wp, a.col0 + jn * kC);
  if (kResidual) {
    for (int i = threadIdx.x; i < kRows * 16; i += kThreadsBf16) {
      const int r = i >> 4;
      const int q = i & 15;  // 16-byte chunk of the 256-byte row segment: joint q / 8
      const bool valid = a.t0 + r < T;
      const tb::bf16* src = valid ? x + (a.clip_row0 + a.t0 + r) * static_cast<size_t>(Wp) + a.col0 + 8 * q : x;
      tb::cp_async16(sm.tile[buf][q >> 3] + tb::swz64(r, 8 * (q & 7)), src, valid);
    }
  }
  if (threadIdx.x < 64) {  // 32 chunks of s2, 32 of b2'
    const int row = 2 + (threadIdx.x >> 5);
    const int q = threadIdx.x & 31;
    tb::cp_async16(&sm.vec[buf][row - 2][4 * q], vecs + static_cast<size_t>(row) * Wp + a.col0 + 4 * q, true);
  }
}

// The taps of both joints, the t1 slabs, the residual and s2 / b2' come in by
// cp.async, the next item's while this one is computed; the conv is
// tconv_bf16.cuh's (the same sums in the same order as before); the output
// tile is staged in shared memory and leaves in 16-byte stores, 256 bytes a
// row.
template <bool kResidual>
__global__ void __launch_bounds__(kThreadsBf16, 1)
epilogue_kernel_bf16(const tb::bf16* __restrict__ t1, const tb::bf16* __restrict__ x,
                     const float* __restrict__ vecs, const tb::bf16* __restrict__ kb,
                     tb::bf16* __restrict__ out, int B, int T, int Wp) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  SmemBf16& sm = *reinterpret_cast<SmemBf16*>(smem_bytes);

  const int items = (Wp / kLane) * B * ((T + kRows - 1) / kRows);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int jn = warp / kWarpsPerJoint;  // joint of the item's two
  const int row0 = (warp % kWarpsPerJoint) * kWarpRows;

  int item = blockIdx.x;
  if (item >= items) return;
  for (int j = 0; j < 2; ++j) tb::stage_taps<kThreadsBf16>(sm.taps[j], kb, j * kC);
  TileAt a = item_at(item, B, T);
  stage_item<kResidual>(sm, 0, a, t1, x, vecs, T, Wp);
  cp_async_commit();

  for (int buf = 0; item < items; item += gridDim.x, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this item has landed; the last item's tile is stored and its buffers free
    const int next = item + gridDim.x;
    const TileAt na = item_at(next < items ? next : item, B, T);
    if (next < items) stage_item<kResidual>(sm, buf ^ 1, na, t1, x, vecs, T, Wp);
    cp_async_commit();

    float acc[kMTBf16][kNT][4];
    tb::tconv_mma<kMTBf16, kTapUnroll>(sm.slab[buf][jn], sm.taps[jn], row0, acc);
    tb::bf16* tile = sm.tile[buf][jn];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = nt * 8 + 2 * c;
      const float2 s2 = *reinterpret_cast<const float2*>(&sm.vec[buf][0][jn * kC + n]);
      const float2 b2 = *reinterpret_cast<const float2*>(&sm.vec[buf][1][jn * kC + n]);
#pragma unroll
      for (int mt = 0; mt < kMTBf16; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t* slot = reinterpret_cast<uint32_t*>(tile + tb::swz64(row0 + mt * 16 + g + 8 * half, n));
          // a product, then a sum, then the residual: the plain version's roundings
          float v0 = __fadd_rn(__fmul_rn(acc[mt][nt][2 * half], s2.x), b2.x);
          float v1 = __fadd_rn(__fmul_rn(acc[mt][nt][2 * half + 1], s2.y), b2.y);
          if (kResidual) {
            const float2 xv = tb::unpack2(*slot);
            v0 = __fadd_rn(v0, xv.x);
            v1 = __fadd_rn(v1, xv.y);
          }
          const __nv_bfloat162 o = tb::pack_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          *slot = *reinterpret_cast<const uint32_t*>(&o);
        }
    }
    __syncthreads();  // the item's output tile is complete
    for (int i = threadIdx.x; i < kRows * 16; i += kThreadsBf16) {
      const int r = i >> 4;
      const int q = i & 15;
      if (a.t0 + r >= T) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(sm.tile[buf][q >> 3] + tb::swz64(r, 8 * (q & 7)));
      *reinterpret_cast<uint4*>(out + (a.clip_row0 + a.t0 + r) * static_cast<size_t>(Wp) + a.col0 + 8 * q) = v;
    }
    a = na;
  }
  cp_async_wait<0>();
}

template <bool R>
cudaError_t configure(int sms, int* slots) {
  cudaError_t err = cudaFuncSetAttribute(epilogue_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, epilogue_kernel<R>, kThreads, kSmemBytes);
  *slots = per_sm * sms;
  return err;
}

template <bool R>
cudaError_t configure_bf16(int sms, int* slots) {
  cudaError_t err = cudaFuncSetAttribute(epilogue_kernel_bf16<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(SmemBf16)));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, epilogue_kernel_bf16<R>, kThreadsBf16,
                                                      sizeof(SmemBf16));
  *slots = per_sm * sms;
  return err;
}

}  // namespace

// t1, x, out: (B*T, Wp) contiguous f32, 16-byte aligned (x unused and may be
// null when residual == 0); vecs: (8, Wp) f32; kb: (3, 128, 128) f32.
// Wp % 128 == 0.  Returns the cudaError_t of the launch (0 on success).
extern "C" int p2r_stgcn_epilogue_f32(const float* t1, const float* x,
                                      const float* vecs, const float* kb,
                                      float* out, int B, int T, int Wp,
                                      int residual, void* stream) {
  static bool configured = false;
  static int slots[2];  // [residual]: resident blocks on the card
  if (!configured) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = configure<false>(sms, &slots[0]);
    if (err == cudaSuccess) err = configure<true>(sms, &slots[1]);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int grid = grid_size(B, T, Wp, slots[residual ? 1 : 0]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (residual) {
    epilogue_kernel<true><<<grid, kThreads, kSmemBytes, s>>>(t1, x, vecs, kb, out, B, T, Wp);
  } else {
    epilogue_kernel<false><<<grid, kThreads, kSmemBytes, s>>>(t1, nullptr, vecs, kb, out, B, T, Wp);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bf16 leg.  t1, x, out: (B*T, Wp) contiguous bf16, 16-byte aligned (x
// unused and may be null when residual == 0); vecs: (8, Wp) f32; kb:
// (3, 128, 128) bf16.  Wp % 128 == 0.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int p2r_stgcn_epilogue_bf16(const __nv_bfloat16* t1, const __nv_bfloat16* x,
                                       const float* vecs, const __nv_bfloat16* kb,
                                       __nv_bfloat16* out, int B, int T, int Wp,
                                       int residual, void* stream) {
  static bool configured = false;
  static int slots[2];  // [residual]: resident blocks on the card
  if (!configured) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = configure_bf16<false>(sms, &slots[0]);
    if (err == cudaSuccess) err = configure_bf16<true>(sms, &slots[1]);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int items = (Wp / kLane) * B * ((T + kRows - 1) / kRows);
  const int per_grid = slots[residual ? 1 : 0];
  const int grid = items < per_grid ? items : per_grid;
  if (grid == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = sizeof(SmemBf16);
  if (residual) {
    epilogue_kernel_bf16<true><<<grid, kThreadsBf16, bytes, s>>>(t1, x, vecs, kb, out, B, T, Wp);
  } else {
    epilogue_kernel_bf16<false><<<grid, kThreadsBf16, bytes, s>>>(t1, nullptr, vecs, kb, out, B, T, Wp);
  }
  return static_cast<int>(cudaGetLastError());
}
