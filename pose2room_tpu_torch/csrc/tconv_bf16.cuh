// bf16 legs of kernels 1 (stgcn_epilogue.cu), 3 (stgcn_train_fwd.cu) and 4
// (stgcn_train_bwd.cu): the tensor-core arithmetic and the shared-memory
// layouts for bf16 operands.  Kernel 1 takes the conv core tconv_mma (taps
// staged transposed, fragments by 32-bit loads), kernels 3 and 4 its twin
// tconv_mma_kmajor (taps as KB lies, fragments by ldmatrix) and t1_pass.
// Kernel 5 (stgcn_sparse.cu) takes the copies and packing; its bf16 leg
// multiplies on wgmma (wgmma_bf16.cuh) from swz64's layout.
//
// Arithmetic: one mma.sync.m16n8k16 bf16 product per k-step (bf16 x bf16 is
// exact in f32; no split, unlike the f32 legs' 3xTF32).  The tensor cores
// add into their f32 accumulator with truncation (tconv_mma.cuh), so each
// k-step's product goes into a fresh zero fragment that an IEEE f32 add
// folds into the accumulator, as the f32 legs do.
//
// Fragment layout of m16n8k16 (g = lane / 4, c = lane % 4; each 32-bit
// register holds two bf16, the lower index in the low half):
//   A (16x16, row)  a0 (g, 2c..2c+1)  a1 (g+8, 2c..)  a2 (g, 2c+8..)  a3 (g+8, 2c+8..)
//   B (16x8, col)   b0 (k = 2c..2c+1, n = g)   b1 (k = 2c+8..2c+9, n = g)
//   C (16x8, f32)   as m16n8k8: (g | g+8, 2c | 2c+1)
// A comes from rows of 64 bf16 (128 bytes: 8 chunks of 16 bytes) whose
// chunks are XOR-swizzled by the row: chunk q of row r sits at q ^ (r & 7).
// Then a warp's 32-bit fragment loads (8 consecutive rows x 4 words) hit 32
// distinct banks at any row offset, which is what the conv's taps need
// (tap s reads the slab s rows down), and 16-byte cp.async stays aligned.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tconv_mma.cuh"

namespace tconv_bf16 {

using bf16 = __nv_bfloat16;
using tconv::kC;
using tconv::kLane;
using tconv::kMT;
using tconv::kNT;
using tconv::kRows;
using tconv::kThreads;

constexpr int kTapElems = 3 * kC * kC;          // taps, transposed: [s][n][k]
constexpr int kSlabElems = (kRows + 2) * kC;    // t1 rows t0-1 .. t0+kRows, one joint

// element (r, k) of a swizzled array of 64-wide bf16 rows
__device__ __forceinline__ int swz64(int r, int k) {
  return r * kC + ((((k >> 3) ^ (r & 7))) << 3) + (k & 7);
}

__device__ __forceinline__ int slab_index(int r, int k) { return swz64(r, k); }

// tap s, output channel n, input channel k (transposed, so that a B
// fragment register, two consecutive k of one n, is one 32-bit load)
__device__ __forceinline__ int tap_index(int s, int n, int k) { return s * kC * kC + swz64(n, k); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// four 8x8 bf16 matrices from shared memory, transposed: lane i gives the
// address of row i % 8 of matrix i / 8; register m holds matrix m's
// elements (2c, g) and (2c + 1, g), a B fragment register when the stored
// rows run over k.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// four 8x8 bf16 matrices from shared memory: lane i gives the address of
// row i % 8 of matrix i / 8; register m holds matrix m's elements (g, 2c)
// and (g, 2c + 1), an A fragment register when the stored rows run over m.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d = a @ b into a fresh fragment (the zero accumulator an input operand,
// not the output registers cleared first)
__device__ __forceinline__ void mma_bf16_fresh(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += a @ b as one product in a fresh fragment, folded in by IEEE adds
__device__ __forceinline__ void mma_fold(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(part, a, b0, b1);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// Copy the joint's three 64x64 diagonal tap blocks of KB (3, 128, 128) into
// taps[s][n][k] (once per block of the persistent grid: plain loads and
// stores, made visible by the caller's next barrier).  reverse: taps[s] =
// KB[2 - s].
template <int Threads = kThreads>
__device__ __forceinline__ void stage_taps(bf16* taps, const bf16* __restrict__ kb, int diag,
                                           bool reverse = false) {
  for (int i = threadIdx.x; i < kTapElems; i += Threads) {
    const int n = i % kC;
    const int k = (i / kC) % kC;
    const int s = i / (kC * kC);
    const int from = reverse ? 2 - s : s;
    taps[tap_index(s, n, k)] = kb[(static_cast<size_t>(from) * kLane + diag + k) * kLane + diag + n];
  }
}

// Start the copy of the joint's three 64x64 diagonal tap blocks of KB (3,
// 128, 128) as they lie, k-major: taps[s] element (k, n) at
// s * kC * kC + swz64(k, n), 16-byte copies of KB's rows.  B fragments come
// from them by ldmatrix.trans (tconv_mma_kmajor).  reverse: taps[s] =
// KB[2 - s].
template <int Threads>
__device__ __forceinline__ void stage_taps_kmajor(bf16* taps, const bf16* __restrict__ kb, int diag,
                                                  bool reverse = false) {
  for (int i = threadIdx.x; i < 3 * kC * (kC / 8); i += Threads) {
    const int q = i % (kC / 8);
    const int k = (i / (kC / 8)) % kC;
    const int s = i / (kC * kC / 8);
    const int from = reverse ? 2 - s : s;
    cp_async16(taps + s * kC * kC + swz64(k, 8 * q),
               kb + (static_cast<size_t>(from) * kLane + diag + k) * kLane + diag + 8 * q, true);
  }
}

// Start the copy of the slab of rows [t0 - 1, t0 + kRows] of one clip's
// 64-column group at col0 (16 bytes = 8 bf16 per copy); rows outside
// [0, T) are zero-filled.
template <int Threads = kThreads>
__device__ __forceinline__ void stage_slab(bf16* slab, const bf16* __restrict__ src, size_t clip_row0, int t0,
                                           int T, int Wp, int col0) {
  for (int i = threadIdx.x; i < (kRows + 2) * (kC / 8); i += Threads) {
    const int q = i % (kC / 8);
    const int r = i / (kC / 8);
    const int t = t0 - 1 + r;
    const bool valid = t >= 0 && t < T;
    const bf16* g = valid ? src + (clip_row0 + t) * static_cast<size_t>(Wp) + col0 + 8 * q : src;
    cp_async16(slab + slab_index(r, 8 * q), g, valid);
  }
}

// acc[mt][nt] = the warp's 16x8 output tile (rows row0 + mt*16.., columns
// nt*8..) of the conv, summed over the three taps and 64 input channels:
// 12 k-steps of 16, one m16n8k16 product each.  MT: the warp's 16-row
// m-tiles; TapUnroll: how far the loop over the three taps is unrolled
// (fully by default; 1 holds the registers of a wide block under its cap).
// The sums of an element are the same for any MT and TapUnroll.
template <int MT = kMT, int TapUnroll = 3>
__device__ __forceinline__ void tconv_mma(const bf16* slab, const bf16* taps, int row0,
                                          float (&acc)[MT][kNT][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll TapUnroll
  for (int s = 0; s < 3; ++s) {
#pragma unroll
    for (int k0 = 0; k0 < kC; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = row0 + mt * 16 + g + s;
        a[mt][0] = ld32(slab + slab_index(r, k0 + 2 * c));
        a[mt][1] = ld32(slab + slab_index(r + 8, k0 + 2 * c));
        a[mt][2] = ld32(slab + slab_index(r, k0 + 8 + 2 * c));
        a[mt][3] = ld32(slab + slab_index(r + 8, k0 + 8 + 2 * c));
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int n = nt * 8 + g;
        const uint32_t b0 = ld32(taps + tap_index(s, n, k0 + 2 * c));
        const uint32_t b1 = ld32(taps + tap_index(s, n, k0 + 8 + 2 * c));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_fold(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }
}

// acc[mt][nt] = the warp's 16x8 output tile (rows row0 + mt*16.., columns
// n0 + nt*8..) of the conv from k-major taps (stage_taps_kmajor): the same
// products and the same sums in the same order as tconv_mma (tap s, then
// 16-deep k-steps, each into a fresh fragment folded in by an IEEE add), so
// the same bits; the fragments come by ldmatrix (A: four 8x8 matrices of
// the slab at any row offset; B: two n-tiles per ldmatrix.trans), MT + NT/2
// loads a k-step where tconv_mma issues 4 MT + 2 NT.
template <int MT, int NT>
__device__ __forceinline__ void tconv_mma_kmajor(const bf16* slab, const bf16* taps, int row0, int n0,
                                                 float (&acc)[MT][NT][4]) {
  static_assert(NT % 2 == 0, "B fragments come two n-tiles at a time");
  const int lane = threadIdx.x & 31;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;  // A: matrices 1, 3 hold rows 8..15
  const int acol = (lane >> 4) * 8;                     // A: matrices 2, 3 hold k 8..15
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;  // B: matrices 1, 3 hold k 8..15
  const int bcol = (lane >> 4) * 8;                     // B: matrices 2, 3 the next n-tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const bf16* tap = taps + s * kC * kC;
#pragma unroll
    for (int k0 = 0; k0 < kC; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], slab + swz64(row0 + mt * 16 + s + arow, k0 + acol));
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b[4];  // n-tiles nt (matrices 0, 1) and nt + 1 (matrices 2, 3)
        ldmatrix_x4_trans(b, tap + swz64(k0 + brow, n0 + nt * 8 + bcol));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float part[4];
          mma_bf16_fresh(part, a[mt], b[0], b[1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], part[i]);
          mma_bf16_fresh(part, a[mt], b[2], b[3]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt + 1][i] = __fadd_rn(acc[mt][nt + 1][i], part[i]);
        }
      }
    }
  }
}

// t1 = relu(y * s1 + sh1) of 8 consecutive bf16 y (one 16-byte chunk), in
// f32 as a product then a sum (no FMA contraction, as the plain versions
// compute it), rounded to nearest even into bf16 in place.
__device__ __forceinline__ void bn_relu_chunk(uint4& v, const float (&s1)[8], const float (&sh1)[8]) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lo = fmaxf(__fadd_rn(__fmul_rn(__uint_as_float(w[j] << 16), s1[2 * j]), sh1[2 * j]), 0.f);
    const float hi =
        fmaxf(__fadd_rn(__fmul_rn(__uint_as_float(w[j] & 0xffff0000u), s1[2 * j + 1]), sh1[2 * j + 1]), 0.f);
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    w[j] = *reinterpret_cast<const uint32_t*>(&p);
  }
  v = make_uint4(w[0], w[1], w[2], w[3]);
}

// t1 = relu(y * s1 + sh1) over an item's slab (rows t0 - 1 .. t0 + kRows;
// y where the clip has the row, 0 elsewhere), written to dst likewise (dst
// may be src: in place); s1 / sh1 the item's columns in shared memory.  A
// thread builds the same 8 columns of every row it takes, so it reads its
// s1 / sh1 once; 16 bytes a step, without branches; Unroll: how many steps
// are in flight (all by default; fewer where registers are short).
template <int Threads, int Unroll = 8>
__device__ __forceinline__ void t1_pass(bf16* dst, const bf16* src, const float* s1v, const float* sh1v, int t0,
                                        int T) {
  constexpr int kPerRow = kC / 8;  // 16-byte chunks of a row
  constexpr int kChunks = (tconv::kRows + 2) * kPerRow;
  static_assert(Threads % kPerRow == 0, "a thread keeps its columns");
  const int q = threadIdx.x % kPerRow;
  float s1[8], sh1[8];
  {
    const float4* p = reinterpret_cast<const float4*>(s1v + 8 * q);
    const float4* h = reinterpret_cast<const float4*>(sh1v + 8 * q);
    const float4 a = p[0], b = p[1], c = h[0], d = h[1];
    s1[0] = a.x; s1[1] = a.y; s1[2] = a.z; s1[3] = a.w; s1[4] = b.x; s1[5] = b.y; s1[6] = b.z; s1[7] = b.w;
    sh1[0] = c.x; sh1[1] = c.y; sh1[2] = c.z; sh1[3] = c.w; sh1[4] = d.x; sh1[5] = d.y; sh1[6] = d.z; sh1[7] = d.w;
  }
#pragma unroll Unroll
  for (int it = 0; it < (kChunks + Threads - 1) / Threads; ++it) {
    const int i = threadIdx.x + it * Threads;
    if (kChunks % Threads == 0 || i < kChunks) {
      const int r = i / kPerRow;
      const int t = t0 - 1 + r;
      const int at = slab_index(r, 8 * q);
      uint4 v = *reinterpret_cast<const uint4*>(src + at);
      bn_relu_chunk(v, s1, sh1);
      if (t < 0 || t >= T) v = make_uint4(0u, 0u, 0u, 0u);  // t1 is 0 outside the clip
      *reinterpret_cast<uint4*>(dst + at) = v;
    }
  }
}

// Two f32 values -> two bf16, round to nearest even, as one 32-bit word.
__device__ __forceinline__ __nv_bfloat162 pack_rn(float lo, float hi) { return __floats2bfloat162_rn(lo, hi); }

// Two bf16 in one 32-bit word (the lower index in the low half) -> f32 (exact).
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

}  // namespace tconv_bf16
