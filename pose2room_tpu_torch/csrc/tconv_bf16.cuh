// bf16 legs of kernels 1 (stgcn_epilogue.cu), 3 (stgcn_train_fwd.cu) and 4
// (stgcn_train_bwd.cu): the tensor-core arithmetic and the shared-memory
// layouts for bf16 operands.  Kernel 5 (stgcn_sparse.cu) takes its copies
// and packing; its bf16 leg multiplies on wgmma (wgmma_bf16.cuh) from
// swz64's layout.
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

// The 8 floats of row `row` of vecs (rows of Wp floats) from column col on.
__device__ __forceinline__ void load8(float (&out)[8], const float* __restrict__ vecs, int row, int Wp, int col) {
  const float4* p = reinterpret_cast<const float4*>(vecs + static_cast<size_t>(row) * Wp + col);
  const float4 a = __ldg(p), b = __ldg(p + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Two f32 values -> two bf16, round to nearest even, as one 32-bit word.
__device__ __forceinline__ __nv_bfloat162 pack_rn(float lo, float hi) { return __floats2bfloat162_rn(lo, hi); }

// Two bf16 in one 32-bit word (the lower index in the low half) -> f32 (exact).
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// Two consecutive bf16 at p in global memory -> f32 (exact).
__device__ __forceinline__ float2 load2(const bf16* __restrict__ p) {
  return unpack2(__ldg(reinterpret_cast<const unsigned int*>(p)));
}

}  // namespace tconv_bf16
