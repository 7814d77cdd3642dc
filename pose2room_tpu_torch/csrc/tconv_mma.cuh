// Shared core of kernels 1 (stgcn_epilogue.cu), 3 (stgcn_train_fwd.cu) and
// 4 (stgcn_train_bwd.cu): the ST-GCN temporal conv of one joint on the
// tensor cores in 3xTF32.  Kernel 5 (stgcn_sparse.cu) takes its arithmetic
// (split, mma_tf32, cp_async16).
//
// Kernels 1 and 3 compute, per joint (64 columns of the merged (B*T, Wp)
// activations) and per row tile of one clip,
//   y2[t, n] = sum_s sum_k t1[t+s-1, k] * tap_s[k, n]   rows outside the clip are 0
// a GEMM with K = 3 taps x 64 channels.  They differ only in how t1 reaches
// shared memory (kernel 3 builds it from y) and in the epilogue.  Kernel 4
// runs the same conv on dy2 with the transposed taps in reverse order (its
// transpose), and reads the slabs column-wise too for its tap gradient.
//
// Arithmetic: 3xTF32 on mma.sync.m16n8k8 (f32 accumulate).  Every operand a
// is split into big = rna_tf32(a) and small = rna_tf32(a - big) (a - big is
// exact in f32); each product is small*big + big*small + big*big, the small
// terms first.  The dropped small*small term and the rounding of small cost
// ~2^-22 of each |a*b|; with the f32 sums the conv stays within ~2e-7 of
// sum |a*b| of the exact value, as the plain f32 version does
// (tests/test_torch_tconv_3xtf32.py emulates it), so the result keeps f32
// accuracy.
//
// Why mma.sync and not wgmma: tap s reads the slab at a row offset of s,
// and wgmma's shared-memory descriptors want 8-row-aligned core matrices.
// mma.sync fragments come from plain shared loads at any row offset.
//
// Layout in shared memory (no padding, XOR swizzles instead, so that every
// fragment load hits 32 distinct banks and 16-byte cp.async stays aligned):
//   taps [3][64][64]     element (s, k, n) at s*4096 + k*64 + (n ^ ((k & 3) << 3))
//   slab [rows + 2][64]  element (r, k)    at r*64 + (k ^ ((r & 7) << 2))
// Kernel 4's tap gradient also reads the slabs column-wise (lanes over 4
// consecutive rows and 8 columns); there this swizzle gives 2-way bank
// conflicts.  k ^ (((r & 3) << 3) | (r & 4)) serves both shapes without
// conflicts, but measured no faster for kernel 4 and 2.5-4.7% slower for
// kernels 1 and 3 (the colswizzle variants of scripts/torch_*_variants.py).
// Slab row r holds t1 at clip row t0 - 1 + r (the t-1 / t+1 halo), zero
// outside [0, T).  Taps hold the 64x64 diagonal block of KB (3, 128, 128) at
// (col0 % 128): one joint's temporal tap.
//
// A tile is 128 rows of one clip and one joint's 64 columns, and 4 warps
// compute its conv; warp w owns rows [32w, 32w + 32) of the tile and all 64
// columns: 2 m-tiles x 8 n-tiles of 16x8 accumulators, 64 floats a thread.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tconv {

constexpr int kC = 64;        // channels of one joint = width of a diagonal tap block
constexpr int kLane = 128;    // KB is (3, kLane, kLane)
constexpr int kMT = 2;        // 16-row m-tiles of a warp
constexpr int kNT = 8;        // 8-column n-tiles of a warp: all 64 columns
constexpr int kThreads = 128; // 4 warps
constexpr int kRows = 4 * 16 * kMT;  // rows of a tile
constexpr int kTapFloats = 3 * kC * kC;
constexpr int kSlabFloats = (kRows + 2) * kC;

__device__ __forceinline__ int tap_index(int s, int k, int n) {
  return s * kC * kC + k * kC + (n ^ ((k & 3) << 3));
}

__device__ __forceinline__ int slab_index(int r, int k) {
  return r * kC + (k ^ ((r & 7) << 2));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of the joint's three 64x64 diagonal tap blocks: 16-byte
// copies of contiguous rows of KB.  reverse: taps[s] = KB[2 - s].
// Threads: the block's thread count.
template <int Threads = kThreads>
__device__ __forceinline__ void stage_taps(float* taps, const float* __restrict__ kb, int diag,
                                           bool reverse = false) {
  for (int i = threadIdx.x; i < 3 * kC * (kC / 4); i += Threads) {
    const int q = i % (kC / 4);
    const int k = (i / (kC / 4)) % kC;
    const int s = i / (kC * kC / 4);
    const int from = reverse ? 2 - s : s;
    cp_async16(taps + tap_index(s, k, 4 * q),
               kb + (static_cast<size_t>(from) * kLane + diag + k) * kLane + diag + 4 * q, true);
  }
}

// Start the copy of the slab of rows [t0 - 1, t0 + rows] of one clip's
// 64-column group at col0; rows outside [0, T) are zero-filled.  Thread i
// always copies float4 column (i % 16) (Threads is a multiple of 16).
template <int Threads = kThreads>
__device__ __forceinline__ void stage_slab(float* slab, const float* __restrict__ src,
                                           size_t clip_row0, int t0, int T, int Wp, int col0) {
  for (int i = threadIdx.x; i < (kRows + 2) * (kC / 4); i += Threads) {
    const int q = i % (kC / 4);
    const int r = i / (kC / 4);
    const int t = t0 - 1 + r;
    const bool valid = t >= 0 && t < T;
    const float* g = valid ? src + (clip_row0 + t) * static_cast<size_t>(Wp) + col0 + 4 * q : src;
    cp_async16(slab + slab_index(r, 4 * q), g, valid);
  }
}

// The nearest TF32 value to x, ties away from zero, as f32 bits (the low 13
// bits zero, so the value reads back as a float): an integer add on the
// sign-magnitude bits and a mask.  The same bits as cvt.rna.tf32.f32 for
// finite x, and 9-11% faster for kernels 1, 3 and 5 (the cvtsplit variants
// of scripts/torch_*_variants.py): every split issues two.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = rna_tf32(x);
  small = rna_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][nt] = the warp's 16x8 output tile (rows row0 + mt*16.., columns
// nt*8..), summed over the three taps.  Fragment layout of m16n8k8 (g = lane
// / 4, c = lane % 4): A (g | g+8, c | c+4); B (k = c | c+4, n = g); C
// (g | g+8, 2c | 2c+1).
//
// The tensor cores add into their f32 accumulator with truncation, a bias
// toward zero of ~1 ulp per mma: 72 mma into one accumulator moved y2 by
// -1.5e-7 of sum |a*b| on average (3.9e-6 of the column moments' scale).
// So each k-step's three products go into a fresh fragment, which an IEEE
// f32 add (round to nearest) folds into acc: the bias drops to -5e-9, and
// the largest error to 2e-7 of sum |a*b|, as the plain f32 version's.
__device__ __forceinline__ void tconv_mma(const float* slab, const float* taps, int row0,
                                          float (&acc)[kMT][kNT][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < 3; ++s) {
#pragma unroll 2
    for (int k0 = 0; k0 < kC; k0 += 8) {
      uint32_t ab[kMT][4], as[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = row0 + mt * 16 + g + s;
        split(slab[slab_index(r, k0 + c)], ab[mt][0], as[mt][0]);
        split(slab[slab_index(r + 8, k0 + c)], ab[mt][1], as[mt][1]);
        split(slab[slab_index(r, k0 + c + 4)], ab[mt][2], as[mt][2]);
        split(slab[slab_index(r + 8, k0 + c + 4)], ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t bb0, bs0, bb1, bs1;
        split(taps[tap_index(s, k0 + c, nt * 8 + g)], bb0, bs0);
        split(taps[tap_index(s, k0 + c + 4, nt * 8 + g)], bb1, bs1);
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
}

// Launch shape: a persistent grid of at most one block per resident slot
// (2 an SM for kernels 1 and 3, 1 for kernel 4).  Even blocks walk the
// tiles of the even joints and odd blocks those of the odd joints, so each
// block stages the one diagonal tap block its joints read (col0 % 128) once
// for its whole life.  128-row tiles beat 64-row ones at B = 1 too, where
// they leave the card part idle: each tap fragment serves twice the rows.
// slots: resident blocks on the card.
inline int grid_size(int B, int T, int Wp, int slots) {
  const int items = (Wp / kC / 2) * B * ((T + kRows - 1) / kRows);  // tiles of one parity
  const int per_parity = slots / 2 > 0 ? slots / 2 : 1;
  return 2 * (items < per_parity ? items : per_parity);
}

// Tile `item` of the block's parity: its joint column, clip, clip row
// offset and first row.
struct TileAt {
  int col0;
  int b;
  size_t clip_row0;
  int t0;
};

__device__ __forceinline__ TileAt tile_at(int item, int B, int T) {
  const int n_tiles = (T + kRows - 1) / kRows;
  const int per_column = B * n_tiles;
  TileAt a;
  a.col0 = (2 * (item / per_column) + (blockIdx.x & 1)) * kC;
  const int f = item % per_column;
  a.b = f / n_tiles;
  a.clip_row0 = static_cast<size_t>(a.b) * T;
  a.t0 = (f % n_tiles) * kRows;
  return a;
}

}  // namespace tconv
