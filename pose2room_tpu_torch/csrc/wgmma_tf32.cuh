// wgmma (Hopper's warpgroup matrix multiply) for TF32 products with an f32
// accumulator: A from registers, B from 128-byte-swizzled shared memory,
// both K-major (TF32 wgmma transposes neither).  Used by the dense graph
// GEMM (stgcn_graph_gemm.cu); written to serve any f32 GEMM that forms its
// products in 3xTF32 (tconv_mma.cuh's split: each operand a into big =
// rna_tf32(a) and small = rna_tf32(a - big), three products, small terms
// first).  The TMA loads and mbarriers that feed it are wgmma_bf16.cuh's,
// which move bytes and care for no element type.
//
// B operand, K-major, 128-byte swizzle: each of the N rows holds 32 f32
// along k (128 bytes); 16-byte chunk q of row r is stored at chunk
// q ^ (r & 7), and an 8-row atom of 1024 bytes starts on a 1024-byte
// boundary.  The descriptor's SBO is the stride of the atoms (1024 bytes);
// LBO is unused for a swizzled K-major operand (1, as CUTLASS sets it).
// The k8 step s of a 32-deep row starts 32 * s bytes into the row: the
// hardware applies the swizzle to the address it forms.  A TMA box of 32
// f32 x rows, loaded with CU_TENSOR_MAP_SWIZZLE_128B, lands in this layout.
//
// A operand from registers, m64nNk8 in TF32: warp w of the warpgroup holds
// rows 16w .. 16w + 15, as mma.sync.m16n8k8's A fragment (g = lane / 4,
// c = lane % 4): a[0] (row g, k c), a[1] (g + 8, c), a[2] (g, c + 4),
// a[3] (g + 8, c + 4), each a TF32 value in f32 bits (low 13 bits zero).
// (cute/atom/mma_traits_sm90_gmma.hpp: ALayout_64x8.)
//
// Accumulator fragment of m64nNk8 (per warp w, g, c as above): d[i] is row
// 16w + g + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2c + (i & 1).
//
// The product runs asynchronously: fence() before an mma that reads
// registers the threads wrote since (the accumulator, the A fragment),
// commit() after a batch, wait<n>() for all but n batches.  Neither the
// accumulator nor the A fragment may change until the wait; fence_operand
// (wgmma_bf16.cuh) pins every read of a result after the wait.

#pragma once

#include <cstdint>

#include "tconv_mma.cuh"
#include "wgmma_bf16.cuh"

namespace wgmma_tf32 {

using tconv::split;
using wgmma_bf16::commit;
using wgmma_bf16::fence;
using wgmma_bf16::fence_operand;
using wgmma_bf16::wait;

// B: K-major rows of 32 f32, 8-row atoms 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_b(uint32_t smem_addr) {
  return wgmma_bf16::desc_sw128(smem_addr, 16, 1024);
}

// Float offset of element (r, k) of a tile of 32-f32 rows in the 128-byte
// swizzle, the tile starting on a 1024-byte boundary.
__device__ __forceinline__ int sw128_index(int r, int k) {
  return r * 32 + (((k >> 2) ^ (r & 7)) << 2) + (k & 3);
}

// d (64 x 128 of the warpgroup, f32) = A (64 x 8, registers) @ B (128 x 8, K-major in shared
// memory) + (scale_d ? d : 0), every product in TF32.
__device__ __forceinline__ void mma_m64n128k8(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 192 of the warpgroup, f32) = A (64 x 8, registers) @ B (192 x 8, K-major in shared
// memory) + (scale_d ? d : 0), every product in TF32.
__device__ __forceinline__ void mma_m64n192k8(float (&d)[96], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// m64nNk8 for the widths the kernels use.
template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  static_assert(N == 128 || N == 192, "m64nNk8 is written out for N = 128 and 192");
  if constexpr (N == 128) {
    mma_m64n128k8(d, a, b, scale_d);
  } else {
    mma_m64n192k8(d, a, b, scale_d);
  }
}

}  // namespace wgmma_tf32
