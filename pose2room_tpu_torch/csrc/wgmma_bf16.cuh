// wgmma (Hopper's warpgroup matrix multiply) for bf16 operands from shared
// memory with an f32 accumulator: the shared-memory descriptors, the
// m64n128k16 product and its fences; and the TMA loads and mbarriers that
// feed it.  Used by kernel 5's bf16 leg
// (stgcn_sparse.cu); written to serve any GEMM whose operands sit in
// 128-byte-swizzled shared memory.
//
// Operand layouts (128-byte swizzle: 16-byte chunk q of a 128-byte row r is
// stored at chunk q ^ (r & 7); an 8-row atom of 1024 bytes must start on a
// 1024-byte boundary):
//   A, K-major: rows of 64 bf16 along k (tconv_bf16::swz64).  One atom is 8
//     rows; the descriptor's SBO is the stride of 8-row atoms (1024 bytes),
//     LBO is unused for a swizzled K-major operand (1, as CUTLASS sets it).
//     The k16 step s of a 64-deep row starts 32 * s bytes into the row: the
//     hardware applies the swizzle to the address it forms.
//   B, MN-major (k rows of n, transposed by the instruction's tnspB bit):
//     the 128 columns as two planes of 64 (128 bytes a k row); one atom is
//     8 k rows of one plane.  LBO is the stride between the planes (along
//     n), SBO the stride of 8-k-row atoms (1024 bytes).  The k16 step s
//     starts 16 * s rows (2048 * s bytes) down.
//   (cute/atom/mma_traits_sm90_gmma.hpp: make_gmma_desc.)
//
// Descriptor bits: [0, 14) start address >> 4, [16, 30) LBO >> 4, [32, 46)
// SBO >> 4, [49, 52) base offset (0: atoms 1024-aligned), [62, 64) layout
// (1: 128-byte swizzle).
//
// Accumulator fragment of m64nNk16 (per warp w of the warpgroup, g = lane /
// 4, c = lane % 4): d[i] is row 16w + g + 8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + 2c + (i & 1).
//
// The product runs asynchronously: wgmma.fence before an mma that writes
// registers the threads touched since, commit after a batch, wait<n> for
// all but n batches.  The compiler does not know that an mma's results
// arrive late, so fence_operand (an empty asm that "writes" the registers)
// pins every read of a result after the wait.  Operands written by TMA
// are in the async proxy already; ones written by threads (st.shared,
// cp.async) would need fence.proxy.async before a wgmma reads them.

#pragma once

#include <cstdint>

namespace wgmma_bf16 {

__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_addr >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// A: K-major 64-wide rows, 8-row atoms 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_a(uint32_t smem_addr) { return desc_sw128(smem_addr, 16, 1024); }

// B: MN-major, two 64-column planes plane_bytes apart, 8-k-row atoms 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_b(uint32_t smem_addr, uint32_t plane_bytes) {
  return desc_sw128(smem_addr, plane_bytes, 1024);
}

// d (64 rows x 128 columns of the warpgroup, f32) = A (64 x 16) @ B (16 x
// 128) + (accumulate ? d : 0); A K-major, B MN-major (tnspB = 1).
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
      "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// wait until at most N committed batches of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int K>
__device__ __forceinline__ void fence_operand(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// TMA loads into 128-byte-swizzled shared memory, completed on mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// make the barriers' init visible to the async proxy (TMA) before any use
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrive, and expect `bytes` more of TMA writes before the phase completes
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// box of a 2D tensor map at coordinates (c0 inner, c1 outer) -> shared dst,
// completing `bar`'s transaction count
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// a named barrier for `threads` threads (a multiple of 32), id 1..15
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace wgmma_bf16
