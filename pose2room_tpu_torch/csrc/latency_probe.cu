// Instruction latencies on the card, for the latency floor of csrc/fps.cu.
//
// Not a kernel of the model's path: chip_smoke.py and
// scripts/torch_fps_variants.py build it beside the kernels and read from it
// the latency of each step on FPS's critical path, as dependent chains timed
// with clock64() by one warp, and the SM clock the chains ran at.
//
// Ops (the index of each in the output, cycles per op):
//   0 LDS.32    ld.shared.u32, each address the value the last load returned
//   1 LDS.128   ld.shared.v4.u32, likewise
//   2 FADD      add.rn.f32
//   3 FMUL      mul.rn.f32
//   4 FMNMX     min.f32
//   5 IMNMX     max.s32
//   6 SHFL      shfl.sync.bfly.b32 (offset 1)
//   7 REDUX     redux.sync.max.s32
//   8 BAR       bar.sync 0 in a block of four warps (one per sub-partition), each barrier the next's only
//               dependence: the cost of a barrier that all warps reach together
//   9 FADD x8   add.rn.f32 on eight independent chains: one warp's issue interval
//  10 FMNMX x8  min.f32 likewise

#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 64;
constexpr int kRing = 64;  // entries of the shared-memory pointer chain

__device__ __forceinline__ long long now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// One dependent chain of iters * kUnroll ops of kind Op; returns its cycles.
// The min / max chains alternate two operands that the compiler cannot
// compare, so no step folds into the last.
template <int Op>
__device__ __forceinline__ long long chain(int iters, unsigned ring0, unsigned& acc) {
  unsigned u = ring0 + threadIdx.x % 2 * 16;
  float f = 1.f + threadIdx.x;
  const float g = 1e-7f * (threadIdx.x + 1), h = 2e-7f * (threadIdx.x + 1);
  int k = threadIdx.x;
  const int a = threadIdx.x / 3, b = threadIdx.x / 5;
  float fa[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) fa[c] = f + c;
  const long long t0 = now();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < kUnroll; r += 2) {
      if constexpr (Op == 0) {
        asm volatile("ld.shared.u32 %0, [%0];\n\tld.shared.u32 %0, [%0];" : "+r"(u)::"memory");
      } else if constexpr (Op == 1) {
        unsigned x, y, z;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%0];\n\tld.shared.v4.u32 {%0, %1, %2, %3}, [%0];"
                     : "+r"(u), "=r"(x), "=r"(y), "=r"(z)::"memory");
      } else if constexpr (Op == 2) {
        asm volatile("add.rn.f32 %0, %0, %1;\n\tadd.rn.f32 %0, %0, %2;" : "+f"(f) : "f"(g), "f"(h));
      } else if constexpr (Op == 3) {
        asm volatile("mul.rn.f32 %0, %0, %1;\n\tmul.rn.f32 %0, %0, %2;" : "+f"(f) : "f"(g), "f"(h));
      } else if constexpr (Op == 4) {
        asm volatile("min.f32 %0, %0, %1;\n\tmin.f32 %0, %0, %2;" : "+f"(f) : "f"(g), "f"(h));
      } else if constexpr (Op == 5) {
        asm volatile("max.s32 %0, %0, %1;\n\tmax.s32 %0, %0, %2;" : "+r"(k) : "r"(a), "r"(b));
      } else if constexpr (Op == 6) {
        asm volatile("shfl.sync.bfly.b32 %0, %0, 1, 0x1f, 0xffffffff;\n\t"
                     "shfl.sync.bfly.b32 %0, %0, 1, 0x1f, 0xffffffff;" : "+r"(k));
      } else if constexpr (Op == 9) {
        asm volatile("add.rn.f32 %0, %0, %2;\n\tadd.rn.f32 %1, %1, %2;" : "+f"(fa[r % 8]), "+f"(fa[r % 8 + 1]) : "f"(g));
      } else if constexpr (Op == 10) {
        asm volatile("min.f32 %0, %0, %2;\n\tmin.f32 %1, %1, %3;" : "+f"(fa[r % 8]), "+f"(fa[r % 8 + 1]) : "f"(g), "f"(h));
      } else if constexpr (Op == 7) {
        asm volatile("redux.sync.max.s32 %0, %0, 0xffffffff;\n\tredux.sync.max.s32 %0, %0, 0xffffffff;" : "+r"(k));
      } else {
        asm volatile("bar.sync 0;\n\tbar.sync 0;" ::: "memory");
      }
    }
  }
  const long long t1 = now();
  float sum = f;
#pragma unroll
  for (int c = 0; c < 8; ++c) sum += fa[c];
  acc += u + __float_as_uint(sum) + static_cast<unsigned>(k);
  return t1 - t0;
}

template <int Op>
__device__ __forceinline__ void run(int iters, unsigned ring0, unsigned& acc, long long* cycles) {
  if (Op == 8 || threadIdx.x < 32) {
    const long long t = chain<Op>(iters, ring0, acc);
    if (threadIdx.x == 0) cycles[Op] = t;
  }
  __syncthreads();
}

__global__ void chains_kernel(int iters, long long* cycles, unsigned* sink) {
  __shared__ __align__(16) unsigned ring[kRing * 4];
  const unsigned ring0 = static_cast<unsigned>(__cvta_generic_to_shared(ring));
  for (int e = threadIdx.x; e < kRing; e += blockDim.x)
    for (int q = 0; q < 4; ++q) ring[4 * e + q] = ring0 + 16 * ((e + 1) % kRing);
  __syncthreads();
  unsigned acc = 0;
  run<0>(iters, ring0, acc, cycles);
  run<1>(iters, ring0, acc, cycles);
  run<2>(iters, ring0, acc, cycles);
  run<3>(iters, ring0, acc, cycles);
  run<4>(iters, ring0, acc, cycles);
  run<5>(iters, ring0, acc, cycles);
  run<6>(iters, ring0, acc, cycles);
  run<7>(iters, ring0, acc, cycles);
  run<8>(iters, ring0, acc, cycles);
  run<9>(iters, ring0, acc, cycles);
  run<10>(iters, ring0, acc, cycles);
  if (threadIdx.x == 0) *sink = acc;
}

// SM cycles and nanoseconds of %globaltimer over one spin of `spin` cycles.
__global__ void clock_kernel(long long spin, long long* out) {
  long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = now();
  long long c1 = c0;
  while (c1 - c0 < spin) c1 = now();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[0] = c1 - c0;
  out[1] = g1 - g0;
}

}  // namespace

// cycles: 11 int64, the cycles of iters * 64 ops of each; sink: 1 uint32.
extern "C" int p2r_latency_chains(long long* cycles, unsigned* sink, int iters, void* stream) {
  chains_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(iters, cycles, sink);
  return static_cast<int>(cudaGetLastError());
}

// out: 2 int64, SM cycles and globaltimer nanoseconds of one spin.
extern "C" int p2r_sm_clock(long long spin, long long* out, void* stream) {
  clock_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(spin, out);
  return static_cast<int>(cudaGetLastError());
}
