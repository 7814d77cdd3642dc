// Furthest-point sampling, f32 -> int32 indices, Hopper (sm_90a).
//
// Replaces: pose2room_tpu/ops/sampling.py:_fps_kernel (Pallas, TPU), reached
// through _fps_pallas / furthest_point_sample from ProposalNet's vote_fps.
//
// Semantics (bit-exact with the plain PyTorch version and with JAX _fps_xla):
//   * pick 0 is index 0; the running min-distance starts at 1e10;
//   * points with x*x + y*y + z*z <= 1e-3 are never candidates (score -1);
//   * each further pick is the argmax of the running min-distance, ties going
//     to the lowest index.
// Squared distances are written as ((dx*dx + dy*dy) + dz*dz) with explicit
// round-to-nearest intrinsics, so nvcc cannot contract them into FMAs and
// change the rounding that decides near-ties.
//
// What bounds it on an H100: neither bytes (6 KB a clip) nor operations
// (~0.5 MFLOP a clip) but latency: npoint - 1 dependent argmax steps per
// clip, each no shorter than one shared-memory load of the last pick, the
// five dependent float ops of a distance and its min (sub, mul, add, add,
// min), log2(points a lane) levels of a lane's argmax and one cross-lane
// reduction.  chip_smoke.py measures those latencies with
// csrc/latency_probe.cu and prints that floor beside the kernel's time.
//
// Design: a block of kWarps warps per clip, each lane holding kPer points in
// registers in a blocked layout (thread t holds indices [kPer t, kPer t +
// kPer)), so lane order and warp order are index order.  A point that is
// never a candidate keeps a running min of -1 (min(-1, d) = -1 for d >= 0),
// so the score is the running min itself.  Each pick: one broadcast LDS.128
// of the last pick's coordinates from shared memory, kPer distance updates,
// a tree argmax in the lane, two redux.sync steps across the warp (the max
// of the score's bits, then the least index among the lanes holding it),
// each warp's winner into a double-buffered slot, one barrier, and every
// warp's own tree over the slots, so no second barrier and no broadcast.
// One thread stores each pick as it is made.  At N <= 512: four warps of 4
// points, one warp an SM sub-partition.  One warp of 16 points needs no
// barrier but must issue ~190 instructions a pick; more than four warps
// put more slot work on the chain (scripts/torch_fps_variants.py times
// both).  8 points a lane at N <= 1024, and 8 warps of 8 at N <= 2048.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// A score is a running min-distance (a sum of squares, never -0, at most
// 1e10) or -1: on that set the order of the bits read as a signed int is the
// order of the floats (-1.0f's bits are a negative int, +0.0f's are 0), so
// integer max and compare rank scores with no key map.
__device__ __forceinline__ int score_key(float s) { return __float_as_int(s); }

// The argmax of n (key, index) pairs held in ascending index order, as a
// tree whose left operand always holds the lower indices: a strict '>'
// keeps the lowest index on ties.
template <int n>
__device__ __forceinline__ int2 tree_argmax(int2 (&v)[n]) {
#pragma unroll
  for (int s = 1; s < n; s *= 2)
#pragma unroll
    for (int m = 0; m < n; m += 2 * s)
      if (v[m + s].x > v[m].x) v[m] = v[m + s];
  return v[0];
}

// The warp's best (key, index): the largest key, ties to the lowest index.
__device__ __forceinline__ int2 warp_argmax(int key, int idx) {
  const int best = __reduce_max_sync(kFull, key);
  const unsigned i = __reduce_min_sync(kFull, key == best ? static_cast<unsigned>(idx) : UINT_MAX);
  return make_int2(best, static_cast<int>(i));
}

template <int kWarps, int kPer>
__global__ void __launch_bounds__(32 * kWarps)
fps_kernel(const float* __restrict__ xyz, int N, int npoint, int* __restrict__ out) {
  extern __shared__ float4 pts[];  // [N] (x, y, z, 0)
  __shared__ int2 slots[2 * kWarps];  // each warp's winner, double-buffered by pick

  const int b = blockIdx.x;
  const float* src = xyz + static_cast<size_t>(b) * N * 3;
  const int base = threadIdx.x * kPer;  // this lane's points: [base, base + kPer)
  float px[kPer], py[kPer], pz[kPer], mind[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = base + m;
    px[m] = py[m] = pz[m] = 0.f;
    if (i < N) {
      px[m] = src[3 * i];
      py[m] = src[3 * i + 1];
      pz[m] = src[3 * i + 2];
    }
  }
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = base + m;
    const float n2 = __fadd_rn(__fadd_rn(__fmul_rn(px[m], px[m]), __fmul_rn(py[m], py[m])),
                               __fmul_rn(pz[m], pz[m]));
    mind[m] = i < N && n2 > 1e-3f ? 1e10f : -1.f;
    if (i < N) pts[i] = make_float4(px[m], py[m], pz[m], 0.f);
  }
  int* dst = out + static_cast<size_t>(b) * npoint;
  if (threadIdx.x == 0) dst[0] = 0;
  __syncthreads();

  int2* const own = slots + threadIdx.x / 32;  // this warp's slot of the first buffer
  int old = 0;
  for (int j = 1; j < npoint; ++j) {
    const float4 o = pts[old];
    int2 lane[kPer];  // (key, index) of each of this lane's points
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const float dx = __fsub_rn(px[m], o.x);
      const float dy = __fsub_rn(py[m], o.y);
      const float dz = __fsub_rn(pz[m], o.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      mind[m] = fminf(mind[m], d);
      lane[m] = make_int2(score_key(mind[m]), base + m);
    }
    const int2 l = tree_argmax(lane);
    const int buf = (j & 1) * kWarps;
    own[buf] = warp_argmax(l.x, l.y);  // every lane stores its warp's winner: no branch
    __syncthreads();
    int2 all[kWarps];  // warps ascend in index, so the slots do too
#pragma unroll
    for (int v = 0; v < kWarps; ++v) all[v] = slots[buf + v];
    old = tree_argmax(all).y;
    if (threadIdx.x == 0) dst[j] = old;
  }
}

template <int kWarps, int kPer>
int launch(const float* xyz, int* out, int B, int N, int npoint, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(N) * sizeof(float4);
  fps_kernel<kWarps, kPer><<<B, 32 * kWarps, smem, stream>>>(xyz, N, npoint, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz: (B, N, 3) contiguous f32; out: (B, npoint) int32.
// 1 <= npoint <= N <= 2048.  Returns the cudaError_t of the launch.
extern "C" int p2r_fps_f32(const float* xyz, int* out, int B, int N, int npoint,
                           void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (N <= 512) return launch<4, 4>(xyz, out, B, N, npoint, s);
  if (N <= 1024) return launch<4, 8>(xyz, out, B, N, npoint, s);
  return launch<8, 8>(xyz, out, B, N, npoint, s);
}
