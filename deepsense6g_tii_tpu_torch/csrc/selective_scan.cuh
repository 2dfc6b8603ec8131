// What the selective-scan forward (selective_scan_fwd.cu) and backward
// (selective_scan_bwd.cu) kernels share: the lane layout, the chunk length,
// the exponential and the carry pass.
//
// Each channel's N states live in LPC neighbouring lanes, NPT states a
// lane.  The sequence is cut into chunks of TL steps.  TL is also the
// spacing of the chunk-entry states h_in that the forward writes for the
// backward: chunk c (natural order) covers steps [chunk_start(c),
// chunk_start(c) + TL), and h_in[b, c] is the state entering it in the
// scan's direction (from the left for the forward direction, from the right
// for the reverse one).  The reverse direction aligns its chunks to the end
// of the sequence, so its chunk 0 may start before step 0.  A block of the
// backward owns DT channels of one chunk of one batch row, and writes its
// dB/dC partial sums per DT channels.  ops/selective_scan.py reads N, DT and
// TL from this file (the literals of `constexpr int NAME = value;`) to size
// h_in and the backward's partial sums: they are stated here and nowhere
// else.
//
// Chunks (or groups of chunks) run in parallel.  A pass that runs each
// segment from a zero carry gives the segment's own contribution `loc` and
// the sum of its dt; scan_carry_kernel then walks the few segments of each
// (row, channel, state) in order and writes the carry entering each:
//
//   out[s] = H,  H = exp(A * sum(dt over s)) * H + loc[s]   (H = 0 first)
//
// which is exact for a linear recurrence whose decays are exp(dt_t * A):
// the decays of a segment multiply to the exponential of its dt sum.  The
// forward carries states this way, the backward the gradient p = a * g.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sscan {

constexpr int N = 16;          // states per channel (d_state)
constexpr int NPT = 4;         // states per thread
constexpr int LPC = N / NPT;   // lanes per channel
constexpr int TL = 64;         // steps per chunk, and the spacing of h_in
constexpr int DT = 32;         // channels per block of the backward
constexpr int CARRY_NT = 256;  // threads per block of the carry pass

constexpr float LOG2E = 1.4426950408889634f;

static_assert(NPT == 4 && LPC == 4,
              "the lane reductions assume 4 lanes of 4 states per channel");

__host__ __device__ __forceinline__ int num_chunks(int L) {
  return (L + TL - 1) / TL;
}

// first step of chunk c in natural order
__device__ __forceinline__ int chunk_start(bool rev, int c, int nchunks,
                                           int L) {
  return rev ? L - (nchunks - c) * TL : c * TL;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 2^x by the special-function unit (MUFU.EX2), relative error ~2^-22;
// subnormal results flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The carry pass over nseg segments: loc and out are (batch, nseg, N, d),
// sdt is (batch, nseg, d), A is (groups, d, N) with batch / groups = bg
// rows a group.  One thread per (row, state, channel), consecutive threads
// on consecutive channels; segments are visited from 0 up (ascending) or
// from nseg - 1 down.  The last segment visited is not read.
__global__ void __launch_bounds__(CARRY_NT)
scan_carry_kernel(const float* __restrict__ loc,
                  const float* __restrict__ sdt, const float* __restrict__ A,
                  float* __restrict__ out, int batch, int nseg, int d, int bg,
                  int ascending) {
  const long long e = (long long)blockIdx.x * CARRY_NT + threadIdx.x;
  if (e >= (long long)batch * N * d) return;
  const int ch = (int)(e % d);
  const int n = (int)((e / d) % N);
  const int b = (int)(e / ((long long)N * d));
  const float a2 = A[((size_t)(b / bg) * d + ch) * N + n] * LOG2E;
  float h = 0.f;
  for (int k = 0; k < nseg; ++k) {
    const int s = ascending ? k : nseg - 1 - k;
    const size_t row = (size_t)b * nseg + s;
    out[(row * N + n) * d + ch] = h;
    if (k + 1 < nseg)
      h = fmaf(ex2(a2 * sdt[row * d + ch]), h, loc[(row * N + n) * d + ch]);
  }
}

inline cudaError_t launch_carry(const float* loc, const float* sdt,
                                const float* A, float* out, int batch,
                                int nseg, int d, int bg, bool ascending,
                                cudaStream_t stream) {
  const long long total = (long long)batch * N * d;
  const unsigned blocks = (unsigned)((total + CARRY_NT - 1) / CARRY_NT);
  scan_carry_kernel<<<blocks, CARRY_NT, 0, stream>>>(
      loc, sdt, A, out, batch, nseg, d, bg, ascending ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace sscan
