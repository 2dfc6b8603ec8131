// What the selective-scan forward (selective_scan_fwd.cu) and backward
// (selective_scan_bwd.cu) kernels share: the thread layout, the chunk
// length, and the exponential.
//
// A block owns DT channels of one batch row; each channel's N states live
// in LPC neighbouring lanes, NPT states a lane.  The sequence is walked in
// chunks of TL steps.  TL is also the spacing of the chunk-entry states
// h_in that the forward writes for the backward: chunk c (natural order)
// covers steps [chunk_start(c), chunk_start(c) + TL), and h_in[b, c] is the
// state entering it in the scan's direction (from the left for the forward
// direction, from the right for the reverse one).  The reverse direction
// aligns its chunks to the end of the sequence, so its chunk 0 may start
// before step 0.  ops/selective_scan.py reads N, DT and TL from this file
// (the literals of `constexpr int NAME = value;`) to size h_in and the
// backward's partial sums: they are stated here and nowhere else.

#pragma once

#include <cuda_bf16.h>

namespace sscan {

constexpr int N = 16;          // states per channel (d_state)
constexpr int NPT = 4;         // states per thread
constexpr int LPC = N / NPT;   // lanes per channel
constexpr int DT = 16;         // channels per block
constexpr int NT = DT * LPC;   // threads per block
constexpr int TL = 64;         // steps per chunk, and the spacing of h_in

constexpr float LOG2E = 1.4426950408889634f;

static_assert(NPT == 4 && LPC == 4 && NT == 64,
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

}  // namespace sscan
