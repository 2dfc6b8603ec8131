// Elementwise-rate calibration chain for Hopper (sm_90a): each element of
// x goes through k dependent steps,
//
//   mul:  x = x * c                 (c = 1.0000001f: one FMUL a step)
//   exp:  x = 2^(x * c)             (c = -0.41421f * log2(e): one FMUL and
//                                    one MUFU.EX2 a step, exp(-0.41421 x))
//
// and is written to out.  Templated on k and on the step, so that every
// instantiation issues exactly k FMULs, or k FMULs and k MUFU.EX2, per
// element and nothing else on the FP32 pipes.  The k steps run as a loop of
// k / U bodies of U steps: `cuobjdump -sass` of the built library shows
// 16 * U of each in every instantiation (16 elements a thread).  Unrolled
// in full, the k = 1024 chain is 256 KB of code, more than the instruction
// caches hold, and ran at 73% of the FMUL rate (NVIDIA H100 80GB HBM3,
// 700 W); the loop adds 2-3 integer instructions per 16 * U FMULs.
// The multiply is __fmul_rn, an IEEE f32 multiply that the compiler
// neither contracts nor reassociates, so the mul chain equals the plain
// version element for element.  The exponential is sscan::ex2
// (selective_scan.cuh), the instruction the scan kernels issue, so the
// calibrated exp price is the one they pay.
//
// Replaces: tools/scan_roofline.py::_chain_kernel (launched by calibrate()
// through pl.pallas_call), the TPU's k-multiply and k-exp chains over
// (4096, 8, 1024) f32 in (32, 8, 1024) blocks, from which the tool derives
// the chip's elementwise rates.
//
// Bound on an H100 SXM: 8 bytes an element (read and write) at 3.35 TB/s
// against k FMULs an element at 132 SMs x 128 lanes x the SM clock
// (~33.5e12 a second at 1.98 GHz; the data sheet's 67 TFLOP/s counts an
// FMA as two), or k exponentials at 16 a clock per SM (~4.2e12 a second).
// Arithmetic leads only past k ~ 80 multiplies or ~ 10 exponentials, so
// the chain lengths below are chosen for this card: each takes at least
// ~3x the time of its bytes, and the difference of two lengths is the
// arithmetic alone.  (The TPU tool's 8/72 multiplies and 4/20 exps would
// be memory-bound here.)
//
// Design: 16-byte loads and stores, neighbouring threads on neighbouring
// float4s; each thread carries V float4s, 16 independent chains, so that
// the pipes and not the 4-cycle FMUL latency (or MUFU's) are the limit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "selective_scan.cuh"

namespace {

// the chain lengths the library holds (the wrapper in
// tools/scan_roofline.py reads these literals)
constexpr int MUL_K_LO = 256;
constexpr int MUL_K_HI = 1024;
constexpr int EXP_K_LO = 32;
constexpr int EXP_K_HI = 128;

constexpr int V = 4;          // float4s per thread
constexpr int THREADS = 256;  // threads per block
constexpr int U = 16;         // steps per loop body

template <int K, bool EXP>
__global__ void __launch_bounds__(THREADS)
chain_kernel(const float4* __restrict__ x, float4* __restrict__ out,
             long long n4, float c) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long i0 = (long long)blockIdx.x * THREADS + threadIdx.x;
  float v[V][4];
#pragma unroll
  for (int r = 0; r < V; ++r) {
    const long long i = i0 + r * stride;
    const float4 a = i < n4 ? x[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    v[r][0] = a.x;
    v[r][1] = a.y;
    v[r][2] = a.z;
    v[r][3] = a.w;
  }
  static_assert(K % U == 0, "k must be a multiple of the loop body");
#pragma unroll (U)
  for (int s = 0; s < K; ++s) {
#pragma unroll
    for (int r = 0; r < V; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m = __fmul_rn(v[r][e], c);
        v[r][e] = EXP ? sscan::ex2(m) : m;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < V; ++r) {
    const long long i = i0 + r * stride;
    if (i < n4) out[i] = make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
  }
}

template <int K, bool EXP>
cudaError_t launch(const void* x, void* out, long long n4, float c,
                   cudaStream_t stream) {
  const long long blocks = (n4 + (long long)THREADS * V - 1) / (THREADS * V);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  chain_kernel<K, EXP><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), n4, c);
  return cudaGetLastError();
}

}  // namespace

// x, out: n4 float4s (4 * n4 f32), 16-byte aligned.  k must be MUL_K_LO or
// MUL_K_HI (use_exp = 0) or EXP_K_LO or EXP_K_HI (use_exp = 1); c is the
// multiplier of each step.  Launches on `stream` without synchronising and
// returns cudaGetLastError() of the launch.
extern "C" int scan_roofline_chain(const void* x, void* out, long long n4,
                                   int k, int use_exp, float c,
                                   void* stream) {
  if (n4 <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!use_exp && k == MUL_K_LO)
    return (int)launch<MUL_K_LO, false>(x, out, n4, c, s);
  if (!use_exp && k == MUL_K_HI)
    return (int)launch<MUL_K_HI, false>(x, out, n4, c, s);
  if (use_exp && k == EXP_K_LO)
    return (int)launch<EXP_K_LO, true>(x, out, n4, c, s);
  if (use_exp && k == EXP_K_HI)
    return (int)launch<EXP_K_HI, true>(x, out, n4, c, s);
  return (int)cudaErrorInvalidValue;
}
