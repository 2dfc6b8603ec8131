// Sequential selective-scan forward for Hopper (sm_90a): the same scan as
// selective_scan_fwd.cu,
//
//   h_t = exp(dt_t * A[d,n]) * h_{t-1} + (dt_t * u_t) * B_t[n]   (h_{-1} = 0)
//   y_t = sum_n h_t[d,n] * C_t[n]                                 (f32)
//
// left to right, per batch row b and channel d, by a separate and simpler
// design, so that the two kernels check each other.  Writes y (b, L, d) and
// the final state h_out (b, n, d), both f32, and, when h_in is not null,
// the chunk-entry states h_in (b, n_chunks, n, d) f32 at the spacing and
// keying of the chunked kernel (TL in selective_scan.cuh), so that the
// backward kernel (selective_scan_bwd.cu) takes them unchanged.  No reverse
// direction, as on the TPU.
//
// Replaces: deepsense6g_tii_tpu/ops/selective_scan.py::_fwd_kernel_sequential
// (launched by _scan_fwd_pallas for variant="sequential"), the TPU's step-
// by-step cross-check of the chunked forward: a fori_loop over the time
// steps of a 128-step chunk with the (n, 128) state carried in VMEM scratch.
//
// Semantics kept from the TPU kernel: u, B and C are f32 or bf16 and are
// widened to f32 on load; dt and A are f32; the state and every sum are
// f32; exp(dt*A) is ex2(dt * (A*log2 e)) by the special-function unit, the
// instruction the chunked kernels issue.  A is (d, n), or (G, d, n) with G
// parameter groups over equal slices of the batch.  B and C may be column
// slices of a wider (b, L, k) tensor (their batch and row strides are
// arguments).  Not kept: the TPU's d % 128 rule and its padding of L:
// any L and d are taken, only steps in [0, L) run, and channels past d are
// masked.
//
// Bound on an H100 SXM: the bytes of the chunked kernel (every input read
// once, y and h_out written once; 79 MB, 23.7 us at 3.35 TB/s for B = 8,
// L = 962, d = 1024, bf16 u/B/C), with b*L*d*n exponentials on the
// special-function units beside them.  What bounds this design is the
// serial chain: L steps, each a dependent exp-FMA per state.
//
// Design.  One thread owns one (batch row, channel) and keeps its 16
// states in registers; a block holds CH channels of one batch row.  The
// block walks L in chunks of TL steps: it stages dt, dt*u (each thread its
// own channel, coalesced across the block) and the B_t, C_t rows that all
// its threads share into shared memory, every load of the chunk in flight
// at once (without that, load latency took most of the time), then every thread runs the chunk's steps itself (B_t and C_t as
// 16-byte broadcast reads) and writes y_t: no warp shuffles and no split
// of a channel over lanes, unlike the chunked kernel.  Its y sum runs as
// four partial sums so that the per-step chain is 4 FMAs deep, not 16.
// Each thread issues 16 exponentials a step: at B*d threads the SFUs (16 a
// clock per SM) set the pace, about 128 clocks a step for a warp, if the
// steps overlap; the step loop is unrolled by 4 for that (one step at a
// time took ~380 clocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "selective_scan.cuh"

namespace {

using namespace sscan;

constexpr int CH = 64;  // channels (threads) per block

static_assert(TL * N % CH == 0, "B/C tile split");

template <typename T>
__global__ void __launch_bounds__(CH)
scan_seq_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ bm,
                const T* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ h_out, float* __restrict__ h_in, int L,
                int d, int bg, long long bc_sb, long long bc_sl) {
  __shared__ float s_dt[TL][CH];
  __shared__ float s_dtu[TL][CH];
  __shared__ __align__(16) float s_b[TL][N];
  __shared__ __align__(16) float s_c[TL][N];

  const int c = threadIdx.x;
  const int ch = blockIdx.x * CH + c;
  const bool valid = ch < d;
  const int b = blockIdx.y;
  const size_t row0 = (size_t)b * L;
  bm += b * bc_sb;
  cm += b * bc_sb;

  float a2[N], h[N];
  const float* arow = A + ((size_t)(b / bg) * d + (valid ? ch : 0)) * N;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a2[j] = valid ? arow[j] * LOG2E : 0.f;
    h[j] = 0.f;
  }

  const int nchunks = num_chunks(L);
  for (int k = 0; k < nchunks; ++k) {
    const int t0 = k * TL, steps = min(TL, L - t0);
    if (h_in != nullptr && valid) {
      float* hrow = h_in + ((size_t)b * nchunks + k) * N * d + ch;
#pragma unroll
      for (int j = 0; j < N; ++j) hrow[(size_t)j * d] = h[j];
    }
    // staging, in two passes: every load of the chunk into registers
    // first (addresses clamped into the tensor, so the loads need no
    // branch and are all in flight together), then the stores to shared
    // memory, steps past L as zeros
    float rdt[TL];
    T ru[TL];
#pragma unroll
    for (int tt = 0; tt < TL; ++tt) {
      const size_t off =
          (row0 + min(t0 + tt, L - 1)) * (size_t)d + (valid ? ch : 0);
      rdt[tt] = dt[off];
      ru[tt] = u[off];
    }
    T rb[TL * N / CH], rc[TL * N / CH];
#pragma unroll
    for (int r = 0; r < TL * N / CH; ++r) {
      const int idx = c + r * CH, tt = idx / N, n = idx % N;
      const long long off = (long long)min(t0 + tt, L - 1) * bc_sl + n;
      rb[r] = bm[off];
      rc[r] = cm[off];
    }
#pragma unroll
    for (int tt = 0; tt < TL; ++tt) {
      const bool ok = valid && tt < steps;
      s_dt[tt][c] = ok ? rdt[tt] : 0.f;
      s_dtu[tt][c] = ok ? rdt[tt] * widen(ru[tt]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < TL * N / CH; ++r) {
      const int idx = c + r * CH;
      s_b[idx / N][idx % N] = widen(rb[r]);
      s_c[idx / N][idx % N] = widen(rc[r]);
    }
    __syncthreads();

    // unrolled by 4 so that the next steps' exponentials, which do not
    // depend on the state, issue while this step's FMAs wait
#pragma unroll 4
    for (int tt = 0; tt < steps; ++tt) {
      const float dtv = s_dt[tt][c], dtu = s_dtu[tt][c];
      float bj[N], cj[N];
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {  // 16-byte broadcast reads
        const float4 bv = reinterpret_cast<const float4*>(s_b[tt])[q];
        const float4 cv = reinterpret_cast<const float4*>(s_c[tt])[q];
        bj[4 * q] = bv.x, bj[4 * q + 1] = bv.y, bj[4 * q + 2] = bv.z,
        bj[4 * q + 3] = bv.w;
        cj[4 * q] = cv.x, cj[4 * q + 1] = cv.y, cj[4 * q + 2] = cv.z,
        cj[4 * q + 3] = cv.w;
      }
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < N; ++j) {
        h[j] = fmaf(ex2(dtv * a2[j]), h[j], dtu * bj[j]);
        acc[j % 4] = fmaf(h[j], cj[j], acc[j % 4]);
      }
      if (valid)
        y[(row0 + t0 + tt) * (size_t)d + ch] = (acc[0] + acc[1]) +
                                               (acc[2] + acc[3]);
    }
    __syncthreads();  // the next chunk overwrites the tiles
  }

  if (valid) {
#pragma unroll
    for (int j = 0; j < N; ++j) h_out[((size_t)b * N + j) * d + ch] = h[j];
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* dt, const void* A,
                   const void* bm, const void* cm, void* y, void* h_out,
                   void* h_in, int batch, int L, int d, int groups,
                   long long bc_sb, long long bc_sl, cudaStream_t stream) {
  const dim3 grid((d + CH - 1) / CH, batch);
  scan_seq_kernel<T><<<grid, CH, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<float*>(y),
      static_cast<float*>(h_out), static_cast<float*>(h_in), L, d,
      batch / groups, bc_sb, bc_sl);
  return cudaGetLastError();
}

}  // namespace

// The arguments of selective_scan_fwd (selective_scan_fwd.cu) without the
// direction: u (batch, L, d) contiguous, f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); dt (batch, L, d) f32 contiguous; A (groups, d, n) f32
// contiguous; B, C (batch, L, n) in u's dtype, element (b, t, k) at
// b*bc_batch_stride + t*bc_row_stride + k; y (batch, L, d) f32; h_out
// (batch, n, d) f32; h_in null, or (batch, ceil(L / TL), n, d) f32.  n must
// be 16 and groups must divide batch.  Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch.
extern "C" int selective_scan_seq(const void* u, const void* dt,
                                  const void* A, const void* B, const void* C,
                                  void* y, void* h_out, void* h_in,
                                  int batch, int L, int d, int n, int groups,
                                  long long bc_batch_stride,
                                  long long bc_row_stride, int is_bf16,
                                  void* stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || d <= 0 || n != N ||
      groups <= 0 || batch % groups != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? launch<__nv_bfloat16>(u, dt, A, B, C, y, h_out, h_in,
                                           batch, L, d, groups,
                                           bc_batch_stride, bc_row_stride, s)
                   : launch<float>(u, dt, A, B, C, y, h_out, h_in, batch, L,
                                   d, groups, bc_batch_stride, bc_row_stride,
                                   s));
}
