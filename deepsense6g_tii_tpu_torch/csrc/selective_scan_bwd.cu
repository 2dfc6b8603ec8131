// Selective-scan backward for Hopper (sm_90a): the gradients of
//
//   h_t = a_t * h_{t-1} + (dt_t * u_t) * B_t[n],  a_t = exp(dt_t * A[d,n])
//   y_t = sum_n h_t[d,n] * C_t[n]
//
// (t+1 in place of t-1 for the reverse direction) given dy (b, L, d) f32
// and the chunk-entry states h_in (b, n_chunks, n, d) f32 that the forward
// kernel wrote (selective_scan_fwd.cu).  Per batch row, channel d, state n,
// with ah_t = a_t * h_{t-1} and the gradient of the state
//
//   g_t = C_t[n] * dy_t + a_{t+1} * g_{t+1}      (against the scan)
//
// it writes du_t = dt_t sum_n g_t B_t (u's dtype), ddt_t = u_t sum_n g_t B_t
// + sum_n g_t ah_t A (f32), and f32 partial sums for the host to finish:
// dB_t[n] = sum_d g_t dt_t u_t and dC_t[n] = sum_d h_t dy_t over each
// block's 16 channels, (b, d/16, L, n), and dA[d,n] = sum_t g_t ah_t dt_t
// per batch row, (b, d, n).  The wrapper (ops/selective_scan.py) adds the
// partials over the channel blocks and over each parameter group's rows in
// f32 and rounds dB and dC to B's dtype once.
//
// Replaces: deepsense6g_tii_tpu/ops/selective_scan.py::_bwd_kernel_chunked
// and ::_bwd_kernel_chunked_rev (launched by _scan_bwd_pallas, summed by
// _bwd_rule), the TPU kernels of the MambaFuser's training step: 67
// launches per step (4 stages x 8 MambaBlocks x 2 branches at L = 962 and
// d = 128..1024, 3 TimeMamba scans at L = 5, d = 1024).
//
// Bound on an H100 SXM at B = 8, L = 962, d = 1024, bf16 u/B/C: it must
// read u, dt, dy, B, C and h_in and write du, ddt and the partials (dB and
// dC 31.5 MB each at 64 channel blocks), about 200 MB, or ~60 us at
// 3.35 TB/s; 2 * b*L*d*n = 252 M exponentials (the decays are computed in
// both sweeps) take ~60 us on the special-function units.
//
// Design.  A block owns 16 channels of one batch row, with 4 lanes per
// channel and 4 states per lane as in the forward, and walks the TL-step
// chunks in the gradient's direction (last to first for the forward scan,
// first to last for the reverse one).  For each chunk it loads the tile
// inputs into shared memory and the chunk's entry state from h_in, then
//   1. recomputes the chunk's states in the scan's direction, keeping
//      ah_t for every step in shared memory (TL x 64 threads x 4 states,
//      64 KB, so the block takes 100 KB of dynamic shared memory and an SM
//      holds two blocks) and reducing h_t * dy_t over the channels;
//   2. runs g back through the chunk in p = a * g space (g_t = C_t dy_t +
//      p_{t+1}, p_t = a_t g_t), carrying p from chunk to chunk, and forms
//      the five gradients while g_t is in registers.
// States are never re-derived backwards (h_{t-1} = (h_t - bb_t) / a_t is
// unstable where a_t is near 0); they are recomputed forwards from h_in
// with the forward's ex2, so they equal the forward's up to its rounding.
// Sums over the 4 lanes of a channel and over the 8 channels of a warp are
// warp shuffles (the channel sum is a reduce-scatter: 4 shuffles for the
// 16 states); the two warps of a block meet in shared memory.  Sums across
// blocks (dB, dC over channel blocks, dA over batch rows) are written as
// per-block partials and added on the host side: no atomics, so the result
// does not depend on the blocks' order.  Only steps in [0, L) are visited.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "selective_scan.cuh"

namespace {

using namespace sscan;

constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  float4 ah[TL][NT];                 // ah_t of each thread's 4 states
  float dt[TL][DT];
  float u[TL][DT];
  float dy[TL][DT];
  __align__(16) float b[TL][N];
  __align__(16) float c[TL][N];
  float db[NT / 32][TL][N];          // per-warp channel sums of g dt u
  float dc[NT / 32][TL][N];          // per-warp channel sums of h dy
};

// v[j] is state g*NPT + j of this lane's channel.  Returns the sum over the
// warp's 8 channels (lane bits 2-4) of state g*NPT + 2*b2 + b3, where b2
// and b3 are lane bits 2 and 3: each level keeps half of what it holds and
// sends the other half.
__device__ __forceinline__ float channel_sum(const float v[NPT], int lane) {
  const bool b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1;
  float k0 = b2 ? v[2] : v[0], k1 = b2 ? v[3] : v[1];
  const float s0 = b2 ? v[0] : v[2], s1 = b2 ? v[1] : v[3];
  k0 += __shfl_xor_sync(FULL, s0, 4);
  k1 += __shfl_xor_sync(FULL, s1, 4);
  float k = b3 ? k1 : k0;
  const float s = b3 ? k0 : k1;
  k += __shfl_xor_sync(FULL, s, 8);
  return k + __shfl_xor_sync(FULL, k, 16);
}

template <typename T, bool REV>
__global__ void __launch_bounds__(NT, 2)
scan_bwd_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ dy,
                const float* __restrict__ h_in, T* __restrict__ du,
                float* __restrict__ ddt, float* __restrict__ db_part,
                float* __restrict__ dc_part, float* __restrict__ da_part,
                int L, int d, int bg, long long bc_sb, long long bc_sl) {
  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / LPC, g = tid % LPC;  // channel in block, state group
  const int d0 = blockIdx.x * DT;
  const int b = blockIdx.y;
  const int ch = d0 + c;
  const bool valid = ch < d;
  const size_t row0 = (size_t)b * L;
  const int nchunks = num_chunks(L);
  bm += b * bc_sb;
  cm += b * bc_sb;
  // lanes 0-15 of each warp hold the channel sums, of state n_red
  const bool lead = lane < 16;
  const int n_red = g * NPT + 2 * ((lane >> 2) & 1) + ((lane >> 3) & 1);
  float* db_blk = db_part + ((size_t)b * gridDim.x + blockIdx.x) * L * N;
  float* dc_blk = dc_part + ((size_t)b * gridDim.x + blockIdx.x) * L * N;

  float av[NPT], a2[NPT], p[NPT], da[NPT];
  const float* arow = A + ((size_t)(b / bg) * d + (valid ? ch : 0)) * N;
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    av[j] = valid ? arow[g * NPT + j] : 0.f;
    a2[j] = av[j] * LOG2E;       // exp(dt*A) = ex2(dt * A*log2(e))
    p[j] = 0.f;                  // a_{t+1} g_{t+1} from the chunk before
    da[j] = 0.f;
  }

  for (int k = 0; k < nchunks; ++k) {
    const int ci = REV ? k : nchunks - 1 - k;
    const int t0 = chunk_start(REV, ci, nchunks, L);
    const int lo = max(0, -t0), hi = min(TL, L - t0);

    __syncthreads();  // the previous chunk is done with the tiles
    for (int idx = tid; idx < TL * DT; idx += NT) {
      const int tt = idx / DT, cc = idx % DT, t = t0 + tt;
      const bool ok = t >= 0 && t < L && d0 + cc < d;
      const size_t off = (row0 + t) * (size_t)d + d0 + cc;
      s.dt[tt][cc] = ok ? dt[off] : 0.f;
      s.u[tt][cc] = ok ? widen(u[off]) : 0.f;
      s.dy[tt][cc] = ok ? dy[off] : 0.f;
    }
    for (int idx = tid; idx < TL * N; idx += NT) {
      const int tt = idx / N, n = idx % N, t = t0 + tt;
      const bool ok = t >= 0 && t < L;
      const long long off = (long long)t * bc_sl + n;
      s.b[tt][n] = ok ? widen(bm[off]) : 0.f;
      s.c[tt][n] = ok ? widen(cm[off]) : 0.f;
    }
    __syncthreads();

    float h[NPT];
    const float* hrow = h_in + (((size_t)b * nchunks + ci) * N + g * NPT) * d;
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      h[j] = valid ? hrow[(size_t)j * d + ch] : 0.f;

    // 1. the chunk's states in the scan's direction; ah_t kept, dC summed
#pragma unroll 4
    for (int i = 0; i < hi - lo; ++i) {
      const int tt = REV ? hi - 1 - i : lo + i;
      const float dtv = s.dt[tt][c];
      const float dtu = dtv * s.u[tt][c];
      const float dyv = s.dy[tt][c];
      const float4 bv = *reinterpret_cast<const float4*>(&s.b[tt][g * NPT]);
      const float bj[NPT] = {bv.x, bv.y, bv.z, bv.w};
      float ah[NPT], hdy[NPT];
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        ah[j] = ex2(dtv * a2[j]) * h[j];
        h[j] = fmaf(dtu, bj[j], ah[j]);
        hdy[j] = h[j] * dyv;
      }
      s.ah[tt][tid] = make_float4(ah[0], ah[1], ah[2], ah[3]);
      const float sum = channel_sum(hdy, lane);
      if (lead) s.dc[warp][tt][n_red] = sum;
    }

    // 2. the gradient back through the chunk
#pragma unroll 4
    for (int i = 0; i < hi - lo; ++i) {
      const int tt = REV ? lo + i : hi - 1 - i;
      const float dtv = s.dt[tt][c];
      const float uv = s.u[tt][c];
      const float dyv = s.dy[tt][c];
      const float dtu = dtv * uv;
      const float4 bv = *reinterpret_cast<const float4*>(&s.b[tt][g * NPT]);
      const float4 cv = *reinterpret_cast<const float4*>(&s.c[tt][g * NPT]);
      const float4 ahv = s.ah[tt][tid];
      const float bj[NPT] = {bv.x, bv.y, bv.z, bv.w};
      const float cj[NPT] = {cv.x, cv.y, cv.z, cv.w};
      const float ahj[NPT] = {ahv.x, ahv.y, ahv.z, ahv.w};
      float gb = 0.f, gsa = 0.f, gdtu[NPT];
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const float gj = fmaf(cj[j], dyv, p[j]);   // g_t = C dy + p_{t+1}
        p[j] = ex2(dtv * a2[j]) * gj;               // p_t = a_t g_t
        gb = fmaf(gj, bj[j], gb);
        const float gah = gj * ahj[j];
        gsa = fmaf(gah, av[j], gsa);
        da[j] = fmaf(gah, dtv, da[j]);
        gdtu[j] = gj * dtu;
      }
      const float sum = channel_sum(gdtu, lane);
      if (lead) s.db[warp][tt][n_red] = sum;
      gb += __shfl_xor_sync(FULL, gb, 1);
      gsa += __shfl_xor_sync(FULL, gsa, 1);
      gb += __shfl_xor_sync(FULL, gb, 2);
      gsa += __shfl_xor_sync(FULL, gsa, 2);
      if (g == 0 && valid) {
        const size_t off = (row0 + t0 + tt) * (size_t)d + ch;
        du[off] = narrow<T>(dtv * gb);
        ddt[off] = fmaf(uv, gb, gsa);
      }
    }
    __syncthreads();

    // the block's dB and dC partials of the chunk: the two warps' sums
    for (int idx = tid; idx < TL * N; idx += NT) {
      const int tt = idx / N, n = idx % N;
      if (tt >= lo && tt < hi) {
        const size_t off = (size_t)(t0 + tt) * N + n;
        db_blk[off] = s.db[0][tt][n] + s.db[1][tt][n];
        dc_blk[off] = s.dc[0][tt][n] + s.dc[1][tt][n];
      }
    }
  }

  if (valid) {
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      da_part[((size_t)b * d + ch) * N + g * NPT + j] = da[j];
  }
}

template <typename T, bool REV>
cudaError_t launch(const void* u, const void* dt, const void* A,
                   const void* bm, const void* cm, const void* dy,
                   const void* h_in, void* du, void* ddt, void* db_part,
                   void* dc_part, void* da_part, int batch, int L, int d,
                   int groups, long long bc_sb, long long bc_sl,
                   cudaStream_t stream) {
  // above 48 KB, dynamic shared memory must be asked for (per device)
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<T, REV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((d + DT - 1) / DT, batch);
  scan_bwd_kernel<T, REV><<<grid, NT, sizeof(Smem), stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(dy),
      static_cast<const float*>(h_in), static_cast<T*>(du),
      static_cast<float*>(ddt), static_cast<float*>(db_part),
      static_cast<float*>(dc_part), static_cast<float*>(da_part), L, d,
      batch / groups, bc_sb, bc_sl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dir(int reverse, const void* u, const void* dt,
                         const void* A, const void* bm, const void* cm,
                         const void* dy, const void* h_in, void* du,
                         void* ddt, void* db_part, void* dc_part,
                         void* da_part, int batch, int L, int d, int groups,
                         long long bc_sb, long long bc_sl, cudaStream_t s) {
  return reverse ? launch<T, true>(u, dt, A, bm, cm, dy, h_in, du, ddt,
                                   db_part, dc_part, da_part, batch, L, d,
                                   groups, bc_sb, bc_sl, s)
                 : launch<T, false>(u, dt, A, bm, cm, dy, h_in, du, ddt,
                                    db_part, dc_part, da_part, batch, L, d,
                                    groups, bc_sb, bc_sl, s);
}

}  // namespace

// u: (batch, L, d) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// dt, dy: (batch, L, d) f32 contiguous; A: (groups, d, n) f32 contiguous;
// B, C: (batch, L, n) in u's dtype, element (b, t, k) at
// b*bc_batch_stride + t*bc_row_stride + k; h_in: (batch, n_chunks, n, d)
// f32 from selective_scan_fwd, n_chunks being ceil(L / TL).  Writes du
// (batch, L, d) in u's dtype, ddt (batch, L, d) f32, db_part and dc_part
// (batch, ceil(d / DT), L, n) f32 and da_part (batch, d, n) f32, every
// element (TL and DT in selective_scan.cuh).  n must be 16 and groups must
// divide batch.  Launches on `stream` without synchronising
// and returns cudaGetLastError().
extern "C" int selective_scan_bwd(const void* u, const void* dt,
                                  const void* A, const void* B, const void* C,
                                  const void* dy, const void* h_in, void* du,
                                  void* ddt, void* db_part, void* dc_part,
                                  void* da_part, int batch, int L, int d,
                                  int n, int groups,
                                  long long bc_batch_stride,
                                  long long bc_row_stride, int is_bf16,
                                  int reverse, void* stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || d <= 0 || n != N ||
      groups <= 0 || batch % groups != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? dispatch_dir<__nv_bfloat16>(
                         reverse, u, dt, A, B, C, dy, h_in, du, ddt, db_part,
                         dc_part, da_part, batch, L, d, groups,
                         bc_batch_stride, bc_row_stride, s)
                   : dispatch_dir<float>(
                         reverse, u, dt, A, B, C, dy, h_in, du, ddt, db_part,
                         dc_part, da_part, batch, L, d, groups,
                         bc_batch_stride, bc_row_stride, s));
}
