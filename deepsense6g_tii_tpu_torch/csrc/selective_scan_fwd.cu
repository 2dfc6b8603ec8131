// Selective-scan forward for Hopper (sm_90a): the Mamba recurrence
//
//   h_t = exp(dt_t * A[d,n]) * h_{t-1} + (dt_t * u_t) * B_t[n]   (h_{-1} = 0)
//   y_t = sum_n h_t[d,n] * C_t[n]                                 (f32)
//
// per batch row b and channel d, left to right, or right to left (t+1 in
// place of t-1) for the reverse direction.  Writes y (b, L, d) and the final
// state h_out (b, n, d), both f32.  D * u is the caller's.
//
// Replaces: deepsense6g_tii_tpu/ops/selective_scan.py::_fwd_kernel_chunked
// and ::_fwd_kernel_chunked_rev (launched by _scan_fwd_pallas), the TPU
// kernels on the MambaFuser's serving path: 64 launches per forward in the
// fusion stages (4 stages x 8 MambaBlocks x 2 directions) at L = 962 and
// d = 128, 256, 512, 1024, plus 3 in the TimeMamba head at L = 5, d = 1024.
// Under autograd it also writes the chunk-entry states h_in (b, n_chunks,
// n, d) f32, one per TL steps (selective_scan.cuh), from which the backward
// (selective_scan_bwd.cu) recomputes the states, as the TPU kernel writes
// hin_ref.  The store is a compile-time flag (SAVE): the serving path passes
// a null h_in and runs the instantiation without it, the same code as
// before h_in existed.
//
// Semantics kept from the TPU kernel: u, B and C are f32 or bf16 and are
// widened to f32 on load; dt and A are f32; the state and every sum are
// f32.  exp(dt*A) is computed as ex2(dt * (A*log2 e)) by the special-
// function unit: within ~1e-6 relative of expf wherever |dt*A| < 10, and
// below e^-10 elsewhere.  A is (d, n), or (G, d, n) with G parameter groups over equal slices
// of the batch (row b scans under A[b / (batch / G)]).  B and C may be
// column slices of a wider (b, L, k) tensor: the kernel takes their batch
// and row strides.  Not kept: the TPU's d % 128 rule and its padding of L
// to 128 on the host.  Any L and d are taken: a step outside [0, L) reads
// dt = 0, which leaves the state as it is (at most 7 such steps run per
// chunk), and channels past d are masked here.
//
// Bound on an H100 SXM at B = 8, L = 962, d = 1024, bf16 u/B/C: the kernel
// must move b*L*d*(2 + 4 + 4) bytes (u, dt, y) + 2*b*L*n*2 (B, C), about
// 79 MB, or 23.7 us at 3.35 TB/s; it does about 7 f32 operations per
// (t, d, n), 13 us at the 67 TFLOP/s CUDA-core rate, so bytes bound it.  Its
// b*L*d*n = 126 M exponentials go through the special-function units, 16 a
// clock per SM, which may make them the real limit (about 30 us).
//
// What the design does about it: every input is read once and y written
// once; the 16 states of a channel live in the registers of 4 neighbouring
// lanes (4 states each), so b*d*4 threads work (4096 at b = 1, d = 1024)
// and y_t is two warp shuffles; a block owns 16 channels of one batch row
// and walks L in chunks of 64 steps, staging u, dt, B, C and y of a chunk in
// shared memory with coalesced loads and stores, and prefetching the next
// chunk into registers while it runs the recurrence on the current one.
// The exp(dt*A) and the B*dt*u of a step do not depend on the state, so
// the inner loop computes them for 8 steps at a time, overlapped, and
// leaves one FMA per state and step on the serial chain; the 8 steps' y
// sums then go through the shuffles together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "selective_scan.cuh"

namespace {

using namespace sscan;

constexpr int SUB = 8;         // steps per group of the inner loop
constexpr int RU = TL * DT / NT;  // u/dt tile elements per thread
constexpr int RB = TL * N / NT;   // B/C tile elements per thread

static_assert(TL * DT % NT == 0 && TL * N % NT == 0 && TL % SUB == 0,
              "tile split");

// One chunk's inputs as this thread loads them: element r of the u/dt tile
// is (tt, cc) = ((tid + r*NT) / DT, (tid + r*NT) % DT); element r of the
// B/C tile is (tt, n) = ((tid + r*NT) / N, (tid + r*NT) % N).
template <typename T>
struct Chunk {
  T u[RU];
  float dt[RU];
  T b[RB];
  T c[RB];
};

template <typename T>
__device__ __forceinline__ void load_chunk(
    Chunk<T>& k, const T* __restrict__ u, const float* __restrict__ dt,
    const T* __restrict__ bm, const T* __restrict__ cm, size_t row0, int t0,
    int L, int d, int d0, long long bc_sl) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < RU; ++r) {
    const int idx = tid + r * NT, tt = idx / DT, cc = idx % DT;
    const int t = t0 + tt;
    const bool ok = t >= 0 && t < L && d0 + cc < d;
    const size_t off = (row0 + t) * (size_t)d + d0 + cc;
    k.u[r] = ok ? u[off] : T(0.f);
    k.dt[r] = ok ? dt[off] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int idx = tid + r * NT, tt = idx / N, n = idx % N;
    const int t = t0 + tt;
    const bool ok = t >= 0 && t < L;
    const long long off = (long long)t * bc_sl + n;
    k.b[r] = ok ? bm[off] : T(0.f);
    k.c[r] = ok ? cm[off] : T(0.f);
  }
}

template <typename T, bool REV, bool SAVE>
__global__ void __launch_bounds__(NT)
scan_fwd_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ bm,
                const T* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ h_out, float* __restrict__ h_in, int L,
                int d, int bg, long long bc_sb, long long bc_sl) {
  __shared__ float s_dt[TL][DT];
  __shared__ float s_dtu[TL][DT];  // dt * u, once per (step, channel)
  __shared__ float s_y[TL][DT];
  __shared__ __align__(16) float s_b[TL][N];
  __shared__ __align__(16) float s_c[TL][N];

  const int tid = threadIdx.x;
  const int c = tid / LPC, g = tid % LPC;  // channel in block, state group
  const int d0 = blockIdx.x * DT;
  const int b = blockIdx.y;
  const int ch = d0 + c;
  const bool valid = ch < d;
  const size_t row0 = (size_t)b * L;
  bm += b * bc_sb;
  cm += b * bc_sb;

  // A in base 2: exp(dt*A) = ex2(dt * A*log2(e)), one MUFU.EX2 a state
  float a2[NPT], h[NPT];
  const float* arow = A + ((size_t)(b / bg) * d + (valid ? ch : 0)) * N;
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    a2[j] = valid ? arow[g * NPT + j] * LOG2E : 0.f;
    h[j] = 0.f;
  }

  // visit k runs chunk ci(k) of the natural order, covering steps
  // [t0, t0 + TL); the reverse direction visits the chunks from the end,
  // so its last visit may start before 0
  const int nchunks = num_chunks(L);
  auto ci = [&](int k) { return REV ? nchunks - 1 - k : k; };

  Chunk<T> next;
  load_chunk(next, u, dt, bm, cm, row0, chunk_start(REV, ci(0), nchunks, L),
             L, d, d0, bc_sl);
  for (int k = 0; k < nchunks; ++k) {
    const int t0 = chunk_start(REV, ci(k), nchunks, L);
    if (SAVE && valid) {
      // the state entering the chunk, keyed by its natural index
      float* hrow = h_in + (((size_t)b * nchunks + ci(k)) * N + g * NPT) * d;
#pragma unroll
      for (int j = 0; j < NPT; ++j) hrow[(size_t)j * d + ch] = h[j];
    }
#pragma unroll
    for (int r = 0; r < RU; ++r) {
      const int idx = tid + r * NT;
      s_dt[idx / DT][idx % DT] = next.dt[r];
      s_dtu[idx / DT][idx % DT] = next.dt[r] * widen(next.u[r]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int idx = tid + r * NT;
      s_b[idx / N][idx % N] = widen(next.b[r]);
      s_c[idx / N][idx % N] = widen(next.c[r]);
    }
    __syncthreads();
    // the next chunk's loads are in flight while this one runs
    if (k + 1 < nchunks)
      load_chunk(next, u, dt, bm, cm, row0,
                 chunk_start(REV, ci(k + 1), nchunks, L), L, d, d0, bc_sl);

    // steps [lo, hi) of the tile are real; the loop runs them in groups of
    // SUB and rounds the count up: a padded step reads dt = 0 and u = 0,
    // so it leaves the state unchanged, and its y is never stored
    const int lo = max(0, -t0), hi = min(TL, L - t0);
    const int steps = (hi - lo + SUB - 1) / SUB * SUB;
    for (int i0 = 0; i0 < steps; i0 += SUB) {
      // everything but the state update first: SUB steps of loads and
      // exponentials are independent and overlap
      float da[SUB][NPT], db[SUB][NPT];
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        const int tt = REV ? hi - 1 - (i0 + s) : lo + i0 + s;
        const float dtv = s_dt[tt][c];
        const float dtu = s_dtu[tt][c];
        const float4 bv = *reinterpret_cast<const float4*>(&s_b[tt][g * NPT]);
        const float bj[NPT] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          da[s][j] = ex2(dtv * a2[j]);
          db[s][j] = dtu * bj[j];
        }
      }
      // the serial chain: one FMA per state and step
      float acc[SUB];
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        const int tt = REV ? hi - 1 - (i0 + s) : lo + i0 + s;
        const float4 cv = *reinterpret_cast<const float4*>(&s_c[tt][g * NPT]);
        const float cj[NPT] = {cv.x, cv.y, cv.z, cv.w};
        acc[s] = 0.f;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          h[j] = fmaf(da[s][j], h[j], db[s][j]);
          acc[s] = fmaf(h[j], cj[j], acc[s]);
        }
      }
      // y_t: the sum over the channel's 4 lanes, SUB shuffles in flight
#pragma unroll
      for (int s = 0; s < SUB; ++s)
        acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], 1);
#pragma unroll
      for (int s = 0; s < SUB; ++s)
        acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], 2);
      if (g == 0) {
#pragma unroll
        for (int s = 0; s < SUB; ++s)
          s_y[REV ? hi - 1 - (i0 + s) : lo + i0 + s][c] = acc[s];
      }
    }
    __syncthreads();

    for (int idx = tid; idx < TL * DT; idx += NT) {
      const int tt = idx / DT, cc = idx % DT, t = t0 + tt;
      if (t >= 0 && t < L && d0 + cc < d)
        y[(row0 + t) * (size_t)d + d0 + cc] = s_y[tt][cc];
    }
    __syncthreads();  // the next chunk overwrites the tiles
  }

  if (valid) {
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      h_out[((size_t)b * N + g * NPT + j) * d + ch] = h[j];
  }
}

template <typename T, bool REV, bool SAVE>
cudaError_t launch(const void* u, const void* dt, const void* A,
                   const void* bm, const void* cm, void* y, void* h_out,
                   void* h_in, int batch, int L, int d, int groups,
                   long long bc_sb, long long bc_sl, cudaStream_t stream) {
  const dim3 grid((d + DT - 1) / DT, batch);
  scan_fwd_kernel<T, REV, SAVE><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<float*>(y),
      static_cast<float*>(h_out), static_cast<float*>(h_in), L, d,
      batch / groups, bc_sb, bc_sl);
  return cudaGetLastError();
}

template <typename T, bool SAVE>
cudaError_t dispatch_dir(int reverse, const void* u, const void* dt,
                         const void* A, const void* bm, const void* cm,
                         void* y, void* h_out, void* h_in, int batch, int L,
                         int d, int groups, long long bc_sb, long long bc_sl,
                         cudaStream_t s) {
  return reverse ? launch<T, true, SAVE>(u, dt, A, bm, cm, y, h_out, h_in,
                                         batch, L, d, groups, bc_sb, bc_sl, s)
                 : launch<T, false, SAVE>(u, dt, A, bm, cm, y, h_out, h_in,
                                          batch, L, d, groups, bc_sb, bc_sl,
                                          s);
}

template <typename T>
cudaError_t dispatch(int reverse, const void* u, const void* dt,
                     const void* A, const void* bm, const void* cm, void* y,
                     void* h_out, void* h_in, int batch, int L, int d,
                     int groups, long long bc_sb, long long bc_sl,
                     cudaStream_t s) {
  return h_in ? dispatch_dir<T, true>(reverse, u, dt, A, bm, cm, y, h_out,
                                      h_in, batch, L, d, groups, bc_sb,
                                      bc_sl, s)
              : dispatch_dir<T, false>(reverse, u, dt, A, bm, cm, y, h_out,
                                       h_in, batch, L, d, groups, bc_sb,
                                       bc_sl, s);
}

}  // namespace

// u: (batch, L, d) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// dt: (batch, L, d) f32 contiguous; A: (groups, d, n) f32 contiguous;
// B, C: (batch, L, n) in u's dtype, element (b, t, k) at
// b*bc_batch_stride + t*bc_row_stride + k; y: (batch, L, d) f32;
// h_out: (batch, n, d) f32; h_in: null, or (batch, ceil(L / TL), n, d) f32
// for the chunk-entry states (TL in selective_scan.cuh).  n must be 16 and
// groups must divide batch.  Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch.
extern "C" int selective_scan_fwd(const void* u, const void* dt,
                                  const void* A, const void* B, const void* C,
                                  void* y, void* h_out, void* h_in,
                                  int batch, int L, int d, int n, int groups,
                                  long long bc_batch_stride,
                                  long long bc_row_stride, int is_bf16,
                                  int reverse, void* stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || d <= 0 || n != N ||
      groups <= 0 || batch % groups != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? dispatch<__nv_bfloat16>(reverse, u, dt, A, B, C, y,
                                             h_out, h_in, batch, L, d, groups,
                                             bc_batch_stride, bc_row_stride,
                                             s)
                   : dispatch<float>(reverse, u, dt, A, B, C, y, h_out, h_in,
                                     batch, L, d, groups, bc_batch_stride,
                                     bc_row_stride, s));
}
