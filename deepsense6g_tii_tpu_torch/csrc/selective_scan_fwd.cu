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
// hin_ref.  The store is a compile-time flag: the serving path passes a
// null h_in and runs the instantiation without it.
//
// Semantics kept from the TPU kernel: u, B and C are f32 or bf16 and are
// widened to f32 on load; dt and A are f32; the state and every sum are
// f32.  exp(dt*A) is computed as ex2(dt * (A*log2 e)) by the special-
// function unit: within ~1e-6 relative of expf wherever |dt*A| < 10, and
// below e^-10 elsewhere.  A is (d, n), or (G, d, n) with G parameter groups
// over equal slices of the batch (row b scans under A[b / (batch / G)]).  B
// and C may be column slices of a wider (b, L, k) tensor: the kernel takes
// their batch and row strides.  Not kept: the TPU's d % 128 rule and its
// padding of L to 128 on the host.  Any L and d are taken: a step outside
// [0, L) reads dt = 0, which leaves the state as it is (at most 7 such steps
// run per chunk), and channels past d are masked here.
//
// Bound on an H100 SXM at B = 8, L = 962, d = 1024, bf16 u/B/C: the kernel
// must move b*L*d*(2 + 4 + 4) bytes (u, dt, y) + 2*b*L*n*2 (B, C), about
// 79 MB, or 23.7 us at 3.35 TB/s; it does about 7 f32 operations per
// (t, d, n), 13 us at the 67 TFLOP/s CUDA-core rate, so bytes bound it.  Its
// b*L*d*n = 126 M exponentials go through the special-function units, 16 a
// clock per SM, 31 us at the calibrated rate: the real floor.
//
// What the design does about it.  A block owns 32 channels of one batch
// row (128 threads); the 16 states of a channel live in the registers of 4
// neighbouring lanes (4 states each).  A block walks its chunks of 64
// steps, staging u, dt, B, C and y of a chunk in shared memory with
// coalesced loads and stores and prefetching the next chunk into registers
// while it runs the recurrence on the current one; the exp(dt*A) and
// B*dt*u of 8 steps are computed together, leaving one FMA per state and
// step on the serial chain, and the 8 steps' y sums over a channel's 4
// lanes are scattered so that each lane finishes two (6 shuffles).  One
// block walking all 16 chunks of L = 962 is latency-bound and, at small d
// or batch 1, leaves most SMs idle (32 blocks at B = 8, d = 128).  So L is
// cut into S groups of G consecutive chunks (the caller picks G for the
// launch, ops/selective_scan.py::fwd_chunks_per_group) that run in
// parallel:
//   1. state pass: every group but the last in the scan's direction runs
//      from a zero state and writes its end state and its dt sum;
//   2. carry pass (selective_scan.cuh): the state entering each group;
//   3. output pass: every group runs from its entry state, writes y, h_in
//      (under autograd) and, for the last group, h_out.
// The state pass pays each exponential a second time, so a launch that
// fills the card without it (S = 1: G = n_chunks) runs the output pass
// alone, from zero, as one pass.  Measured on an H100 (PERF.md):
// 32-channel blocks beat 16-channel ones by 5-17% a launch, the kernel's
// instruction issue, not its memory, sets the pace, and its registers
// (154-173 a thread) allow three blocks an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "selective_scan.cuh"

namespace {

using namespace sscan;

constexpr int FCH = 32;           // channels per block
constexpr int FNT = FCH * LPC;    // threads per block
constexpr int SUB = 8;            // steps per group of the inner loop
constexpr int RU = TL * FCH / FNT;  // u/dt tile elements per thread
constexpr int RB = TL * N / FNT;    // B/C tile elements per thread
constexpr int RS = FNT / FCH;       // u/dt tile rows between them
constexpr int RSB = FNT / N;        // B/C tile rows between them

static_assert(TL * FCH % FNT == 0 && TL * N % FNT == 0 && FNT % FCH == 0 &&
                  FNT % N == 0 && TL % SUB == 0 && SUB == 8,
              "tile split; the y sums scatter 8 steps over 4 lanes");

// what a launch of scan_fwd_kernel writes
enum Mode { STATE = 0, OUT = 1, OUT_SAVE = 2 };

// One chunk's inputs as this thread loads them: element r of the u/dt tile
// is (tt, cc) = (tid / FCH + r*RS, tid % FCH); element r of the B/C tile is
// (tt, n) = (tid / N + r*RSB, tid % N).  The state pass loads no C.
template <typename T, bool WITH_C>
struct Chunk {
  T u[RU];
  float dt[RU];
  T b[RB];
  T c[WITH_C ? RB : 1];
};

// Addresses are one pointer a tile plus a step an element, so that the
// loads cost few integer instructions.
template <typename T, bool WITH_C>
__device__ __forceinline__ void load_chunk(
    Chunk<T, WITH_C>& k, const T* __restrict__ u,
    const float* __restrict__ dt, const T* __restrict__ bm,
    const T* __restrict__ cm, size_t row0, int t0, int L, int d, int d0,
    long long bc_sl) {
  const int tid = threadIdx.x;
  const int tu = t0 + tid / FCH, cc = tid % FCH;
  const bool chan = d0 + cc < d;
  const long long base = ((long long)row0 + tu) * d + d0 + cc;
  const T* up = u + base;
  const float* dp = dt + base;
  const int rsd = RS * d;
#pragma unroll
  for (int r = 0; r < RU; ++r) {
    const int t = tu + r * RS;
    const bool ok = chan && t >= 0 && t < L;
    k.u[r] = ok ? up[r * rsd] : T(0.f);
    k.dt[r] = ok ? dp[r * rsd] : 0.f;
  }
  const int tb = t0 + tid / N;
  const long long bbase = (long long)tb * bc_sl + tid % N;
  const T* bp = bm + bbase;
  const T* cp = cm + bbase;
  const long long rsb = RSB * bc_sl;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int t = tb + r * RSB;
    const bool ok = t >= 0 && t < L;
    k.b[r] = ok ? bp[r * rsb] : T(0.f);
    if constexpr (WITH_C) k.c[r] = ok ? cp[r * rsb] : T(0.f);
  }
}

// The launch bounds ask for one block an SM, not more: without that
// minimum nvcc held the kernel to ~100 registers, and it ran 5-14% slower
// a launch on an H100 (PERF.md).
//
// grid (ceil(d / FCH), batch, groups launched).  Group s covers the chunks
// [s*G, min(n_chunks, (s+1)*G)) of the natural order; the state pass skips
// the last group in the scan's direction (blockIdx.z maps past it).  h_start
// (batch, S, n, d) is the state entering each group, or null for zeros;
// loc (batch, S, n, d) and sdt (batch, S, d) are the state pass's outputs.
template <typename T, bool REV, int MODE>
__global__ void __launch_bounds__(FNT, 1)
scan_fwd_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ bm,
                const T* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ h_out, float* __restrict__ h_in,
                const float* __restrict__ h_start, float* __restrict__ loc,
                float* __restrict__ sdt, int L, int d, int bg, int G,
                long long bc_sb, long long bc_sl) {
  constexpr bool WITH_Y = MODE != STATE;
  __shared__ float s_dt[TL][FCH];
  __shared__ float s_dtu[TL][FCH];  // dt * u, once per (step, channel)
  __shared__ float s_y[WITH_Y ? TL : 1][FCH];
  __shared__ __align__(16) float s_b[TL][N];
  __shared__ __align__(16) float s_c[WITH_Y ? TL : 1][N];

  const int tid = threadIdx.x;
  const int c = tid / LPC, g = tid % LPC;  // channel in block, state group
  const int d0 = blockIdx.x * FCH;
  const int b = blockIdx.y;
  const int ch = d0 + c;
  const bool valid = ch < d;
  const size_t row0 = (size_t)b * L;
  bm += b * bc_sb;
  cm += b * bc_sb;

  const int nchunks = num_chunks(L);
  const int S = (nchunks + G - 1) / G;
  // the state pass runs groups [0, S-1) forwards and [1, S) in reverse
  const int s = MODE == STATE && REV ? blockIdx.z + 1 : blockIdx.z;
  const int c_lo = s * G, nk = min(nchunks, c_lo + G) - c_lo;

  // A in base 2: exp(dt*A) = ex2(dt * A*log2(e)), one MUFU.EX2 a state
  float a2[NPT], h[NPT];
  const float* arow = A + ((size_t)(b / bg) * d + (valid ? ch : 0)) * N;
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    a2[j] = valid ? arow[g * NPT + j] * LOG2E : 0.f;
    h[j] = 0.f;
  }
  if (MODE != STATE && h_start != nullptr && valid) {
    const float* hst = h_start + (((size_t)b * S + s) * N + g * NPT) * d;
#pragma unroll
    for (int j = 0; j < NPT; ++j) h[j] = hst[(size_t)j * d + ch];
  }
  float dtsum = 0.f;

  // visit k runs chunk ci(k) of the natural order, covering steps
  // [t0, t0 + TL); the reverse direction visits the group's chunks from
  // its end, so the sequence's last visit may start before 0
  auto ci = [&](int k) { return REV ? c_lo + nk - 1 - k : c_lo + k; };

  Chunk<T, WITH_Y> next;
  load_chunk(next, u, dt, bm, cm, row0, chunk_start(REV, ci(0), nchunks, L),
             L, d, d0, bc_sl);
  for (int k = 0; k < nk; ++k) {
    const int t0 = chunk_start(REV, ci(k), nchunks, L);
    if (MODE == OUT_SAVE && valid) {
      // the state entering the chunk, keyed by its natural index
      float* hrow = h_in + (((size_t)b * nchunks + ci(k)) * N + g * NPT) * d;
#pragma unroll
      for (int j = 0; j < NPT; ++j) hrow[(size_t)j * d + ch] = h[j];
    }
#pragma unroll
    for (int r = 0; r < RU; ++r) {
      const int tt = tid / FCH + r * RS, cc = tid % FCH;
      s_dt[tt][cc] = next.dt[r];
      s_dtu[tt][cc] = next.dt[r] * widen(next.u[r]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int tt = tid / N + r * RSB, n = tid % N;
      s_b[tt][n] = widen(next.b[r]);
      if constexpr (WITH_Y) s_c[tt][n] = widen(next.c[r]);
    }
    __syncthreads();
    // the next chunk's loads are in flight while this one runs
    if (k + 1 < nk)
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
      for (int q = 0; q < SUB; ++q) {
        const int tt = REV ? hi - 1 - (i0 + q) : lo + i0 + q;
        const float dtv = s_dt[tt][c];
        const float dtu = s_dtu[tt][c];
        const float4 bv = *reinterpret_cast<const float4*>(&s_b[tt][g * NPT]);
        const float bj[NPT] = {bv.x, bv.y, bv.z, bv.w};
        if constexpr (MODE == STATE) dtsum += dtv;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          da[q][j] = ex2(dtv * a2[j]);
          db[q][j] = dtu * bj[j];
        }
      }
      if constexpr (MODE == STATE) {
#pragma unroll
        for (int q = 0; q < SUB; ++q)
#pragma unroll
          for (int j = 0; j < NPT; ++j) h[j] = fmaf(da[q][j], h[j], db[q][j]);
      } else {
        // the serial chain: one FMA per state and step
        float acc[SUB];
#pragma unroll
        for (int q = 0; q < SUB; ++q) {
          const int tt = REV ? hi - 1 - (i0 + q) : lo + i0 + q;
          const float4 cv =
              *reinterpret_cast<const float4*>(&s_c[tt][g * NPT]);
          const float cj[NPT] = {cv.x, cv.y, cv.z, cv.w};
          acc[q] = 0.f;
#pragma unroll
          for (int j = 0; j < NPT; ++j) {
            h[j] = fmaf(da[q][j], h[j], db[q][j]);
            acc[q] = fmaf(h[j], cj[j], acc[q]);
          }
        }
        // y_t: the sums over the channel's 4 lanes, scattered so that
        // each lane ends with two steps' (6 shuffles for 8 sums)
        const bool l0 = g & 1, l1 = g >> 1;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float k = l0 ? acc[i + 4] : acc[i];
          acc[i] = k + __shfl_xor_sync(0xffffffffu, l0 ? acc[i] : acc[i + 4],
                                       1);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float k = l1 ? acc[i + 2] : acc[i];
          acc[i] = k + __shfl_xor_sync(0xffffffffu, l1 ? acc[i] : acc[i + 2],
                                       2);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = 4 * l0 + 2 * l1 + i;
          s_y[REV ? hi - 1 - (i0 + q) : lo + i0 + q][c] = acc[i];
        }
      }
    }
    __syncthreads();

    if constexpr (WITH_Y) {
      const int tu = t0 + tid / FCH, cc = tid % FCH;
      float* yrow = y + ((long long)row0 + tu) * d + d0 + cc;
#pragma unroll
      for (int r = 0; r < RU; ++r) {
        const int t = tu + r * RS;
        if (d0 + cc < d && t >= 0 && t < L)
          yrow[r * RS * d] = s_y[tid / FCH + r * RS][cc];
      }
      __syncthreads();  // the next chunk overwrites the tiles
    }
  }

  if (!valid) return;
  if constexpr (MODE == STATE) {
    const size_t row = (size_t)b * S + s;
#pragma unroll
    for (int j = 0; j < NPT; ++j) loc[(row * N + g * NPT + j) * d + ch] = h[j];
    if (g == 0) sdt[row * d + ch] = dtsum;
  } else if (s == (REV ? 0 : S - 1)) {
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      h_out[((size_t)b * N + g * NPT + j) * d + ch] = h[j];
  }
}

template <typename T, bool REV, int MODE>
cudaError_t launch_pass(const void* u, const void* dt, const void* A,
                        const void* bm, const void* cm, void* y, void* h_out,
                        void* h_in, const float* h_start, float* loc,
                        float* sdt, int batch, int L, int d, int groups,
                        int G, int nz, long long bc_sb, long long bc_sl,
                        cudaStream_t stream) {
  const dim3 grid((d + FCH - 1) / FCH, batch, nz);
  scan_fwd_kernel<T, REV, MODE><<<grid, FNT, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<float*>(y),
      static_cast<float*>(h_out), static_cast<float*>(h_in), h_start, loc,
      sdt, L, d, batch / groups, G, bc_sb, bc_sl);
  return cudaGetLastError();
}

// The three passes (or the output pass alone when one group covers L).
// scratch holds loc (batch, S, n, d), h_start (batch, S, n, d) and sdt
// (batch, S, d), f32, in that order.
template <typename T, bool REV>
cudaError_t launch(const void* u, const void* dt, const void* A,
                   const void* bm, const void* cm, void* y, void* h_out,
                   void* h_in, float* scratch, int batch, int L, int d,
                   int groups, long long bc_sb, long long bc_sl, int G,
                   cudaStream_t stream) {
  const int S = (num_chunks(L) + G - 1) / G;
  const float* h_start = nullptr;
  if (S > 1) {
    float* loc = scratch;
    float* hst = loc + (size_t)batch * S * N * d;
    float* sdt = hst + (size_t)batch * S * N * d;
    cudaError_t err = launch_pass<T, REV, STATE>(
        u, dt, A, bm, cm, y, h_out, h_in, nullptr, loc, sdt, batch, L, d,
        groups, G, S - 1, bc_sb, bc_sl, stream);
    if (err != cudaSuccess) return err;
    err = launch_carry(loc, sdt, static_cast<const float*>(A), hst, batch, S,
                       d, batch / groups, !REV, stream);
    if (err != cudaSuccess) return err;
    h_start = hst;
  }
  return h_in ? launch_pass<T, REV, OUT_SAVE>(
                    u, dt, A, bm, cm, y, h_out, h_in, h_start, nullptr,
                    nullptr, batch, L, d, groups, G, S, bc_sb, bc_sl, stream)
              : launch_pass<T, REV, OUT>(
                    u, dt, A, bm, cm, y, h_out, h_in, h_start, nullptr,
                    nullptr, batch, L, d, groups, G, S, bc_sb, bc_sl, stream);
}

template <typename T>
cudaError_t dispatch(int reverse, const void* u, const void* dt,
                     const void* A, const void* bm, const void* cm, void* y,
                     void* h_out, void* h_in, float* scratch, int batch,
                     int L, int d, int groups, long long bc_sb,
                     long long bc_sl, int G, cudaStream_t s) {
  return reverse ? launch<T, true>(u, dt, A, bm, cm, y, h_out, h_in, scratch,
                                   batch, L, d, groups, bc_sb, bc_sl, G, s)
                 : launch<T, false>(u, dt, A, bm, cm, y, h_out, h_in,
                                    scratch, batch, L, d, groups, bc_sb,
                                    bc_sl, G, s);
}

}  // namespace

// u: (batch, L, d) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// dt: (batch, L, d) f32 contiguous; A: (groups, d, n) f32 contiguous;
// B, C: (batch, L, n) in u's dtype, element (b, t, k) at
// b*bc_batch_stride + t*bc_row_stride + k; y: (batch, L, d) f32;
// h_out: (batch, n, d) f32; h_in: null, or (batch, ceil(L / TL), n, d) f32
// for the chunk-entry states (TL in selective_scan.cuh).  The chunks are
// run in groups of chunks_per_group (G >= 1); with S = ceil(n_chunks / G)
// > 1 groups, scratch must hold (2*n + 1) * batch * S * d f32, else it may
// be null.  n must be 16 and groups must divide batch.  Launches on
// `stream` without synchronising and returns cudaGetLastError() of the
// launches.
extern "C" int selective_scan_fwd(const void* u, const void* dt,
                                  const void* A, const void* B, const void* C,
                                  void* y, void* h_out, void* h_in,
                                  int batch, int L, int d, int n, int groups,
                                  long long bc_batch_stride,
                                  long long bc_row_stride, int is_bf16,
                                  int reverse, void* scratch,
                                  int chunks_per_group, void* stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || d <= 0 || n != N ||
      groups <= 0 || batch % groups != 0 || chunks_per_group <= 0 ||
      (chunks_per_group < num_chunks(L) && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  return (int)(is_bf16
                   ? dispatch<__nv_bfloat16>(reverse, u, dt, A, B, C, y,
                                             h_out, h_in, scr, batch, L, d,
                                             groups, bc_batch_stride,
                                             bc_row_stride, chunks_per_group,
                                             s)
                   : dispatch<float>(reverse, u, dt, A, B, C, y, h_out, h_in,
                                     scr, batch, L, d, groups,
                                     bc_batch_stride, bc_row_stride,
                                     chunks_per_group, s));
}
