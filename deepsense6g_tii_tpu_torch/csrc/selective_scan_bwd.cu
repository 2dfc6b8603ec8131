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
//   g_t = C_t[n] * dy_t + p_{t+1},  p_t = a_t * g_t     (against the scan)
//
// it writes du_t = dt_t sum_n g_t B_t (u's dtype), ddt_t = u_t sum_n g_t B_t
// + sum_n g_t ah_t A (f32), dB_t[n] = sum_d g_t dt_t u_t and dC_t[n] =
// sum_d h_t dy_t (B's dtype, rounded once from f32) and dA[d,n] = sum_{b,t}
// g_t ah_t dt_t over each parameter group's rows (f32).  dB, dC and dA are
// summed in f32 from partials, per block's DT channels (b, ceil(d/DT), L,
// n) and per batch row and chunk (b, n_chunks, d, n), in a fixed order.
//
// Replaces: deepsense6g_tii_tpu/ops/selective_scan.py::_bwd_kernel_chunked
// and ::_bwd_kernel_chunked_rev (launched by _scan_bwd_pallas; _bwd_rule
// sums their partials), the TPU kernels of the MambaFuser's training step: 67
// launches per step (4 stages x 8 MambaBlocks x 2 branches at L = 962 and
// d = 128..1024, 3 TimeMamba scans at L = 5, d = 1024).
//
// Bound on an H100 SXM at B = 8, L = 962, d = 1024, bf16 u/B/C: it must
// read u, dt, dy, B, C and h_in and write du, ddt, dA, dB and dC, about
// 140 MB, or ~42 us at 3.35 TB/s.  Not in the bound: the design's f32
// partials (dB and dC 15.7 MB each at 32 channel blocks) and its
// exponentials: b*L*d*n = 126 M a sweep, ~31 us a sweep at the calibrated
// special-function rate, and this design sweeps ~3.75 times.
//
// Design.  The gradient carry p crosses chunks; carried through the whole
// sequence by one block, it serialises L (~190 ns a step over two sweeps
// on an H100, 2 blocks an SM).  So every TL-step chunk runs on its own,
// from the forward's h_in and a gradient entry p_in:
//   1. scan_bwd_local_kernel runs each chunk's gradient recurrence from
//      p = 0 (every chunk but the last in the gradient's direction) and
//      writes the p leaving it and the chunk's dt sum;
//   2. scan_carry_kernel (selective_scan.cuh) walks the ~15 chunks of each
//      (row, channel, state) and writes p_in: the decays of a chunk multiply
//      to exp(A * its dt sum), one exponential a chunk;
//   3. scan_bwd_kernel, one block per (chunk, 32 channels, row), 128
//      threads with 4 lanes of 4 states a channel as in the forward;
//   4. scan_bwd_sums_kernel adds the third's partials of dB, dC and dA in
//      a fixed order, each output element by one thread.
// A chunk of L <= TL needs only the last two.  In the third, the states are
// recomputed forwards from h_in with the forward's ex2, never re-derived
// backwards (h_{t-1} = (h_t - bb_t) / a_t is unstable where a_t is near 0).
// The chunk is taken in sub-chunks of SC = 16 steps: a first sweep keeps
// the state entering each sub-chunk in shared memory; then, last sub-chunk
// first, the block recomputes the sub-chunk's ah_t into shared memory (16
// steps x 128 threads x 4 states, 32 KB; a block takes 74 KB, so an SM
// holds three, 12 warps) while summing dC, and runs the gradient back
// through it.  The sub-chunk loop is not unrolled: unrolled, the kernel's
// code outgrew the instruction cache.  Every sweep takes 8 steps at a
// time: their loads and exponentials first, then the serial chain (two
// dependent operations a step), then their channel sums and lane shuffles
// together; the sums over a channel's 4 lanes of the 8 steps' du and ddt
// terms are scattered so that each lane finishes two steps (12 shuffles
// for 16 sums).  du and ddt are staged in the shared tiles of u and dy
// (each entry is read by its channel's lanes before the one that writes
// it) and stored coalesced at the end.  Sums over the 8 channels of a warp
// are shuffles (a reduce-scatter: 4 shuffles for 16 states); the 4 warps
// of a block meet in shared memory.  No atomics: every output element has
// one writer, and the result does not depend on the blocks' order.  Padded
// steps of a tile (outside [0, L)) read dt = 0, u = 0, dy = 0, B = C = 0:
// they carry h and p through unchanged, and their outputs are never
// stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "selective_scan.cuh"

namespace {

using namespace sscan;

constexpr unsigned FULL = 0xffffffffu;
constexpr int BNT = DT * LPC;   // threads per block (4 warps)
constexpr int NW = BNT / 32;    // warps per block
constexpr int SC = 16;          // steps per sub-chunk
constexpr int NSC = TL / SC;    // sub-chunks per chunk
constexpr int SUB = 8;          // steps per group of a sweep


static_assert(TL % SC == 0 && SC % SUB == 0 && BNT % 32 == 0,
              "sub-chunk split");

struct Smem {
  float4 ah[SC][BNT];                // ah_t of each thread's 4 states
  float4 hk[NSC - 1][BNT];           // the state entering sub-chunks 1..
  float dt[TL][DT];
  float u[TL][DT];                   // u, then du (f32)
  float dy[TL][DT];                  // dy, then ddt
  __align__(16) float b[TL][N];
  __align__(16) float c[TL][N];
  float red[NW][SC][N];              // per-warp channel sums: dC, then dB
};

// x[0..SUB) and y[0..SUB) are this lane's terms of SUB steps; the sums
// over the channel's 4 lanes (lane bits 0 and 1) are scattered over them:
// on return x[i], y[i] (i < 2) hold the sums of step 4*l0 + 2*l1 + i,
// l0 and l1 being lane bits 0 and 1.  12 shuffles for 16 sums.
__device__ __forceinline__ void lane_sums(float x[SUB], float y[SUB],
                                          int lane) {
  static_assert(SUB == 8, "three levels of 8 steps");
  const bool l0 = lane & 1, l1 = (lane >> 1) & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float kx = l0 ? x[i + 4] : x[i], sx = l0 ? x[i] : x[i + 4];
    const float ky = l0 ? y[i + 4] : y[i], sy = l0 ? y[i] : y[i + 4];
    x[i] = kx + __shfl_xor_sync(FULL, sx, 1);
    y[i] = ky + __shfl_xor_sync(FULL, sy, 1);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float kx = l1 ? x[i + 2] : x[i], sx = l1 ? x[i] : x[i + 2];
    const float ky = l1 ? y[i + 2] : y[i], sy = l1 ? y[i] : y[i + 2];
    x[i] = kx + __shfl_xor_sync(FULL, sx, 2);
    y[i] = ky + __shfl_xor_sync(FULL, sy, 2);
  }
}

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

// A thread's share of a (TL, W) tile of a block: element r is row
// tid / W + r*RS, column tid % W, at step t + r*RS of the sequence
template <int W>
struct Tile {
  static constexpr int RS = BNT / W;     // rows between a thread's elements
  static constexpr int R = TL / RS;      // elements a thread
  static_assert(BNT % W == 0 && TL % RS == 0, "tile split");
  int t, col, first;
  __device__ __forceinline__ Tile(int t0, int tid)
      : t(t0 + tid / W), col(tid % W), first(tid / W) {}
  __device__ __forceinline__ int row(int r) const { return first + r * RS; }
  __device__ __forceinline__ bool ok(int r, int L) const {
    return t + r * RS >= 0 && t + r * RS < L;
  }
  // the element's offset from the first, in a (., W')-strided array
  __device__ __forceinline__ int step(int r, int stride) const {
    return r * RS * stride;
  }
};

// tile position of the i-th step of a chunk in the scan's direction; the
// real steps are i < m for the chunk's m steps in [0, L)
template <bool REV>
__device__ __forceinline__ int tile_pos(int i) {
  return REV ? TL - 1 - i : i;
}

// 1. The gradient recurrence of one chunk from p = 0: grid (n_chunks - 1,
// ceil(d/DT), batch), the last chunk in the gradient's direction (0
// forwards, n_chunks - 1 in reverse) left out.  Writes p_loc (b, n_chunks,
// n, d), the p leaving the chunk, and sdt (b, n_chunks, d), its dt sum.
template <typename T, bool REV>
__global__ void __launch_bounds__(BNT)
scan_bwd_local_kernel(const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ cm,
                      const float* __restrict__ dy, float* __restrict__ p_loc,
                      float* __restrict__ sdt, int L, int d, int bg,
                      long long bc_sb, long long bc_sl) {
  __shared__ float s_dt[TL][DT];
  __shared__ float s_dy[TL][DT];
  __shared__ __align__(16) float s_c[TL][N];

  const int tid = threadIdx.x;
  const int c = tid / LPC, g = tid % LPC;
  const int d0 = blockIdx.y * DT;
  const int b = blockIdx.z;
  const int ch = d0 + c;
  const bool valid = ch < d;
  const int nchunks = num_chunks(L);
  const int ci = REV ? blockIdx.x : blockIdx.x + 1;
  const int t0 = chunk_start(REV, ci, nchunks, L);
  const size_t row0 = (size_t)b * L;
  cm += b * bc_sb;

  {
    const Tile<DT> tl(t0, tid);
    const long long base = ((long long)row0 + tl.t) * d + d0 + tl.col;
    const bool chan = d0 + tl.col < d;
#pragma unroll
    for (int r = 0; r < Tile<DT>::R; ++r) {
      const bool ok = chan && tl.ok(r, L);
      s_dt[tl.row(r)][tl.col] = ok ? dt[base + tl.step(r, d)] : 0.f;
      s_dy[tl.row(r)][tl.col] = ok ? dy[base + tl.step(r, d)] : 0.f;
    }
    const Tile<N> tn(t0, tid);
    const long long bbase = (long long)tn.t * bc_sl + tn.col;
#pragma unroll
    for (int r = 0; r < Tile<N>::R; ++r)
      s_c[tn.row(r)][tn.col] =
          tn.ok(r, L) ? widen(cm[bbase + r * (long long)Tile<N>::RS * bc_sl])
                      : 0.f;
  }
  __syncthreads();

  float a2[NPT], p[NPT];
  const float* arow = A + ((size_t)(b / bg) * d + (valid ? ch : 0)) * N;
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    a2[j] = valid ? arow[g * NPT + j] * LOG2E : 0.f;
    p[j] = 0.f;
  }
  float dtsum = 0.f;
  // against the scan: tile positions TL-1 .. 0 forwards, 0 .. TL-1 reversed
  for (int i0 = 0; i0 < TL; i0 += SUB) {
    float a[SUB][NPT], q[SUB][NPT];
#pragma unroll
    for (int s = 0; s < SUB; ++s) {
      const int tt = tile_pos<REV>(TL - 1 - (i0 + s));
      const float dtv = s_dt[tt][c], dyv = s_dy[tt][c];
      const float4 cv = *reinterpret_cast<const float4*>(&s_c[tt][g * NPT]);
      const float cj[NPT] = {cv.x, cv.y, cv.z, cv.w};
      dtsum += dtv;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        a[s][j] = ex2(dtv * a2[j]);
        q[s][j] = cj[j] * dyv;
      }
    }
#pragma unroll
    for (int s = 0; s < SUB; ++s)
#pragma unroll
      for (int j = 0; j < NPT; ++j) p[j] = a[s][j] * (q[s][j] + p[j]);
  }
  if (!valid) return;
  const size_t row = (size_t)b * nchunks + ci;
#pragma unroll
  for (int j = 0; j < NPT; ++j) p_loc[(row * N + g * NPT + j) * d + ch] = p[j];
  if (g == 0) sdt[row * d + ch] = dtsum;
}

// The block's dB or dC partial of sub-chunk k from the warps' sums in
// s.red: the real steps only
template <bool REV>
__device__ __forceinline__ void write_partial(const Smem& s,
                                              float* __restrict__ part,
                                              int k, int m, int t0, int tid) {
  for (int idx = tid; idx < SC * N; idx += BNT) {
    const int r = idx / N, n = idx % N, i = k * SC + r;
    if (i < m) {
      float sum = s.red[0][r][n];
#pragma unroll
      for (int w = 1; w < NW; ++w) sum += s.red[w][r][n];
      part[(size_t)(t0 + tile_pos<REV>(i)) * N + n] = sum;
    }
  }
}

// 3. One chunk's gradients: grid (n_chunks, ceil(d/DT), batch).  p_in is
// the gradient carry entering the chunk (b, n_chunks, n, d), or null for
// zeros (a single chunk).
template <typename T, bool REV>
__global__ void __launch_bounds__(BNT, 3)
scan_bwd_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ dy,
                const float* __restrict__ h_in,
                const float* __restrict__ p_in, T* __restrict__ du,
                float* __restrict__ ddt, float* __restrict__ db_part,
                float* __restrict__ dc_part, float* __restrict__ da_part,
                int L, int d, int bg, long long bc_sb, long long bc_sl) {
  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / LPC, g = tid % LPC;  // channel in block, state group
  const int d0 = blockIdx.y * DT;
  const int b = blockIdx.z;
  const int ci = blockIdx.x;
  const int ch = d0 + c;
  const bool valid = ch < d;
  const size_t row0 = (size_t)b * L;
  const int nchunks = num_chunks(L);
  const int t0 = chunk_start(REV, ci, nchunks, L);
  // the chunk's m steps in [0, L) are its first m in the scan's direction
  const int m = min(TL, L - t0) - max(0, -t0);
  const int nsub = (m + SC - 1) / SC;
  bm += b * bc_sb;
  cm += b * bc_sb;
  // lanes 0-15 of each warp hold the channel sums, of state n_red
  const bool lead = lane < 16;
  const int n_red = g * NPT + 2 * ((lane >> 2) & 1) + ((lane >> 3) & 1);
  float* db_blk = db_part + ((size_t)b * gridDim.y + blockIdx.y) * L * N;
  float* dc_blk = dc_part + ((size_t)b * gridDim.y + blockIdx.y) * L * N;

  const Tile<DT> tl(t0, tid);
  const long long base = ((long long)row0 + tl.t) * d + d0 + tl.col;
  const bool chan = d0 + tl.col < d;
#pragma unroll
  for (int r = 0; r < Tile<DT>::R; ++r) {
    const bool ok = chan && tl.ok(r, L);
    s.dt[tl.row(r)][tl.col] = ok ? dt[base + tl.step(r, d)] : 0.f;
    s.u[tl.row(r)][tl.col] = ok ? widen(u[base + tl.step(r, d)]) : 0.f;
    s.dy[tl.row(r)][tl.col] = ok ? dy[base + tl.step(r, d)] : 0.f;
  }
  {
    const Tile<N> tn(t0, tid);
    const long long bbase = (long long)tn.t * bc_sl + tn.col;
#pragma unroll
    for (int r = 0; r < Tile<N>::R; ++r) {
      const bool ok = tn.ok(r, L);
      const long long off = bbase + r * (long long)Tile<N>::RS * bc_sl;
      s.b[tn.row(r)][tn.col] = ok ? widen(bm[off]) : 0.f;
      s.c[tn.row(r)][tn.col] = ok ? widen(cm[off]) : 0.f;
    }
  }

  float av[NPT], a2[NPT], h0[NPT], h[NPT], p[NPT], da[NPT];
  const float* arow = A + ((size_t)(b / bg) * d + (valid ? ch : 0)) * N;
  const size_t srow = (((size_t)b * nchunks + ci) * N + g * NPT) * d + ch;
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    av[j] = valid ? arow[g * NPT + j] : 0.f;
    a2[j] = av[j] * LOG2E;       // exp(dt*A) = ex2(dt * A*log2(e))
    h0[j] = valid ? h_in[srow + (size_t)j * d] : 0.f;
    h[j] = h0[j];
    p[j] = (valid && p_in != nullptr) ? p_in[srow + (size_t)j * d] : 0.f;
    da[j] = 0.f;
  }
  __syncthreads();

  // Sub-chunk k's step i (scan order) is tile row tile_pos(k*SC) + i*RS:
  // each sweep addresses the tiles from one pointer a sub-chunk with
  // constant offsets.
  constexpr int RS = REV ? -1 : 1;
  float4* const pah = &s.ah[0][tid];
  float* const pred = &s.red[warp][0][n_red];

  // the state entering each sub-chunk after the first, by a sweep over
  // all but the last
  for (int k = 0; k + 1 < nsub; ++k) {
    const int tk = tile_pos<REV>(k * SC);
    const float* pdt = &s.dt[tk][c];
    const float* pu = &s.u[tk][c];
    const float* pb = &s.b[tk][g * NPT];
#pragma unroll
    for (int r0 = 0; r0 < SC; r0 += SUB) {
      float a[SUB][NPT], bj[SUB][NPT], dtu[SUB];
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        const int o = (r0 + q) * RS;
        const float dtv = pdt[o * DT];
        dtu[q] = dtv * pu[o * DT];
        const float4 bv = *reinterpret_cast<const float4*>(pb + o * N);
        bj[q][0] = bv.x, bj[q][1] = bv.y, bj[q][2] = bv.z, bj[q][3] = bv.w;
#pragma unroll
        for (int j = 0; j < NPT; ++j) a[q][j] = ex2(dtv * a2[j]);
      }
#pragma unroll
      for (int q = 0; q < SUB; ++q)
#pragma unroll
        for (int j = 0; j < NPT; ++j)
          h[j] = fmaf(dtu[q], bj[q][j], a[q][j] * h[j]);
    }
    s.hk[k][tid] = make_float4(h[0], h[1], h[2], h[3]);
  }

  // last sub-chunk first: its states again, with ah kept and dC summed,
  // then the gradient back through it
  for (int k = nsub - 1; k >= 0; --k) {
    if (k > 0) {
      const float4 v = s.hk[k - 1][tid];
      h[0] = v.x, h[1] = v.y, h[2] = v.z, h[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < NPT; ++j) h[j] = h0[j];
    }
    const int tk = tile_pos<REV>(k * SC);
    const float* pdt = &s.dt[tk][c];
    float* pu = &s.u[tk][c];    // u, then du
    float* pdy = &s.dy[tk][c];  // dy, then ddt
    const float* pb = &s.b[tk][g * NPT];
    const float* pc = &s.c[tk][g * NPT];
#pragma unroll
    for (int r0 = 0; r0 < SC; r0 += SUB) {
      float a[SUB][NPT], bj[SUB][NPT], dtu[SUB], dyv[SUB];
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        const int o = (r0 + q) * RS;
        const float dtv = pdt[o * DT];
        dtu[q] = dtv * pu[o * DT];
        dyv[q] = pdy[o * DT];
        const float4 bv = *reinterpret_cast<const float4*>(pb + o * N);
        bj[q][0] = bv.x, bj[q][1] = bv.y, bj[q][2] = bv.z, bj[q][3] = bv.w;
#pragma unroll
        for (int j = 0; j < NPT; ++j) a[q][j] = ex2(dtv * a2[j]);
      }
      float ah[SUB][NPT], hdy[SUB][NPT];
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          ah[q][j] = a[q][j] * h[j];
          h[j] = fmaf(dtu[q], bj[q][j], ah[q][j]);
          hdy[q][j] = h[j] * dyv[q];
        }
      }
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        pah[(r0 + q) * BNT] =
            make_float4(ah[q][0], ah[q][1], ah[q][2], ah[q][3]);
        const float sum = channel_sum(hdy[q], lane);
        if (lead) pred[(r0 + q) * N] = sum;
      }
    }
    __syncthreads();
    write_partial<REV>(s, dc_blk, k, m, t0, tid);
    __syncthreads();

#pragma unroll
    for (int r0 = SC - SUB; r0 >= 0; r0 -= SUB) {
      // step r = r0 + SUB-1-q of the sub-chunk: q = 0 is the latest
      float a[SUB][NPT], gg[SUB][NPT], dtv[SUB], uv[SUB], dyv[SUB];
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        const int o = (r0 + SUB - 1 - q) * RS;
        dtv[q] = pdt[o * DT];
        uv[q] = pu[o * DT];
        dyv[q] = pdy[o * DT];
#pragma unroll
        for (int j = 0; j < NPT; ++j) a[q][j] = ex2(dtv[q] * a2[j]);
      }
      // the serial chain: g_t = C dy + p_{t+1}, p_t = a_t g_t
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        const int o = (r0 + SUB - 1 - q) * RS;
        const float4 cv = *reinterpret_cast<const float4*>(pc + o * N);
        const float cj[NPT] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          gg[q][j] = fmaf(cj[j], dyv[q], p[j]);
          p[j] = a[q][j] * gg[q][j];
        }
      }
      float gb[SUB], gsa[SUB];
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        const int r = r0 + SUB - 1 - q;
        const float4 bv = *reinterpret_cast<const float4*>(pb + r * RS * N);
        const float4 ahv = pah[r * BNT];
        const float bj[NPT] = {bv.x, bv.y, bv.z, bv.w};
        const float ahj[NPT] = {ahv.x, ahv.y, ahv.z, ahv.w};
        const float dtu = dtv[q] * uv[q];
        float gdtu[NPT];
        gb[q] = 0.f;
        gsa[q] = 0.f;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          gb[q] = fmaf(gg[q][j], bj[j], gb[q]);
          const float gah = gg[q][j] * ahj[j];
          gsa[q] = fmaf(gah, av[j], gsa[q]);
          da[j] = fmaf(gah, dtv[q], da[j]);
          gdtu[j] = gg[q][j] * dtu;
        }
        const float sum = channel_sum(gdtu, lane);
        if (lead) pred[r * N] = sum;
      }
      // each lane finishes two steps' du and ddt
      lane_sums(gb, gsa, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = 4 * (g & 1) + 2 * (g >> 1) + i;
        const int o = (r0 + SUB - 1 - q) * RS * DT;
        const float dtq = pdt[o], uq = pu[o];
        pu[o] = dtq * gb[i];                 // du
        pdy[o] = fmaf(uq, gb[i], gsa[i]);    // ddt
      }
    }
    __syncthreads();
    write_partial<REV>(s, db_blk, k, m, t0, tid);
    __syncthreads();
  }

  // du and ddt of the chunk, coalesced
#pragma unroll
  for (int r = 0; r < Tile<DT>::R; ++r) {
    if (chan && tl.ok(r, L)) {
      du[base + tl.step(r, d)] = narrow<T>(s.u[tl.row(r)][tl.col]);
      ddt[base + tl.step(r, d)] = s.dy[tl.row(r)][tl.col];
    }
  }

  if (valid) {
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      da_part[(((size_t)b * nchunks + ci) * d + ch) * N + g * NPT + j] =
          da[j];
  }
}

// 4. The sums of the main pass's partials, each in a fixed order in f32:
// dB and dC (batch, L, n) over the channel blocks, rounded once to T; dA
// (groups, d, n) over each group's rows and their chunks.  One thread an
// output element, dB/dC's first; the terms of a sum, at a fixed stride,
// go into SUM_ACC accumulators in turn (so that their loads are in flight
// together), added up at the end.
constexpr int SUM_NT = 256;
constexpr int SUM_ACC = 8;

__device__ __forceinline__ float strided_sum(const float* __restrict__ p,
                                             int count, long long stride) {
  float acc[SUM_ACC];
#pragma unroll
  for (int i = 0; i < SUM_ACC; ++i) acc[i] = 0.f;
  int k = 0;
  for (; k + SUM_ACC <= count; k += SUM_ACC)
#pragma unroll
    for (int i = 0; i < SUM_ACC; ++i) acc[i] += p[(k + i) * stride];
#pragma unroll
  for (int i = 0; i < SUM_ACC; ++i)
    if (k + i < count) acc[i] += p[(k + i) * stride];
  float sum = acc[0];
#pragma unroll
  for (int i = 1; i < SUM_ACC; ++i) sum += acc[i];
  return sum;
}

template <typename T>
__global__ void __launch_bounds__(SUM_NT)
scan_bwd_sums_kernel(const float* __restrict__ db_part,
                     const float* __restrict__ dc_part,
                     const float* __restrict__ da_part, T* __restrict__ dB,
                     T* __restrict__ dC, float* __restrict__ dA, int batch,
                     int L, int d, int nd, int nchunks, int groups) {
  const long long e = (long long)blockIdx.x * SUM_NT + threadIdx.x;
  const long long nbc = (long long)batch * L * N, block = (long long)L * N;
  if (e < nbc) {
    const long long off = (e / block) * nd * block + e % block;
    dB[e] = narrow<T>(strided_sum(db_part + off, nd, block));
    dC[e] = narrow<T>(strided_sum(dc_part + off, nd, block));
    return;
  }
  const long long f = e - nbc, dn = (long long)d * N;
  if (f >= (long long)groups * dn) return;
  // the group's rows and their chunks are consecutive (b, chunk) pairs
  const int terms = batch / groups * nchunks;
  dA[f] = strided_sum(da_part + (f / dn) * terms * dn + f % dn, terms, dn);
}

// scratch holds p_loc and p_in (batch, n_chunks, n, d) and sdt (batch,
// n_chunks, d), f32, in that order; unused for a single chunk
template <typename T, bool REV>
cudaError_t launch(const void* u, const void* dt, const void* A,
                   const void* bm, const void* cm, const void* dy,
                   const void* h_in, void* du, void* ddt, void* db_part,
                   void* dc_part, void* da_part, void* dA, void* dB, void* dC,
                   float* scratch, int batch, int L, int d, int groups,
                   long long bc_sb, long long bc_sl, cudaStream_t stream) {
  const int nchunks = num_chunks(L), nd = (d + DT - 1) / DT;
  const int bg = batch / groups;
  const float* p_in = nullptr;
  if (nchunks > 1) {
    float* p_loc = scratch;
    float* pin = p_loc + (size_t)batch * nchunks * N * d;
    float* sdt = pin + (size_t)batch * nchunks * N * d;
    scan_bwd_local_kernel<T, REV>
        <<<dim3(nchunks - 1, nd, batch), BNT, 0, stream>>>(
            static_cast<const float*>(dt), static_cast<const float*>(A),
            static_cast<const T*>(cm), static_cast<const float*>(dy), p_loc,
            sdt, L, d, bg, bc_sb, bc_sl);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // the gradient runs against the scan: chunks from the end forwards
    err = launch_carry(p_loc, sdt, static_cast<const float*>(A), pin, batch,
                       nchunks, d, bg, REV, stream);
    if (err != cudaSuccess) return err;
    p_in = pin;
  }
  // above 48 KB, dynamic shared memory must be asked for (per device)
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<T, REV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (err != cudaSuccess) return err;
  scan_bwd_kernel<T, REV>
      <<<dim3(nchunks, nd, batch), BNT, sizeof(Smem), stream>>>(
          static_cast<const T*>(u), static_cast<const float*>(dt),
          static_cast<const float*>(A), static_cast<const T*>(bm),
          static_cast<const T*>(cm), static_cast<const float*>(dy),
          static_cast<const float*>(h_in), p_in, static_cast<T*>(du),
          static_cast<float*>(ddt), static_cast<float*>(db_part),
          static_cast<float*>(dc_part), static_cast<float*>(da_part), L, d,
          bg, bc_sb, bc_sl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)batch * L * N + (long long)groups * d * N;
  scan_bwd_sums_kernel<T>
      <<<(unsigned)((total + SUM_NT - 1) / SUM_NT), SUM_NT, 0, stream>>>(
          static_cast<const float*>(db_part),
          static_cast<const float*>(dc_part),
          static_cast<const float*>(da_part), static_cast<T*>(dB),
          static_cast<T*>(dC), static_cast<float*>(dA), batch, L, d, nd,
          nchunks, groups);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dir(int reverse, const void* u, const void* dt,
                         const void* A, const void* bm, const void* cm,
                         const void* dy, const void* h_in, void* du,
                         void* ddt, void* db_part, void* dc_part,
                         void* da_part, void* dA, void* dB, void* dC,
                         float* scratch, int batch, int L, int d, int groups,
                         long long bc_sb, long long bc_sl, cudaStream_t s) {
  return reverse ? launch<T, true>(u, dt, A, bm, cm, dy, h_in, du, ddt,
                                   db_part, dc_part, da_part, dA, dB, dC,
                                   scratch, batch, L, d, groups, bc_sb,
                                   bc_sl, s)
                 : launch<T, false>(u, dt, A, bm, cm, dy, h_in, du, ddt,
                                    db_part, dc_part, da_part, dA, dB, dC,
                                    scratch, batch, L, d, groups, bc_sb,
                                    bc_sl, s);
}

}  // namespace

// u: (batch, L, d) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// dt, dy: (batch, L, d) f32 contiguous; A: (groups, d, n) f32 contiguous;
// B, C: (batch, L, n) in u's dtype, element (b, t, k) at
// b*bc_batch_stride + t*bc_row_stride + k; h_in: (batch, n_chunks, n, d)
// f32 from selective_scan_fwd, n_chunks being ceil(L / TL).  Writes du
// (batch, L, d) in u's dtype, ddt (batch, L, d) f32, dA (groups, d, n)
// f32, and dB, dC (batch, L, n) contiguous in u's dtype; db_part and
// dc_part (batch, ceil(d / DT), L, n) f32 and da_part (batch, n_chunks, d,
// n) f32 are its partial sums (TL and DT in selective_scan.cuh).  scratch:
// (2*n + 1) * batch * n_chunks * d f32, or null when n_chunks is 1.  n
// must be 16 and groups must divide batch.  Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launches.
extern "C" int selective_scan_bwd(const void* u, const void* dt,
                                  const void* A, const void* B, const void* C,
                                  const void* dy, const void* h_in, void* du,
                                  void* ddt, void* db_part, void* dc_part,
                                  void* da_part, void* dA, void* dB, void* dC,
                                  void* scratch, int batch, int L, int d,
                                  int n, int groups,
                                  long long bc_batch_stride,
                                  long long bc_row_stride, int is_bf16,
                                  int reverse, void* stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || d <= 0 || n != N ||
      groups <= 0 || batch % groups != 0 ||
      (num_chunks(L) > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  return (int)(is_bf16
                   ? dispatch_dir<__nv_bfloat16>(
                         reverse, u, dt, A, B, C, dy, h_in, du, ddt, db_part,
                         dc_part, da_part, dA, dB, dC, scr, batch, L, d,
                         groups, bc_batch_stride, bc_row_stride, s)
                   : dispatch_dir<float>(
                         reverse, u, dt, A, B, C, dy, h_in, du, ddt, db_part,
                         dc_part, da_part, dA, dB, dC, scr, batch, L, d,
                         groups, bc_batch_stride, bc_row_stride, s));
}
