// Sequential selective-scan forward for Hopper (sm_90a): the same scan as
// selective_scan_fwd.cu,
//
//   h_t = exp(dt_t * A[d,n]) * h_{t-1} + (dt_t * u_t) * B_t[n]   (h_{-1} = 0)
//   y_t = sum_n h_t[d,n] * C_t[n]                                 (f32)
//
// left to right, per batch row b and channel d, every state walking all L
// steps in order from zero in one launch: no groups of chunks, no carry
// pass and no second pass over L, unlike the chunked kernel, so that the
// two kernels check each other.  Writes y (b, L, d) and the final state
// h_out (b, n, d), both f32, and, when h_in is not null, the chunk-entry
// states h_in (b, n_chunks, n, d) f32 at the spacing and keying of the
// chunked kernel (TL in selective_scan.cuh), so that the backward kernel
// (selective_scan_bwd.cu) takes them unchanged.  No reverse direction, as
// on the TPU.
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
// Bound on an H100 SXM at B = 8, L = 962, d = 1024, bf16 u/B/C: the bytes
// of the chunked kernel (every input read once, y and h_out written once;
// 79 MB, 23.7 us at 3.35 TB/s), and beside them the b*L*d*n = 126 M
// exponentials at 16 a clock per SM (~30 us at 1.98 GHz), the floor of any
// design that computes each decay once.  The serial chain itself is one
// FMA a step (~4 clocks), ~2 us for 962 steps.  At small b*d the card
// cannot be filled (B = 1, d = 128: 2,048 states), and a launch costs the
// time of 962 steps of one warp, however little each step does.
//
// Design.  A lane holds NPT = 16 / LPC states (LPC = 4, 8 or 16 lanes a
// channel) of NCH channels (1 or 2), and a block of NT threads (64 or 128)
// owns CPB = NT * NCH / LPC channels of one batch row; the caller picks
// one of the five splits of SEQ_SPLITS for each launch
// (ops/selective_scan.py::seq_launch), so that b*d*LPC/NCH threads fill
// the card's SMs with warps where b*d allows it.  The block walks L in tiles of TS steps (TS divides TL).  It loads
// the next tile's dt, u, B and C into registers (coalesced, each element
// once a block, one pointer a tile, loads past L predicated off) while it
// runs the current one from shared memory.  Each lane runs its steps in
// groups of S = 8 / NPT: a group's decays ex2(dt*A'), dt*u*B and C, which
// do not depend on the state, are computed one group ahead, so that they
// issue while the previous group's chain runs (one FMA per state and
// step).  Each step's y partial over the lane's NPT states goes to shared
// memory; after the tile the block adds the LPC partials of each (step,
// channel) and writes y coalesced, so nothing on the step path waits for
// a shuffle.  The partials' strides (GS between lane groups, PR between
// steps) are padded so that neither the stores of a warp nor the reads of
// the sums meet a bank conflict.  What bounds the design once the card is
// full is shared memory: B and C are read by every channel's lanes, 8 /
// NCH bytes a state and step, beside 16 / NPT for dt, dt*u and the
// partials, against 128 bytes a clock per SM; two channels a lane halve
// the first.  Two barriers a tile: after the staging and before the
// sums.  The state's arithmetic is the earlier one-thread-per-channel
// kernel's, h = fmaf(ex2(dt * A'), h, (dt * u) * B), so h_out and h_in are
// the same bits; only y's order of summation differs.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md): the MambaFuser's 67 scans take
// 2.59 ms at B = 8 (the one-thread-a-channel kernel: 12.27 ms, the chunked
// kernel 2.97) and 1.32 ms at B = 1 (11.42, 1.17); a lone warp a
// sub-partition sets the pace at small b*d, shared memory and issue at
// large.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "selective_scan.cuh"

namespace {

using namespace sscan;

// The launch splits that ops/selective_scan.py::seq_launch can pick, and
// the only ones instantiated (it reads this table): {lanes per channel,
// channels a lane, threads per block}.  The launch bounds ask for
// SEQ_SM_THREADS threads an SM, at most 170 registers a thread.
constexpr int SEQ_SPLITS[][3] = {
    {16, 1, 64}, {16, 1, 128}, {8, 1, 128}, {4, 1, 128}, {4, 2, 128}};
constexpr int SEQ_SM_THREADS = 384;

struct Args {
  const void *u, *dt, *A, *bm, *cm;
  void *y, *h_out, *h_in;
  int batch, L, d, bg;
  long long bc_sb, bc_sl;
};

template <int NPT, int NCH, int NT>
struct Layout {
  static constexpr int LPC = N / NPT;         // lanes per channel
  static constexpr int CPB = NT * NCH / LPC;  // channels per block
  static constexpr int S = 8 / NPT;           // steps a group
  // steps a tile: at most 16 dt/u elements a thread in flight
  static constexpr int TS = TL < 16 * LPC / NCH ? TL : 16 * LPC / NCH;
  // y partials of step t, lane group g, channel c at t*PR + g*GS + c: a
  // warp's stores hit 32 / LPC lane groups times LPC values of g, and GS
  // = (32 / LPC) * odd spreads them over distinct banks; the sums read
  // 32 consecutive (t, c), and PR = CPB * odd spreads the rows
  static constexpr int GS = 32 / LPC * ((NT * NCH / 32) | 1);
  static constexpr int PR = CPB * (((LPC * GS + CPB - 1) / CPB) | 1);
  // dynamic shared memory: {dt, dt*u} [TS][CPB], B and C [TS][2N] (lane
  // group g's NPT values of B, then of C), the partials [TS][PR]
  static constexpr int BYTES = TS * CPB * 8 + TS * 2 * N * 4 + TS * PR * 4;
};

// grid (ceil(d / CPB), batch); thread tid holds states [g*NPT, (g+1)*NPT)
// of channels blockIdx.x * CPB + (tid / LPC) * NCH + k, k < NCH, g = tid %
// LPC
template <typename T, int NPT, int NCH, int NT>
__global__ void __launch_bounds__(NT, SEQ_SM_THREADS / NT)
scan_seq_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ bm,
                const T* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ h_out, float* __restrict__ h_in, int L,
                int d, int bg, long long bc_sb, long long bc_sl) {
  using Lay = Layout<NPT, NCH, NT>;
  constexpr int LPC = Lay::LPC, CPB = Lay::CPB, S = Lay::S, TS = Lay::TS;
  constexpr int GS = Lay::GS, PR = Lay::PR;
  constexpr int ROWS = NT / CPB;      // tile rows between a thread's elements
  constexpr int RU = TS / ROWS;       // dt/u elements (and y sums) a thread
  constexpr int RB = TS * N / NT;     // B/C elements a thread
  constexpr int BS = NT / N;          // B/C tile rows between them
  static_assert(N % NPT == 0 && NT % LPC == 0 && NT % 32 == 0 &&
                    NT % N == 0 && NT % CPB == 0 && TL % TS == 0 &&
                    TS % (2 * S) == 0 && (NCH == 1 || NCH == 2),
                "lane and tile split");
  extern __shared__ float4 smem[];
  float2* s_dd = reinterpret_cast<float2*>(smem);
  float* s_bc = reinterpret_cast<float*>(s_dd + TS * CPB);
  float* s_part = s_bc + TS * 2 * N;

  const int tid = threadIdx.x;
  const int cg = tid / LPC, g = tid % LPC;     // lane group, state group
  const int su = tid / CPB, cu = tid % CPB;    // tile row, channel
  const int sb = tid / N, nb = tid % N;        // B/C tile row, state
  const int d0 = blockIdx.x * CPB;
  const int c0 = d0 + cg * NCH;                // this lane's first channel
  const bool valid_u = d0 + cu < d;
  const int b = blockIdx.y;
  const size_t row0 = (size_t)b * L;
  const size_t rstep = (size_t)ROWS * d;       // between a thread's rows

  float a2[NCH][NPT], h[NCH][NPT];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const bool ok = c0 + k < d;
    const float* arow =
        A + ((size_t)(b / bg) * d + (ok ? c0 + k : 0)) * N + g * NPT;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      a2[k][j] = ok ? arow[j] * LOG2E : 0.f;
      h[k][j] = 0.f;
    }
  }

  // a tile's inputs in registers, as loaded (widened only when staged, so
  // that nothing waits for them before then); channels past d read
  // channel d - 1, which no lane stores
  const size_t uoff = (row0 + su) * d + min(d0 + cu, d - 1);
  const float* dp = dt + uoff;
  const T* up = u + uoff;
  float* yp = y + (row0 + su) * d + d0 + cu;
  const T* bp = bm + b * bc_sb + sb * bc_sl + nb;
  const T* cp = cm + b * bc_sb + sb * bc_sl + nb;
  float rdt[RU];
  T ru[RU], rb[RB], rc[RB];
  auto load = [&](int t0) {
#pragma unroll
    for (int r = 0; r < RU; ++r) {
      const bool ok = t0 + su + r * ROWS < L;
      rdt[r] = ok ? dp[r * rstep] : 0.f;
      ru[r] = ok ? up[r * rstep] : T(0.f);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const bool ok = t0 + sb + r * BS < L;
      rb[r] = ok ? bp[r * BS * bc_sl] : T(0.f);
      rc[r] = ok ? cp[r * BS * bc_sl] : T(0.f);
    }
  };
  // dt*u is rounded once, as the state update reads it; steps past L stage
  // as zeros
  auto stage = [&]() {
#pragma unroll
    for (int r = 0; r < RU; ++r)
      s_dd[(su + r * ROWS) * CPB + cu] =
          make_float2(rdt[r], rdt[r] * widen(ru[r]));
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float* row = s_bc + (sb + r * BS) * 2 * N + (nb / NPT) * 2 * NPT +
                   nb % NPT;
      row[0] = widen(rb[r]);
      row[NPT] = widen(rc[r]);
    }
  };

  // a group of S steps from tile row t: what does not depend on the state
  float da[2][S][NCH][NPT], db[2][S][NCH][NPT], cj[2][S][NPT];
  auto prep = [&](int set, int t) {
#pragma unroll
    for (int q = 0; q < S; ++q) {
      float dd[2 * NCH];  // {dt, dt*u} of each channel
      const float2* ddp = s_dd + (t + q) * CPB + cg * NCH;
      if constexpr (NCH == 1) {
        const float2 v = *ddp;
        dd[0] = v.x, dd[1] = v.y;
      } else {
        const float4 v = *reinterpret_cast<const float4*>(ddp);
        dd[0] = v.x, dd[1] = v.y, dd[2] = v.z, dd[3] = v.w;
      }
      const float* bc = s_bc + (t + q) * 2 * N + g * 2 * NPT;
      float bj[NPT];
      if constexpr (NPT == 1) {
        const float2 v = *reinterpret_cast<const float2*>(bc);
        bj[0] = v.x, cj[set][q][0] = v.y;
      } else if constexpr (NPT == 2) {
        const float4 v = *reinterpret_cast<const float4*>(bc);
        bj[0] = v.x, bj[1] = v.y, cj[set][q][0] = v.z, cj[set][q][1] = v.w;
      } else {
        const float4 v = *reinterpret_cast<const float4*>(bc);
        const float4 w = *reinterpret_cast<const float4*>(bc + 4);
        bj[0] = v.x, bj[1] = v.y, bj[2] = v.z, bj[3] = v.w;
        cj[set][q][0] = w.x, cj[set][q][1] = w.y, cj[set][q][2] = w.z,
        cj[set][q][3] = w.w;
      }
#pragma unroll
      for (int k = 0; k < NCH; ++k)
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          da[set][q][k][j] = ex2(dd[2 * k] * a2[k][j]);
          db[set][q][k][j] = dd[2 * k + 1] * bj[j];
        }
    }
  };
  // the chain, one FMA per state and step (real steps only: all of a full
  // tile), and each step's y partial over this lane's states
  auto chain = [&](auto full, int set, int t, int steps) {
#pragma unroll
    for (int q = 0; q < S; ++q) {
      float acc[NCH];
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        if (decltype(full)::value || t + q < steps) {
#pragma unroll
          for (int j = 0; j < NPT; ++j)
            h[k][j] = fmaf(da[set][q][k][j], h[k][j], db[set][q][k][j]);
        }
        acc[k] = h[k][0] * cj[set][q][0];
#pragma unroll
        for (int j = 1; j < NPT; ++j)
          acc[k] = fmaf(h[k][j], cj[set][q][j], acc[k]);
      }
      float* part = s_part + (t + q) * PR + g * GS + cg * NCH;
      if constexpr (NCH == 1)
        part[0] = acc[0];
      else
        *reinterpret_cast<float2*>(part) = make_float2(acc[0], acc[1]);
    }
  };
  auto run = [&](auto full, int steps) {
    prep(0, 0);
#pragma unroll 1
    for (int q0 = 0; q0 < steps; q0 += 2 * S) {
      prep(1, q0 + S);
      chain(full, 0, q0, steps);
      prep(0, min(q0 + 2 * S, TS - S));  // past the tile: read, not used
      chain(full, 1, q0 + S, steps);
    }
  };

  const int ntiles = (L + TS - 1) / TS, nchunks = num_chunks(L);
  load(0);
  for (int k = 0; k < ntiles; ++k) {
    const int t0 = k * TS, steps = min(TS, L - t0);
    if (h_in != nullptr && t0 % TL == 0) {
#pragma unroll
      for (int kk = 0; kk < NCH; ++kk) {
        if (c0 + kk >= d) continue;
        float* hrow = h_in +
                      (((size_t)b * nchunks + t0 / TL) * N + g * NPT) * d +
                      c0 + kk;
#pragma unroll
        for (int j = 0; j < NPT; ++j) hrow[(size_t)j * d] = h[kk][j];
      }
    }
    stage();
    __syncthreads();
    // the next tile's loads are in flight while this one runs
    if (k + 1 < ntiles) {
      dp += (size_t)TS * d;
      up += (size_t)TS * d;
      bp += TS * bc_sl;
      cp += TS * bc_sl;
      load(t0 + TS);
    }
    if (steps == TS)
      run(std::true_type(), steps);
    else
      run(std::false_type(), steps);
    __syncthreads();
    // y: the LPC partials of each (step, channel) of the tile, in order
    float sums[RU];
#pragma unroll
    for (int r = 0; r < RU; ++r) {
      const float* p = s_part + (su + r * ROWS) * PR + cu;
      float sum = p[0];
#pragma unroll
      for (int i = 1; i < LPC; ++i) sum += p[i * GS];
      sums[r] = sum;
    }
#pragma unroll
    for (int r = 0; r < RU; ++r)
      if (valid_u && su + r * ROWS < steps) yp[r * rstep] = sums[r];
    yp += (size_t)TS * d;
  }

#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    if (c0 + k >= d) continue;
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      h_out[((size_t)b * N + g * NPT + j) * d + c0 + k] = h[k][j];
  }
}

template <typename T, int NPT, int NCH, int NT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Lay = Layout<NPT, NCH, NT>;
  if (Lay::BYTES > 48 * 1024) {  // above 48 KB only once allowed
    const cudaError_t e = cudaFuncSetAttribute(
        scan_seq_kernel<T, NPT, NCH, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::BYTES);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.d + Lay::CPB - 1) / Lay::CPB, a.batch);
  scan_seq_kernel<T, NPT, NCH, NT><<<grid, NT, Lay::BYTES, stream>>>(
      static_cast<const T*>(a.u), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const T*>(a.bm),
      static_cast<const T*>(a.cm), static_cast<float*>(a.y),
      static_cast<float*>(a.h_out), static_cast<float*>(a.h_in), a.L, a.d,
      a.bg, a.bc_sb, a.bc_sl);
  return cudaGetLastError();
}

// the table's split (lanes, channels, threads), or an error
template <typename T, size_t... I>
cudaError_t launch_split(const Args& a, int lanes, int channels, int threads,
                         cudaStream_t stream, std::index_sequence<I...>) {
  cudaError_t e = cudaErrorInvalidValue;
  (void)((lanes == SEQ_SPLITS[I][0] && channels == SEQ_SPLITS[I][1] &&
          threads == SEQ_SPLITS[I][2] &&
          (e = launch<T, N / SEQ_SPLITS[I][0], SEQ_SPLITS[I][1],
                      SEQ_SPLITS[I][2]>(a, stream),
           true)) ||
         ...);
  return e;
}

template <typename T>
cudaError_t launch_split(const Args& a, int lanes, int channels, int threads,
                         cudaStream_t stream) {
  return launch_split<T>(
      a, lanes, channels, threads, stream,
      std::make_index_sequence<sizeof(SEQ_SPLITS) / sizeof(SEQ_SPLITS[0])>());
}

}  // namespace

// The arguments of selective_scan_fwd (selective_scan_fwd.cu) without the
// direction: u (batch, L, d) contiguous, f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); dt (batch, L, d) f32 contiguous; A (groups, d, n) f32
// contiguous; B, C (batch, L, n) in u's dtype, element (b, t, k) at
// b*bc_batch_stride + t*bc_row_stride + k; y (batch, L, d) f32; h_out
// (batch, n, d) f32; h_in null, or (batch, ceil(L / TL), n, d) f32.  n must
// be 16 and groups must divide batch.  Then the launch split: lanes per
// channel, channels a lane and threads per block, one of SEQ_SPLITS (else
// cudaErrorInvalidValue).  Launches on `stream` without synchronising and
// returns cudaGetLastError() of the launch.
extern "C" int selective_scan_seq(const void* u, const void* dt,
                                  const void* A, const void* B, const void* C,
                                  void* y, void* h_out, void* h_in,
                                  int batch, int L, int d, int n, int groups,
                                  long long bc_batch_stride,
                                  long long bc_row_stride, int is_bf16,
                                  int lanes, int channels, int threads,
                                  void* stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || d <= 0 || n != N ||
      groups <= 0 || batch % groups != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{u, dt, A, B, C, y, h_out, h_in, batch, L, d, batch / groups,
               bc_batch_stride, bc_row_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_split<__nv_bfloat16>(a, lanes, channels,
                                                     threads, s)
                       : launch_split<float>(a, lanes, channels, threads, s));
}
