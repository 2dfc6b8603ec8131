// Flash-attention forward for Hopper (sm_90a): O = softmax(q k^T * scale) v
// and the row log-sum-exp, without forming the T x T score matrix in device
// memory.
//
// Replaces: deepsense6g_tii_tpu/ops/flash_attention.py::_fwd_kernel (launched
// by _mha_fwd_pallas), the one TPU kernel on the GPT TransFuser's serving
// path: 32 launches per forward (4 fusion stages x 8 GPT blocks), at
// BH = batch * 4 heads, T = 962 and head dims 16, 32, 64 and 128.
//
// Semantics kept from the TPU kernel: scores accumulate in f32 and are then
// scaled; a running row max and row sum in f32 rescale the output
// accumulator tile by tile; the row sum takes the unrounded probabilities
// while, in bf16, P is rounded to bf16 before the P.V product (as
// `p.astype(v.dtype)` does there); O = acc / l in the input dtype and
// lse = m + log(l) in f32.  Key columns >= T are masked and their
// probabilities zeroed here, so the host pads nothing.
//
// Attention-probability dropout (training): the keep decision of every
// (bh, row, col) comes from the hash stream of flash_dropout.cuh, so the
// backward kernels regenerate the same mask from their own tiles.  As on
// the TPU, l sums the undropped probabilities and the f32 scale {0, 1/(1-p)}
// multiplies p before it is rounded for P.V; lse stays m + log(l).  With
// p == 0 the stream is skipped.
//
// Bound on an H100 SXM: 4*BH*T^2*D operations against 4*BH*T*D*bytes moved,
// about T/bytes = 481 operations per byte in bf16 at T = 962, above the
// card's ~295 balance point, so the work is bound by operations: 15.3 us
// for BH = 32, D = 128 at the 989 TFLOP/s bf16 tensor-core rate.  Not in
// that bound: one exp per T^2 element (BH*T^2 = 29.6 M a launch at B = 8,
// 7.2 us at the SFUs' 16 a clock per SM), which outweighs the products at
// D = 16 and 32, and with dropout ~11 integer operations of the hash per
// element.
//
// bf16 (the dtype the card serves and trains in): flash_fwd_mma_kernel, on
// the tensor cores.  One block of 4 warps per (bh, q tile); each warp owns
// MW m-blocks of 16 q rows (MW = 1 at D <= 32: 64-row tiles; MW = 2 at
// D >= 64: 128-row tiles, so that every k and v fragment read from shared
// memory feeds two products and a block reads k and v from L2 half as
// often).  The q tile is staged once, its A fragments held in registers
// where they fit (all but D = 128).  64-row k and v tiles go through a
// ring of two stages in shared memory, kept in bf16, filled by cp.async
// 16-byte copies (zeros past T) so that tile j + 1 arrives while tile j is
// computed.  S = q k^T and O += P v run as mma.sync.m16n8k16 (bf16
// operands, f32 accumulation), with the operands read by ldmatrix (v by
// ldmatrix.trans, its non-K-major side).  The online softmax works on the S
// accumulator fragment in registers, with log2(e) folded into the scale and
// exp2 (ex2.approx); each element's keep bit comes from the hash at its
// global (row, col).  P goes back into the tensor cores from registers: the
// m16n8 accumulators of two neighbouring 8-key blocks are exactly one
// m16n8k16 A fragment once packed to bf16.  Row sums stay per thread and
// meet across the quad once, at the end.  The epilogue writes O / l in
// bf16 and lse = m + log(l) in f32.  Why mma.sync and not wgmma: at T = 962
// a (bh, q tile) holds 15 full k tiles and one of 2 rows, and the exp and
// hash work per element is as large as the products at D <= 32; the
// simple warp-level product with register-resident P keeps the kernel
// short and its layouts checkable, and moves the forward from the CUDA
// cores' f32 rate to the tensor cores.  At D = 128 the kernel takes 255
// registers without spilling (ptxas -v, printed by chip_smoke.py).
//
// f32 (the reference dtype of chip_smoke.py's f64 checks): flash_fwd_kernel,
// the first version's exact design on the CUDA cores: TF32 tensor cores
// keep ~3 decimal digits and could not meet the f32 bounds.  One block per
// (bh, 64-row q tile) streams 64-row k/v tiles through shared memory; each
// thread keeps a 4 x 8 score tile and a 4 x D/8 output tile in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_dropout.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int BM = 64;        // q rows per block
constexpr int BN = 64;        // k/v rows per tile
constexpr int NT = 128;       // threads per block (both kernels)
constexpr int PT_LD = BM + 4; // padded stride of the f32 kernel's P tile

// -- f32, CUDA cores -----------------------------------------------------

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ float group8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Thread (ty, tx) = (tid / 8, tid % 8) owns q rows ty*4 .. ty*4+3 of the
// tile, score columns tx + 8j (j < 8) and output columns tx + 8c (c < D/8).
// The 8 threads of a row group are 8 neighbouring lanes of one warp, so row
// reductions are three shuffles.
template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int t, float sm_scale,
                 DropoutStream drop) {
  constexpr int CPT = D / 8;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][BM]  q tile, transposed
  float* kt = qt + D * BM;                      // [D][BN]  k tile, transposed
  float* vs = kt + D * BN;                      // [BN][D]  v tile
  float* pt = vs + BN * D;                      // [BN][PT_LD] P, transposed

  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int q0 = blockIdx.x * BM;
  const size_t base = (size_t)blockIdx.y * t * D;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;

  // q tile; rows past t read as zero and are never stored
  for (int idx = tid; idx < BM * D / 4; idx += NT) {
    const int r = idx % BM, d = (idx / BM) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < t) load4(qb + (size_t)(q0 + r) * D + d, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) qt[(d + e) * BM + r] = x[e];
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += BN) {
    // k (transposed) and v tiles; rows past t read as zero
    for (int idx = tid; idx < BN * D / 4; idx += NT) {
      const int r = idx % BN, d = (idx / BN) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + r < t) load4(kb + (size_t)(k0 + r) * D + d, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) kt[(d + e) * BN + r] = x[e];
    }
    for (int idx = tid; idx < BN * D / 4; idx += NT) {
      const int r = idx / (D / 4), d = (idx % (D / 4)) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + r < t) load4(vb + (size_t)(k0 + r) * D + d, x);
      *reinterpret_cast<float4*>(vs + r * D + d) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
    __syncthreads();

    // s = q k^T for this thread's 4 x 8 scores, f32 accumulation
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * BM + ty * 4);
      float b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = kt[d * BN + tx + 8 * j];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[0][j] = fmaf(a.x, b[j], s[0][j]);
        s[1][j] = fmaf(a.y, b[j], s[1][j]);
        s[2][j] = fmaf(a.z, b[j], s[2][j]);
        s[3][j] = fmaf(a.w, b[j], s[3][j]);
      }
    }

    // streaming softmax update; masked columns get p = 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = (k0 + tx + 8 * j < t) ? s[i][j] * sm_scale : -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], group8_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = (k0 + tx + 8 * j < t) ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        s[i][j] = p;
      }
      l[i] = alpha * l[i] + group8_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    if (drop.active()) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][j] = drop.keep(blockIdx.y, q0 + ty * 4 + i, k0 + tx + 8 * j)
                        ? s[i][j] * drop.scale : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(pt + (tx + 8 * j) * PT_LD + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P v
#pragma unroll 2
    for (int c = 0; c < BN; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(pt + c * PT_LD + ty * 4);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float w = vs[c * D + tx + 8 * cc];
        acc[0][cc] = fmaf(p.x, w, acc[0][cc]);
        acc[1][cc] = fmaf(p.y, w, acc[1][cc]);
        acc[2][cc] = fmaf(p.z, w, acc[2][cc]);
        acc[3][cc] = fmaf(p.w, w, acc[3][cc]);
      }
    }
    __syncthreads();  // the next tile overwrites kt, vs and pt
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= t) continue;
    float* orow = o + base + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 8 * c] = acc[i][c] / l[i];
    if (tx == 0) lse[(size_t)blockIdx.y * t + row] = m[i] + logf(l[i]);
  }
}

// -- bf16, tensor cores --------------------------------------------------

// q rows a warp owns, in 16-row m-blocks: 2 at D >= 64, where each k and v
// fragment read from shared memory then feeds two products and a block
// reads k and v from L2 half as often; 1 at D <= 32, where the exp and
// softmax work per element dominates and more, smaller blocks hide it.
template <int D>
__host__ __device__ constexpr int m_blocks() { return D >= 64 ? 2 : 1; }

template <int D>
constexpr int mma_smem_bytes() {
  // the q tile and 2 stages of (k, v) tiles, rows of D + 8 bf16
  return (4 * m_blocks<D>() * 16 + 4 * BN) * (D + 8) *
         (int)sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int t, float sm_scale, DropoutStream drop) {
  using namespace fmma;
  constexpr int MW = m_blocks<D>();  // m-blocks a warp
  constexpr int BQ = 4 * 16 * MW;    // q rows a block
  constexpr int LD = D + 8;          // shared row stride, bf16 elements
  constexpr int KT = BN * LD;        // one k or v tile
  constexpr int KB = D / 16;         // k-blocks of S = q k^T
  constexpr int NB = D / 8;          // 8-column blocks of O
  // hold the warp's q fragments in registers when they are few
  constexpr bool QREG = MW * KB <= 8;
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BQ * LD;  // 2 stages
  __nv_bfloat16* vs = ks + 2 * KT;   // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int q0 = blockIdx.x * BQ, w0 = warp * 16 * MW;  // w0: warp's rows
  const uint32_t bh = blockIdx.y;
  const size_t base = (size_t)bh * t * D;
  const int n_tiles = (t + BN - 1) / BN;

  load_rows<D, NT, BQ>(qs, q + base, q0, t);
  load_rows<D, NT, BN>(ks, k + base, 0, t);
  load_rows<D, NT, BN>(vs, v + base, 0, t);
  cp_async_commit();

  uint32_t qf[QREG ? MW : 1][QREG ? KB : 1][4];  // q as A fragments
  float acc[MW][NB][4];
  float m[MW][2], l[MW][2];  // raw row max of s; this thread's row sums
  uint32_t rid[MW][2];       // dropout ids of this thread's rows
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][c][e] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mi][r] = -INFINITY;
      l[mi][r] = 0.f;
      rid[mi][r] = drop.row_id(bh, q0 + w0 + 16 * mi + g + 8 * r);
    }
  }
  const float sl2 = sm_scale * LOG2E;
  auto q_frag = [&](uint32_t (&a)[4], int mi, int kk) {
    ldsm_x4(a, qs + (w0 + 16 * mi + (lane & 15)) * LD + kk * 16 +
                   (lane >> 4) * 8);
  };

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1, k0 = j * BN;
    if (j + 1 < n_tiles) {
      load_rows<D, NT, BN>(ks + (st ^ 1) * KT, k + base, k0 + BN, t);
      load_rows<D, NT, BN>(vs + (st ^ 1) * KT, v + base, k0 + BN, t);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and the q tile) have landed
    __syncthreads();
    if constexpr (QREG) {
      if (j == 0) {
#pragma unroll
        for (int mi = 0; mi < MW; ++mi)
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) q_frag(qf[mi][kk], mi, kk);
      }
    }
    const __nv_bfloat16* kt = ks + st * KT;
    const __nv_bfloat16* vt = vs + st * KT;

    // S = q k^T: 16 rows x 64 keys an m-block, 8 blocks of 8 keys
    float s[MW][8][4];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mi][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      uint32_t qa[MW][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[mi][e] = qf[mi][kk][e];
        } else {
          q_frag(qa[mi], mi, kk);
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];  // keys 16np..16np+15: b0, b1 of two key blocks
        ldsm_x4(b, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                       kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          mma(s[mi][2 * np], qa[mi], b[0], b[1]);
          mma(s[mi][2 * np + 1], qa[mi], b[2], b[3]);
        }
      }
    }

    // online softmax on the fragment: element (n, e) of m-block mi is row
    // w0 + 16 mi + g + 8 (e / 2), key k0 + 8n + 2tq + e % 2.  Only the
    // last tile holds keys >= t: the mask runs there alone.
    if (k0 + BN > t) {
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * n + 2 * tq + (e & 1) >= t) s[mi][n][e] = -INFINITY;
    }
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[mi][r];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) mx = fmaxf(mx, s[mi][n][2 * r + e]);
        mx = quad_max(mx);  // finite: every tile holds a key < t
        // 0 on the first tile, where m is -inf
        const float alpha = exp2_approx((m[mi][r] - mx) * sl2);
        const float mb = mx * sl2;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2_approx(fmaf(s[mi][n][2 * r + e], sl2, -mb));
            sum += p;
            s[mi][n][2 * r + e] = p;
          }
        l[mi][r] = alpha * l[mi][r] + sum;
        m[mi][r] = mx;
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          acc[mi][c][2 * r] *= alpha;
          acc[mi][c][2 * r + 1] *= alpha;
        }
      }
    if (drop.active()) {
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t col = k0 + 8 * n + 2 * tq + (e & 1);
            s[mi][n][e] = drop.keep_id(rid[mi][e >> 1] + col)
                              ? s[mi][n][e] * drop.scale : 0.f;
          }
    }

    // O += P v, P rounded to bf16: key block pair (2kb, 2kb + 1) is the
    // A fragment of keys 16kb..16kb+15
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      uint32_t pa[MW][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        pa[mi][0] = pack_bf16(s[mi][2 * kb][0], s[mi][2 * kb][1]);
        pa[mi][1] = pack_bf16(s[mi][2 * kb][2], s[mi][2 * kb][3]);
        pa[mi][2] = pack_bf16(s[mi][2 * kb + 1][0], s[mi][2 * kb + 1][1]);
        pa[mi][3] = pack_bf16(s[mi][2 * kb + 1][2], s[mi][2 * kb + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < NB / 2; ++dp) {
        uint32_t b[4];  // dims 16dp..16dp+15: b0, b1 of two dim blocks
        ldsm_x4_t(b, vt + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                         dp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          mma(acc[mi][2 * dp], pa[mi], b[0], b[1]);
          mma(acc[mi][2 * dp + 1], pa[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = quad_sum(l[mi][r]);
      const int row = q0 + w0 + 16 * mi + g + 8 * r;
      if (row >= t) continue;
      __nv_bfloat16* orow = o + base + (size_t)row * D;
#pragma unroll
      for (int c = 0; c < NB; ++c)
        *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * tq) =
            pack_bf16(acc[mi][c][2 * r] / lr, acc[mi][c][2 * r + 1] / lr);
      if (tq == 0) lse[(size_t)bh * t + row] = m[mi][r] * sm_scale + logf(lr);
    }
}

// -- launch --------------------------------------------------------------

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t, float sm_scale,
                       DropoutStream drop, cudaStream_t stream) {
  const int smem = (D * BM + 2 * D * BN + BN * PT_LD) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + BM - 1) / BM, bh);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), t, sm_scale, drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int t, float sm_scale,
                        DropoutStream drop, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + 64 * m_blocks<D>() - 1) / (64 * m_blocks<D>()), bh);
  flash_fwd_mma_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), t, sm_scale, drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int is_bf16, const void* q, const void* k, const void* v,
                   void* o, void* lse, int bh, int t, float sm_scale,
                   DropoutStream drop, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(q, k, v, o, lse, bh, t, sm_scale, drop,
                                  stream)
                 : launch_f32<D>(q, k, v, o, lse, bh, t, sm_scale, drop,
                                 stream);
}

}  // namespace

// q, k, v, o: (bh, t, d) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// 16-byte aligned; lse: (bh, t) f32.  keep_min > 0 drops attention
// probabilities by the hash stream of (seed, t_pad) (keep_min = ceil(p *
// 2^24), flash_dropout.cuh) and scales the kept ones by drop_scale.
// Launches on `stream` without synchronising and returns cudaGetLastError()
// of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int bh,
                                   int t, int d, int is_bf16, float sm_scale,
                                   uint32_t keep_min, float drop_scale,
                                   uint32_t seed, int t_pad, void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0 || t_pad < t)
    return (int)cudaErrorInvalidValue;
  const DropoutStream drop{keep_min, drop_scale, seed, (uint32_t)t_pad};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return (int)launch<16>(is_bf16, q, k, v, o, lse, bh, t, sm_scale, drop, s);
    case 32: return (int)launch<32>(is_bf16, q, k, v, o, lse, bh, t, sm_scale, drop, s);
    case 64: return (int)launch<64>(is_bf16, q, k, v, o, lse, bh, t, sm_scale, drop, s);
    case 128: return (int)launch<128>(is_bf16, q, k, v, o, lse, bh, t, sm_scale, drop, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
