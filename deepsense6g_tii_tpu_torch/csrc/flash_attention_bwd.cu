// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of
// O = softmax(q k^T * scale) v with hash dropout, from q, k, v, dO, the
// forward's row lse and dvec = rowsum(dO * O) (f32), recomputing
// P = exp(s * scale - lse) tile by tile instead of storing it.
//
// Replaces: deepsense6g_tii_tpu/ops/flash_attention.py::_merged_bwd_kernel
// (flash_bwd_merged here), ::_dq_kernel and ::_dkv_kernel (flash_bwd_split),
// launched by _mha_bwd_pallas.  The GPT TransFuser's training step runs the
// merged one: 32 launches per step (4 fusion stages x 8 GPT blocks) at
// BH = batch * 4 heads, T = 962, head dims 16..128.  The split pair runs
// with DEEPSENSE_FLASH_BWD=split or, under `auto`, at long T; it is the
// deterministic backward (no atomics) and the cross-check of the merged one.
//
// Per (bh) row block, with keep from the shared hash (flash_dropout.cuh),
// c = 1/(1-p) rounded to the input dtype, and P and dS rounded to the input
// dtype before their products, as on the TPU:
//   dP_d = keep * (dO (c v)^T)        dS = P * (dP_d - dvec) * scale
//   dv   = (keep * P)^T (c dO)        dk = dS^T q        dq = dS k
// Products accumulate in f32; outputs are in the input dtype.  Rows and
// columns >= T are masked here (P = 0), so the host pads nothing; the
// dropout ids still use t_pad (the JAX package's 512-block padding).
//
// Design.  The TPU kernels walked a sequential grid and carried dk/dv (and
// dq) in VMEM from step to step.  Hopper blocks run in parallel and in no
// order, so each block owns one output tile and loops over the other axis
// inside the block, keeping its sums in registers:
// - dk/dv (merged and split): a block owns a 64-row k/v tile of one bh and
//   loops over all 64-row q tiles;
// - dq (split): a block owns a q tile and loops over all 64-row k/v tiles.
// Merged, the dk/dv block also forms its tile's dS k and adds it into an
// f32 (bh, T, d) dq buffer with atomics (the order of that sum changes from
// run to run), and a cast pass in the same call writes dq in bf16: one
// recompute of P per tile where the split pair makes two.  The merged and
// the split entry start with a prologue kernel that forms dvec =
// rowsum(dO * O) in f32 from o and dO (and, merged, zeros the f32 dq
// buffer): one pass over them, where PyTorch took five kernels.
//
// bf16 (the training dtype), on the tensor cores: mma.sync.m16n8k16 (bf16
// operands, f32 accumulation) with operands read by ldmatrix from bf16
// tiles in shared memory (rows of D + 8, flash_mma.cuh) that cp.async
// fills; c v is rounded in registers by one bf16 multiply, which rounds as
// the plain version's f32 product rounded to bf16 does.
// - flash_bwd_mma_kernel (merged) and flash_bwd_dkv_mma_kernel (split) are
//   one body, kv_block<D, DQ>.  4 warps; warp w owns k/v rows 16w..16w+15.
//   k and v are staged once; q, dO, lse and dvec go through a ring of two
//   stages so that q tile i + 1 arrives while tile i is computed.  Per
//   16-row chunk of the q tile, S^T = k q^T and dP^T = (c v) dO^T (the k
//   and c v fragments stay in registers across the loop at D <= 64 and are
//   read again each chunk at D = 128); P = exp2(s * scale * log2 e -
//   lse log2 e), keep from the hash at its global (q row, k col); the
//   dropped P and dS go back into the tensor cores from registers as A
//   fragments: dV += (keep P)^T (c dO) and dK += dS^T q, accumulated in
//   registers over the whole loop (2 * D / 2 f32 a thread).  Merged (DQ)
//   only: dS^T goes to shared memory; after one barrier each warp forms
//   dq = dS k for 16 q rows (<= 64 columns a pass) and adds it with float2
//   atomics (RED.E.ADD.F32x2 on sm_90), as FlashAttention-2 does.
// - flash_bwd_dq_mma_kernel (split), shaped like the forward
//   (flash_attention_fwd.cu): 4 warps, each owning MW m-blocks of 16 q rows
//   (MW = 2 at D = 64: 128-row tiles; 1 otherwise: 64-row tiles, as at
//   D = 128 two m-blocks' q and dO fragments and dq sums would not fit the
//   255 registers).  The q and dO tiles are staged once and held in
//   registers as A fragments (MW * D / 16 <= 8 of each); each row's lse and
//   dvec in registers.  64-row k and v tiles pass through a 2-stage
//   cp.async ring, zeros past T.  Per 16-key chunk of a tile: S = q k^T and
//   dP = dO (c v)^T, P, keep and dS = P (keep dP - dvec) scale rounded to
//   bf16; the two 8-key accumulator blocks of dS are one A fragment, as the
//   forward feeds P, and dq += dS k runs with k read by ldmatrix.trans.  dq
//   accumulates in f32 registers over all k tiles and is written once in
//   bf16: no f32 buffer, no atomics, no cast pass.
// Why mma.sync and not wgmma: the products per tile are 64 x 64 x D, their
// operands change roles (transposed, from registers, from shared memory)
// from product to product, and the exp and hash per element weigh as much
// as the products at small D; the warp-level product keeps each layout
// explicit.
//
// f32: the first version's design on the CUDA cores (TF32 tensor cores
// could not meet the f32 bounds): the dkv kernel (merged: it also adds dS k
// into dq with atomicAdd) and the dq kernel, one block per 64-row tile.
// Each block has 256 threads: thread (ty, tx) = (tid / 8, tid % 8) owns
// tile rows 2ty, 2ty+1 and columns tx + 8j of the 64 x 64 score tile, and
// output columns tx + 8c of its two rows.  Operands sit in shared memory in
// f32, transposed or row-major with a padded stride so that the inner
// loops read without bank conflicts.
//
// Bound on an H100 SXM: the function needs 10 * BH * T^2 * D operations
// (five T x T x D products) against ~ (8 BH T D elements + 2 BH T f32)
// bytes, so it is bound by operations: 0.575 ms per training step at the
// bf16 tensor-core rate over the step's 32 launches.  The split pair
// recomputes S and dP in both kernels: 6 (dq) + 8 (dk/dv) * BH * T^2 * D
// operations.  Not in the bound: one exp per T^2 element per kernel (7.2
// us a launch at B = 8 at the SFUs' rate) and, with dropout, the hash.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_dropout.cuh"
#include "flash_mma.cuh"

namespace {

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *dvec;
  void *dq, *dk, *dv;
  float* dq_acc;  // merged: f32 (bh, t, d) buffer of zeros
  int t;
  float sm_scale, c_in;  // c_in: 1/(1-p) rounded to the input dtype
  DropoutStream drop;
};

constexpr int TILE = 64;  // rows of a k/v tile (and of an f32 q tile)

// -- f32, CUDA cores ---------------------------------------------------------

constexpr int NT = 256;        // threads per block: 32 row pairs x 8 lanes
constexpr int LDT = TILE + 4;  // padded stride of transposed / score tiles

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// rows [r0, r0 + 64) of a (t, D) matrix into shared memory, scaled by `mul`
// (mul = 1 leaves values unchanged); rows past t read as zero.  TRANS
// stores element (r, d) at dst[d * LDT + r], otherwise at
// dst[r * (D + 4) + d].
template <bool TRANS, int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int t, float mul) {
  for (int idx = threadIdx.x; idx < TILE * D / 4; idx += NT) {
    const int r = TRANS ? idx % TILE : idx / (D / 4);
    const int d = TRANS ? (idx / TILE) * 4 : (idx % (D / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < t) load4(src + (size_t)(r0 + r) * D + d, x);
    if (mul != 1.f) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] *= mul;
    }
    if (TRANS) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[(d + e) * LDT + r] = x[e];
    } else {
      *reinterpret_cast<float4*>(dst + r * (D + 4) + d) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

// out[i][j] = sum_d A[row 2ty+i, d] * B[row tx+8j, d], A transposed
// (a[d * LDT + r]) and B row-major (b[r * (D + 4) + d])
template <int D>
__device__ __forceinline__ void tile_product(float (&out)[2][8],
                                             const float* a, const float* b,
                                             int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float2 x = *reinterpret_cast<const float2*>(a + d * LDT + 2 * ty);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float y = b[(tx + 8 * j) * (D + 4) + d];
      out[0][j] = fmaf(x.x, y, out[0][j]);
      out[1][j] = fmaf(x.y, y, out[1][j]);
    }
  }
}

// acc[i][c] += sum_{n < 64} X(2ty+i, n) * Y(n, tx + 8c), X(r, n) at
// x[r * XR + n * XN] and Y(n, col) at y[n * YN + col * YC]; with ymul != 1
// each Y value is scaled first
template <int D, int XR, int XN, int YN, int YC>
__device__ __forceinline__ void accumulate(float (&acc)[2][D / 8],
                                           const float* x, const float* y,
                                           int ty, int tx, float ymul) {
#pragma unroll 2
  for (int n = 0; n < TILE; ++n) {
    const float x0 = x[(2 * ty) * XR + n * XN];
    const float x1 = x[(2 * ty + 1) * XR + n * XN];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      float w = y[n * YN + (tx + 8 * c) * YC];
      if (ymul != 1.f) w *= ymul;
      acc[0][c] = fmaf(x0, w, acc[0][c]);
      acc[1][c] = fmaf(x1, w, acc[1][c]);
    }
  }
}

// P, the dropped dP and dS of one tile element, as the TPU kernels form
// them; `valid` masks rows and columns >= T
struct GradElem {
  float pd, ds;
};

__device__ __forceinline__ GradElem grad_elem(float s, float dp, float lse,
                                              float dvec, bool valid,
                                              bool keep, float sm_scale) {
  const float p = valid ? expf(s * sm_scale - lse) : 0.f;
  const float dpd = keep ? dp : 0.f;
  return {keep ? p : 0.f, p * (dpd - dvec) * sm_scale};
}

template <int D>
constexpr int smem_bytes() {
  return (2 * D * LDT + 2 * TILE * (D + 4) + 2 * TILE * LDT + 2 * TILE) *
         (int)sizeof(float);
}

// One block per (k/v tile, bh).  MERGED adds dS k into args.dq_acc.
template <int D, bool MERGED>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(BwdArgs args) {
  constexpr int CPT = D / 8;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [D][LDT] k, transposed
  float* cvt = kt + D * LDT;                    // [D][LDT] c*v, transposed
  float* qs = cvt + D * LDT;                    // [64][D+4] q
  float* dos = qs + TILE * (D + 4);             // [64][D+4] dO
  float* pds = dos + TILE * (D + 4);            // [k row][LDT] dropped P
  float* dss = pds + TILE * LDT;                // [k row][LDT] dS
  float* lse_s = dss + TILE * LDT;              // [64]
  float* dvec_s = lse_s + TILE;                 // [64]

  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int t = args.t, k0 = blockIdx.x * TILE;
  const uint32_t bh = blockIdx.y;
  const size_t base = (size_t)bh * t * D;
  const float* qb = static_cast<const float*>(args.q) + base;
  const float* dob = static_cast<const float*>(args.dout) + base;
  const float* lseb = static_cast<const float*>(args.lse) + (size_t)bh * t;
  const float* dvecb = static_cast<const float*>(args.dvec) + (size_t)bh * t;

  load_tile<true, D>(kt, static_cast<const float*>(args.k) + base, k0, t,
                     1.f);
  load_tile<true, D>(cvt, static_cast<const float*>(args.v) + base, k0, t,
                     args.c_in);

  float dk[2][CPT], dv[2][CPT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = 0; q0 < t; q0 += TILE) {
    load_tile<false, D>(qs, qb, q0, t, 1.f);
    load_tile<false, D>(dos, dob, q0, t, 1.f);
    if (tid < TILE) {
      lse_s[tid] = q0 + tid < t ? lseb[q0 + tid] : 0.f;
      dvec_s[tid] = q0 + tid < t ? dvecb[q0 + tid] : 0.f;
    }
    __syncthreads();

    // transposed tile: rows are k rows 2ty+i, columns q rows tx+8j
    float s[2][8], dp[2][8];
    tile_product<D>(s, kt, qs, ty, tx);
    tile_product<D>(dp, cvt, dos, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = 2 * ty + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = tx + 8 * j;
        const bool valid = k0 + kr < t && q0 + qc < t;
        const bool keep = !args.drop.active() ||
                          args.drop.keep(bh, q0 + qc, k0 + kr);
        const GradElem g = grad_elem(s[i][j], dp[i][j], lse_s[qc],
                                     dvec_s[qc], valid, keep, args.sm_scale);
        pds[kr * LDT + qc] = g.pd;
        dss[kr * LDT + qc] = g.ds;
      }
    }
    __syncthreads();

    // dv += (keep P)^T (c dO);  dk += dS^T q
    accumulate<D, LDT, 1, D + 4, 1>(dv, pds, dos, ty, tx, args.c_in);
    accumulate<D, LDT, 1, D + 4, 1>(dk, dss, qs, ty, tx, 1.f);
    if (MERGED) {
      // this tile's dq rows q0 + 2ty + i: sum over k rows of dS k
      float dq[2][CPT];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) dq[i][c] = 0.f;
      accumulate<D, 1, LDT, 1, LDT>(dq, dss, kt, ty, tx, 1.f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + 2 * ty + i;
        if (row >= t) continue;
        float* dst = args.dq_acc + base + (size_t)row * D;
#pragma unroll
        for (int c = 0; c < CPT; ++c) atomicAdd(dst + tx + 8 * c, dq[i][c]);
      }
    }
    __syncthreads();  // the next q tile overwrites qs, dos, pds and dss
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + 2 * ty + i;
    if (row >= t) continue;
    float* dkrow = static_cast<float*>(args.dk) + base + (size_t)row * D;
    float* dvrow = static_cast<float*>(args.dv) + base + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dkrow[tx + 8 * c] = dk[i][c];
      dvrow[tx + 8 * c] = dv[i][c];
    }
  }
}

// One block per (q tile, bh): dq = sum over k tiles of dS k.
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(BwdArgs args) {
  constexpr int CPT = D / 8;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][LDT] q, transposed
  float* dot = qt + D * LDT;                    // [D][LDT] dO, transposed
  float* ks = dot + D * LDT;                    // [64][D+4] k
  float* cvs = ks + TILE * (D + 4);             // [64][D+4] c*v
  float* dss = cvs + TILE * (D + 4);            // [k row][LDT] dS
  float* lse_s = dss + 2 * TILE * LDT;          // [64]
  float* dvec_s = lse_s + TILE;                 // [64]

  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int t = args.t, q0 = blockIdx.x * TILE;
  const uint32_t bh = blockIdx.y;
  const size_t base = (size_t)bh * t * D;
  const float* kb = static_cast<const float*>(args.k) + base;
  const float* vb = static_cast<const float*>(args.v) + base;

  load_tile<true, D>(qt, static_cast<const float*>(args.q) + base, q0, t,
                     1.f);
  load_tile<true, D>(dot, static_cast<const float*>(args.dout) + base, q0, t,
                     1.f);
  if (tid < TILE) {
    const float* lseb = static_cast<const float*>(args.lse) + (size_t)bh * t;
    const float* dvecb = static_cast<const float*>(args.dvec) + (size_t)bh * t;
    lse_s[tid] = q0 + tid < t ? lseb[q0 + tid] : 0.f;
    dvec_s[tid] = q0 + tid < t ? dvecb[q0 + tid] : 0.f;
  }

  float dq[2][CPT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq[i][c] = 0.f;

  for (int k0 = 0; k0 < t; k0 += TILE) {
    load_tile<false, D>(ks, kb, k0, t, 1.f);
    load_tile<false, D>(cvs, vb, k0, t, args.c_in);
    __syncthreads();

    // rows are q rows 2ty+i, columns k rows tx+8j
    float s[2][8], dp[2][8];
    tile_product<D>(s, qt, ks, ty, tx);
    tile_product<D>(dp, dot, cvs, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = 2 * ty + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kc = tx + 8 * j;
        const bool valid = q0 + qr < t && k0 + kc < t;
        const bool keep = !args.drop.active() ||
                          args.drop.keep(bh, q0 + qr, k0 + kc);
        const GradElem g = grad_elem(s[i][j], dp[i][j], lse_s[qr],
                                     dvec_s[qr], valid, keep, args.sm_scale);
        dss[kc * LDT + qr] = g.ds;
      }
    }
    __syncthreads();

    accumulate<D, 1, LDT, D + 4, 1>(dq, dss, ks, ty, tx, 1.f);
    __syncthreads();  // the next k tile overwrites ks, cvs and dss
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 2 * ty + i;
    if (row >= t) continue;
    float* dqrow = static_cast<float*>(args.dq) + base + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dqrow[tx + 8 * c] = dq[i][c];
  }
}

// -- bf16, tensor cores ------------------------------------------------------

constexpr int MMA_NT = 128;  // 4 warps

template <int D, bool DQ>
constexpr int kv_smem_bytes() {
  // k, c-less v, 2 stages of (q, dO) in bf16 rows of D + 8; merged, dS^T in
  // bf16 rows of 72; 2 stages of (lse, dvec) in f32
  return (6 * TILE * (D + 8) + (DQ ? TILE * (TILE + 8) : 0)) *
             (int)sizeof(__nv_bfloat16) +
         4 * TILE * (int)sizeof(float);
}

// The body of one (k/v tile, bh) block, looping over the q tiles.  Per q
// tile, warp w forms the transposed scores S^T = k q^T and dP^T = (c v)
// dO^T of its 16 k/v rows in 16-column chunks, then P, the dropped P and dS
// in registers, and feeds them back as m16n8k16 A fragments: dV += (keep
// P)^T (c dO) and dK += dS^T q accumulate in registers across the loop.
// DQ (merged): dS^T goes to shared memory; after one barrier each warp
// forms dq for 16 q rows of the tile, dS k, and adds it into the f32 buffer
// with vector atomics.
template <int D, bool DQ>
__device__ __forceinline__ void kv_block(const BwdArgs& args,
                                         uint4* smem_raw) {
  using namespace fmma;
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8, TL = TILE * LD;
  constexpr int LDS = TILE + 8;            // dS^T row stride
  constexpr int KB = D / 16, NB = D / 8;
  constexpr int QNB = NB < 8 ? NB : 8;     // dq: 8-column blocks a pass
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + TL;
  bf16* qs = vs + TL;                      // 2 stages
  bf16* dos = qs + 2 * TL;                 // 2 stages
  bf16* dst = dos + 2 * TL;                // DQ: [k/v row][LDS]  dS^T
  float* lse_s = reinterpret_cast<float*>(dst + (DQ ? TILE * LDS : 0));
  float* dvec_s = lse_s + 2 * TILE;        // lse_s, dvec_s: 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int t = args.t, k0 = blockIdx.x * TILE;
  const uint32_t bh = blockIdx.y;
  const size_t base = (size_t)bh * t * D;
  const bf16* qb = static_cast<const bf16*>(args.q) + base;
  const bf16* dob = static_cast<const bf16*>(args.dout) + base;
  const float* lseb = static_cast<const float*>(args.lse) + (size_t)bh * t;
  const float* dvecb = static_cast<const float*>(args.dvec) + (size_t)bh * t;
  const int n_q = (t + TILE - 1) / TILE;

  auto load_q = [&](int i, int st) {
    load_rows<D, MMA_NT, TILE>(qs + st * TL, qb, i * TILE, t);
    load_rows<D, MMA_NT, TILE>(dos + st * TL, dob, i * TILE, t);
    const int r = threadIdx.x % TILE, row = i * TILE + r;
    const bool ok = row < t;
    if (threadIdx.x < TILE)
      cp_async4(lse_s + st * TILE + r, lseb + (ok ? row : 0), ok);
    else
      cp_async4(dvec_s + st * TILE + r, dvecb + (ok ? row : 0), ok);
  };
  load_rows<D, MMA_NT, TILE>(ks, static_cast<const bf16*>(args.k) + base, k0, t);
  load_rows<D, MMA_NT, TILE>(vs, static_cast<const bf16*>(args.v) + base, k0, t);
  load_q(0, 0);
  cp_async_commit();

  const bool drop_on = args.drop.active();
  const uint32_t c2 = pack_bf16(args.c_in, args.c_in);  // exact: c is bf16
  const float sm = args.sm_scale, sl2 = sm * LOG2E;
  const int kr = warp * 16 + g;  // this thread's k/v rows kr, kr + 8
  const bool kvalid[2] = {k0 + kr < t, k0 + kr + 8 < t};
  float dv[NB][4], dk[NB][4];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[c][e] = dk[c][e] = 0.f;
  // the warp's k and c v rows as A fragments: held in registers across
  // the loop when they are few (D <= 64), else read for each chunk
  constexpr bool KVREG = KB <= 4;
  uint32_t kf[KVREG ? KB : 1][4], vf[KVREG ? KB : 1][4];
  auto kv_frag = [&](uint32_t (&ka)[4], uint32_t (&va)[4], int kk) {
    const int arow = (warp * 16 + (lane & 15)) * LD + kk * 16 +
                     (lane >> 4) * 8;
    ldsm_x4(ka, ks + arow);
    ldsm_x4(va, vs + arow);
    if (drop_on) {
#pragma unroll
      for (int e = 0; e < 4; ++e) va[e] = mul_bf16x2(va[e], c2);
    }
  };

  for (int i = 0; i < n_q; ++i) {
    const int st = i & 1, q0 = i * TILE;
    if (i + 1 < n_q) load_q(i + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // q tile i (and the k/v tile) have landed
    __syncthreads();
    if constexpr (KVREG) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) kv_frag(kf[kk], vf[kk], kk);
      }
    }
    const bf16* qt = qs + st * TL;
    const bf16* dot = dos + st * TL;
    const float* ls = lse_s + st * TILE;
    const float* dvs = dvec_s + st * TILE;
    const bool edge = k0 + TILE > t || q0 + TILE > t;  // rows past t here

#pragma unroll 1
    for (int ch = 0; ch < TILE / 16; ++ch) {  // 16 q rows a chunk
      // S^T and dP^T of this warp's 16 k/v rows x the chunk's 16 q rows
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        uint32_t ka[4], va[4], b[4];
        if constexpr (KVREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[kk][e];
            va[e] = vf[kk][e];
          }
        } else {
          kv_frag(ka, va, kk);
        }
        const int brow = (ch * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                         kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(b, qt + brow);
        mma(s[0], ka, b[0], b[1]);
        mma(s[1], ka, b[2], b[3]);
        ldsm_x4(b, dot + brow);
        mma(dp[0], va, b[0], b[1]);
        mma(dp[1], va, b[2], b[3]);
      }

      // element (n, e): k/v row kr + 8 (e / 2), q column
      // ch * 16 + 8n + 2tq + e % 2 of the tile.  Rows past t were read as
      // zeros (s = 0, lse = 0), so exp is finite there; only the last k/v
      // or q tile holds them, and there alone P is masked to 0.
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = ch * 16 + 8 * n + 2 * tq + (e & 1);
          s[n][e] = exp2_approx(fmaf(s[n][e], sl2, -ls[qc] * LOG2E));
        }
      if (edge) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qrow = q0 + ch * 16 + 8 * n + 2 * tq + (e & 1);
            if (!kvalid[e >> 1] || qrow >= t) s[n][e] = 0.f;
          }
      }
      float pd[2][4], ds[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = ch * 16 + 8 * n + 2 * tq + (e & 1);
          const float p = s[n][e];
          const bool keep =
              !drop_on ||
              args.drop.keep(bh, q0 + qc, k0 + kr + 8 * (e >> 1));
          const float dpd = keep ? dp[n][e] : 0.f;
          pd[n][e] = keep ? p : 0.f;
          ds[n][e] = p * (dpd - dvs[qc]) * sm;
        }
      // rounded to bf16 as A fragments (k/v rows x q rows)
      const uint32_t pa[4] = {pack_bf16(pd[0][0], pd[0][1]),
                              pack_bf16(pd[0][2], pd[0][3]),
                              pack_bf16(pd[1][0], pd[1][1]),
                              pack_bf16(pd[1][2], pd[1][3])};
      const uint32_t sa[4] = {pack_bf16(ds[0][0], ds[0][1]),
                              pack_bf16(ds[0][2], ds[0][3]),
                              pack_bf16(ds[1][0], ds[1][1]),
                              pack_bf16(ds[1][2], ds[1][3])};
      if constexpr (DQ) {
        bf16* drow = dst + kr * LDS + ch * 16 + 2 * tq;
        *reinterpret_cast<uint32_t*>(drow) = sa[0];
        *reinterpret_cast<uint32_t*>(drow + 8 * LDS) = sa[1];
        *reinterpret_cast<uint32_t*>(drow + 8) = sa[2];
        *reinterpret_cast<uint32_t*>(drow + 8 * LDS + 8) = sa[3];
      }

      // dV += (keep P)^T (c dO), dK += dS^T q over the chunk's q rows
#pragma unroll
      for (int dp2 = 0; dp2 < NB / 2; ++dp2) {
        uint32_t b[4];
        const int brow = (ch * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                         dp2 * 16 + (lane >> 4) * 8;
        ldsm_x4_t(b, dot + brow);
        if (drop_on) {
#pragma unroll
          for (int e = 0; e < 4; ++e) b[e] = mul_bf16x2(b[e], c2);
        }
        mma(dv[2 * dp2], pa, b[0], b[1]);
        mma(dv[2 * dp2 + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, qt + brow);
        mma(dk[2 * dp2], sa, b[0], b[1]);
        mma(dk[2 * dp2 + 1], sa, b[2], b[3]);
      }
    }
    // DQ: dS^T of the whole tile is in shared memory; both: every warp is
    // done with this stage before the next iteration's copies refill it
    __syncthreads();

    if constexpr (DQ) {
      // dq of q rows q0 + 16w .. +15: dS k over the 64 k/v rows, <= 64
      // columns a pass
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 8 * QNB) {
        float dq[QNB][4];
#pragma unroll
        for (int c = 0; c < QNB; ++c)
          dq[c][0] = dq[c][1] = dq[c][2] = dq[c][3] = 0.f;
#pragma unroll
        for (int kb = 0; kb < TILE / 16; ++kb) {
          uint32_t a[4];
          ldsm_x4_t(a, dst + (kb * 16 + (lane & 7) + (lane >> 4) * 8) * LDS +
                           warp * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int np = 0; np < QNB / 2; ++np) {
            uint32_t b[4];
            ldsm_x4_t(b, ks + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  LD + d0 + np * 16 + (lane >> 4) * 8);
            mma(dq[2 * np], a, b[0], b[1]);
            mma(dq[2 * np + 1], a, b[2], b[3]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + warp * 16 + g + 8 * r;
          if (row >= t) continue;
          float* dst_row = args.dq_acc + base + (size_t)row * D + d0 + 2 * tq;
#pragma unroll
          for (int c = 0; c < QNB; ++c)
            atomicAdd(reinterpret_cast<float2*>(dst_row + 8 * c),
                      make_float2(dq[c][2 * r], dq[c][2 * r + 1]));
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + kr + 8 * r;
    if (row >= t) continue;
    bf16* dkrow = static_cast<bf16*>(args.dk) + base + (size_t)row * D;
    bf16* dvrow = static_cast<bf16*>(args.dv) + base + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      *reinterpret_cast<uint32_t*>(dkrow + 8 * c + 2 * tq) =
          pack_bf16(dk[c][2 * r], dk[c][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvrow + 8 * c + 2 * tq) =
          pack_bf16(dv[c][2 * r], dv[c][2 * r + 1]);
    }
  }
}

// merged: dk, dv and the atomic dq sums
template <int D>
__global__ void __launch_bounds__(MMA_NT) flash_bwd_mma_kernel(BwdArgs args) {
  extern __shared__ uint4 smem_raw[];
  kv_block<D, true>(args, smem_raw);
}

// split: dk and dv alone
template <int D>
__global__ void __launch_bounds__(MMA_NT)
flash_bwd_dkv_mma_kernel(BwdArgs args) {
  extern __shared__ uint4 smem_raw[];
  kv_block<D, false>(args, smem_raw);
}

// q rows a warp owns in the dq kernel, in 16-row m-blocks: 2 at D = 64
// (128-row tiles, so that each k fragment read from shared memory feeds
// two products), 1 at D <= 32 (more, smaller blocks) and at D = 128 (two
// m-blocks' fragments and sums would not fit the registers).  Timed on
// the card against 1 everywhere and 2 at D <= 64 (PERF.md).
template <int D>
__host__ __device__ constexpr int dq_m_blocks() { return D == 64 ? 2 : 1; }

template <int D>
constexpr int dq_smem_bytes() {
  // the q and dO tiles and 2 stages of (k, v) tiles, rows of D + 8 bf16
  return (2 * 64 * dq_m_blocks<D>() + 4 * TILE) * (D + 8) *
         (int)sizeof(__nv_bfloat16);
}

// split: one block per (q tile, bh); dq = sum over the k tiles of dS k
template <int D>
__global__ void __launch_bounds__(MMA_NT)
flash_bwd_dq_mma_kernel(BwdArgs args) {
  using namespace fmma;
  using bf16 = __nv_bfloat16;
  constexpr int MW = dq_m_blocks<D>();  // m-blocks a warp
  constexpr int BQ = 4 * 16 * MW;       // q rows a block
  constexpr int LD = D + 8, KT = TILE * LD;
  constexpr int KB = D / 16, NB = D / 8;
  extern __shared__ uint4 smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + BQ * LD;
  bf16* ks = dos + BQ * LD;  // 2 stages
  bf16* vs = ks + 2 * KT;    // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int t = args.t, q0 = blockIdx.x * BQ, w0 = warp * 16 * MW;
  const uint32_t bh = blockIdx.y;
  const size_t base = (size_t)bh * t * D;
  const bf16* kb = static_cast<const bf16*>(args.k) + base;
  const bf16* vb = static_cast<const bf16*>(args.v) + base;
  const int n_tiles = (t + TILE - 1) / TILE;

  load_rows<D, MMA_NT, BQ>(qs, static_cast<const bf16*>(args.q) + base, q0, t);
  load_rows<D, MMA_NT, BQ>(dos, static_cast<const bf16*>(args.dout) + base,
                           q0, t);
  load_rows<D, MMA_NT, TILE>(ks, kb, 0, t);
  load_rows<D, MMA_NT, TILE>(vs, vb, 0, t);
  cp_async_commit();

  const bool drop_on = args.drop.active();
  const uint32_t c2 = pack_bf16(args.c_in, args.c_in);  // exact: c is bf16
  const float sm = args.sm_scale, sl2 = sm * LOG2E;
  // this thread's rows w0 + 16 mi + g + 8 r: lse log2 e, dvec, dropout
  // ids; rows past t take zeros (never stored)
  const float* lseb = static_cast<const float*>(args.lse) + (size_t)bh * t;
  const float* dvecb = static_cast<const float*>(args.dvec) + (size_t)bh * t;
  float lrow[MW][2], drow[MW][2];
  uint32_t rid[MW][2];
  float acc[MW][NB][4];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + w0 + 16 * mi + g + 8 * r;
      lrow[mi][r] = row < t ? lseb[row] * LOG2E : 0.f;
      drow[mi][r] = row < t ? dvecb[row] : 0.f;
      rid[mi][r] = args.drop.row_id(bh, row);
    }
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][c][e] = 0.f;
  }
  uint32_t qf[MW][KB][4], df[MW][KB][4];  // q and dO as A fragments

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1, k0 = j * TILE;
    if (j + 1 < n_tiles) {
      load_rows<D, MMA_NT, TILE>(ks + (st ^ 1) * KT, kb, k0 + TILE, t);
      load_rows<D, MMA_NT, TILE>(vs + (st ^ 1) * KT, vb, k0 + TILE, t);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and the q and dO tiles) have landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
          const int arow = (w0 + 16 * mi + (lane & 15)) * LD + kk * 16 +
                           (lane >> 4) * 8;
          ldsm_x4(qf[mi][kk], qs + arow);
          ldsm_x4(df[mi][kk], dos + arow);
        }
    }
    const bf16* kt = ks + st * KT;
    const bf16* vt = vs + st * KT;
    const bool edge = k0 + TILE > t;  // only the last tile holds keys >= t

    // two chunks in flight: 2.1% less time a GPT step than one at a time
    // (tools/bench_flash.py --root; NVIDIA H100 80GB HBM3, 700 W; PERF.md)
#pragma unroll 2
    for (int ch = 0; ch < TILE / 16; ++ch) {  // 16 keys a chunk
      // S = q k^T and dP = dO (c v)^T: an m-block's 16 rows x 2 blocks of
      // 8 keys
      float s[MW][2][4], dp[MW][2][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mi][n][e] = dp[mi][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        uint32_t b[4], c[4];  // keys 16ch..16ch+15: b0, b1 of two key blocks
        const int brow = (ch * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                         kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(b, kt + brow);
        ldsm_x4(c, vt + brow);
        if (drop_on) {
#pragma unroll
          for (int e = 0; e < 4; ++e) c[e] = mul_bf16x2(c[e], c2);
        }
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          mma(s[mi][0], qf[mi][kk], b[0], b[1]);
          mma(s[mi][1], qf[mi][kk], b[2], b[3]);
          mma(dp[mi][0], df[mi][kk], c[0], c[1]);
          mma(dp[mi][1], df[mi][kk], c[2], c[3]);
        }
      }

      // element (n, e) of m-block mi: q row w0 + 16 mi + g + 8 (e / 2), key
      // k0 + 16 ch + 8n + 2tq + e % 2.  Keys past t were read as zeros, so
      // exp is finite there; they are masked to P = 0.  dS, rounded to
      // bf16, is the A fragment of the chunk's 16 keys.
      uint32_t sa[MW][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        float ds[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int col = k0 + ch * 16 + 8 * n + 2 * tq + (e & 1);
            float p = exp2_approx(fmaf(s[mi][n][e], sl2, -lrow[mi][r]));
            if (edge && col >= t) p = 0.f;
            const bool keep = !drop_on || args.drop.keep_id(rid[mi][r] + col);
            const float dpd = keep ? dp[mi][n][e] : 0.f;
            ds[n][e] = p * (dpd - drow[mi][r]) * sm;
          }
        sa[mi][0] = pack_bf16(ds[0][0], ds[0][1]);
        sa[mi][1] = pack_bf16(ds[0][2], ds[0][3]);
        sa[mi][2] = pack_bf16(ds[1][0], ds[1][1]);
        sa[mi][3] = pack_bf16(ds[1][2], ds[1][3]);
      }

      // dq += dS k over the chunk's 16 keys: dims 16dp..16dp+15 are b0, b1
      // of two dim blocks, k read transposed
#pragma unroll
      for (int dp2 = 0; dp2 < NB / 2; ++dp2) {
        uint32_t b[4];
        ldsm_x4_t(b, kt + (ch * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                         dp2 * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          mma(acc[mi][2 * dp2], sa[mi], b[0], b[1]);
          mma(acc[mi][2 * dp2 + 1], sa[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + w0 + 16 * mi + g + 8 * r;
      if (row >= t) continue;
      bf16* dqrow = static_cast<bf16*>(args.dq) + base + (size_t)row * D;
#pragma unroll
      for (int c = 0; c < NB; ++c)
        *reinterpret_cast<uint32_t*>(dqrow + 8 * c + 2 * tq) =
            pack_bf16(acc[mi][c][2 * r], acc[mi][c][2 * r + 1]);
    }
}

// -- launch ------------------------------------------------------------------

// The prologue of both entries: dvec = rowsum(dO * O) in f32 (products of
// the inputs widened to f32, summed in f32) and, when dq_acc is not null
// (merged), zeros in the f32 dq buffer; D / 8 threads a row, 8 elements
// each.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_prep_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                      float* __restrict__ dvec, float* __restrict__ dq_acc,
                      int rows) {
  constexpr int TPR = D / 8;  // threads a row: 2..16, dividing a warp
  const size_t gid = (size_t)blockIdx.x * NT + threadIdx.x;
  const size_t row = gid / TPR;
  const int part = (int)(gid % TPR);
  float sum = 0.f;
  if (row < (size_t)rows) {
    const size_t off = row * D + part * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[4], y[4];
      load4(dout + off + 4 * h, x);
      load4(o + off + 4 * h, y);
#pragma unroll
      for (int e = 0; e < 4; ++e) sum = fmaf(x[e], y[e], sum);
      if (dq_acc)
        *reinterpret_cast<float4*>(dq_acc + off + 4 * h) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int w = TPR / 2; w > 0; w /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, w);
  if (row < (size_t)rows && part == 0) dvec[row] = sum;
}

template <typename T, int D>
cudaError_t launch_prep(const void* dout, const void* o, void* dvec,
                        void* dq_acc, int rows, cudaStream_t stream) {
  const size_t threads = (size_t)rows * (D / 8);
  flash_bwd_prep_kernel<T, D><<<(unsigned)((threads + NT - 1) / NT), NT, 0,
                                stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(o),
      static_cast<float*>(dvec), static_cast<float*>(dq_acc), rows);
  return cudaGetLastError();
}

cudaError_t prep(const void* dout, const void* o, void* dvec, void* dq_acc,
                 int rows, int d, int is_bf16, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  switch (d) {
    case 16: return is_bf16 ? launch_prep<bf16, 16>(dout, o, dvec, dq_acc, rows, stream)
                            : launch_prep<float, 16>(dout, o, dvec, dq_acc, rows, stream);
    case 32: return is_bf16 ? launch_prep<bf16, 32>(dout, o, dvec, dq_acc, rows, stream)
                            : launch_prep<float, 32>(dout, o, dvec, dq_acc, rows, stream);
    case 64: return is_bf16 ? launch_prep<bf16, 64>(dout, o, dvec, dq_acc, rows, stream)
                            : launch_prep<float, 64>(dout, o, dvec, dq_acc, rows, stream);
    case 128: return is_bf16 ? launch_prep<bf16, 128>(dout, o, dvec, dq_acc, rows, stream)
                             : launch_prep<float, 128>(dout, o, dvec, dq_acc, rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the merged kernel's f32 dq buffer in the input dtype
__global__ void cast_bf16_kernel(const float* __restrict__ src,
                                 __nv_bfloat16* __restrict__ dst, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

enum class Kind { kMerged, kDq, kDkv };

// launches `kernel` with `smem` bytes of dynamic shared memory
template <typename K>
cudaError_t start(K kernel, dim3 grid, int threads, int smem,
                  cudaStream_t stream, const BwdArgs& args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(Kind kind, const BwdArgs& args, int bh,
                       cudaStream_t stream) {
  const dim3 grid((args.t + TILE - 1) / TILE, bh);
  switch (kind) {
    case Kind::kDq:
      return start(flash_bwd_dq_kernel<D>, grid, NT, smem_bytes<D>(), stream,
                   args);
    case Kind::kDkv:
      return start(flash_bwd_dkv_kernel<D, false>, grid, NT, smem_bytes<D>(),
                   stream, args);
    default:  // merged: dq_acc is dq itself
      return start(flash_bwd_dkv_kernel<D, true>, grid, NT, smem_bytes<D>(),
                   stream, args);
  }
}

template <int D>
cudaError_t launch_bf16(Kind kind, const BwdArgs& args, int bh,
                        cudaStream_t stream) {
  const dim3 grid((args.t + TILE - 1) / TILE, bh);
  if (kind == Kind::kDq) {
    constexpr int BQ = 64 * dq_m_blocks<D>();
    return start(flash_bwd_dq_mma_kernel<D>, dim3((args.t + BQ - 1) / BQ, bh),
                 MMA_NT, dq_smem_bytes<D>(), stream, args);
  }
  if (kind == Kind::kDkv)
    return start(flash_bwd_dkv_mma_kernel<D>, grid, MMA_NT,
                 kv_smem_bytes<D, false>(), stream, args);
  cudaError_t err = start(flash_bwd_mma_kernel<D>, grid, MMA_NT,
                          kv_smem_bytes<D, true>(), stream, args);
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)bh * args.t * D;
  const int blocks = (int)((n + 4 * NT - 1) / (4 * NT));
  cast_bf16_kernel<<<blocks < 4096 ? blocks : 4096, NT, 0, stream>>>(
      args.dq_acc, static_cast<__nv_bfloat16*>(args.dq), n);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(Kind kind, const BwdArgs& args, int bh, int is_bf16,
                   cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(kind, args, bh, stream)
                 : launch_f32<D>(kind, args, bh, stream);
}

bool bad_shape(int bh, int t, int t_pad) {
  return bh <= 0 || bh > 65535 || t <= 0 || t_pad < t;
}

int run(Kind kind, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* dvec, void* dq,
        void* dk, void* dv, void* dq_acc, int bh, int t, int d, int is_bf16,
        float sm_scale, uint32_t keep_min, float drop_scale, float c_in,
        uint32_t seed, int t_pad, void* stream) {
  if (bad_shape(bh, t, t_pad)) return (int)cudaErrorInvalidValue;
  const BwdArgs args{q, k, v, dout, lse, dvec, dq, dk, dv,
                     static_cast<float*>(dq_acc), t, sm_scale, c_in,
                     DropoutStream{keep_min, drop_scale, seed,
                                   (uint32_t)t_pad}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return (int)launch<16>(kind, args, bh, is_bf16, s);
    case 32: return (int)launch<32>(kind, args, bh, is_bf16, s);
    case 64: return (int)launch<64>(kind, args, bh, is_bf16, s);
    case 128: return (int)launch<128>(kind, args, bh, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, dout, o: (bh, t, d) contiguous, f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1), 16-byte aligned; lse, dvec: (bh, t) f32; c_in: 1/(1-p)
// rounded to the input dtype (1 for p = 0); keep_min = ceil(p * 2^24)
// (flash_dropout.cuh).  Each launches on `stream` without synchronising
// and returns cudaGetLastError() of its launches.
//
// merged: dq, dk, dv in one pass, from the forward's output o: dvec is a
// scratch buffer that its prologue fills, and dq_acc an f32 (bh, t, d)
// buffer that it zeros.  For f32 inputs dq_acc must be dq itself, and no
// cast pass runs.
extern "C" int flash_bwd_merged(const void* q, const void* k, const void* v,
                                const void* dout, const void* o,
                                const void* lse, void* dvec, void* dq,
                                void* dk, void* dv, void* dq_acc, int bh,
                                int t, int d, int is_bf16, float sm_scale,
                                uint32_t keep_min, float drop_scale,
                                float c_in, uint32_t seed, int t_pad,
                                void* stream) {
  if (bad_shape(bh, t, t_pad)) return (int)cudaErrorInvalidValue;
  const int err = (int)prep(dout, o, dvec, dq_acc, bh * t, d, is_bf16,
                            static_cast<cudaStream_t>(stream));
  if (err) return err;
  return run(Kind::kMerged, q, k, v, dout, lse, dvec, dq, dk, dv, dq_acc, bh,
             t, d, is_bf16, sm_scale, keep_min, drop_scale, c_in, seed,
             t_pad, stream);
}

// split: the prologue fills the scratch dvec from o, then the dq kernel
// writes dq and the dk/dv kernel dk and dv; no atomics, so two calls on the
// same inputs return the same bits
extern "C" int flash_bwd_split(const void* q, const void* k, const void* v,
                               const void* dout, const void* o,
                               const void* lse, void* dvec, void* dq,
                               void* dk, void* dv, int bh, int t, int d,
                               int is_bf16, float sm_scale,
                               uint32_t keep_min, float drop_scale,
                               float c_in, uint32_t seed, int t_pad,
                               void* stream) {
  if (bad_shape(bh, t, t_pad)) return (int)cudaErrorInvalidValue;
  int err = (int)prep(dout, o, dvec, nullptr, bh * t, d, is_bf16,
                      static_cast<cudaStream_t>(stream));
  if (err) return err;
  err = run(Kind::kDq, q, k, v, dout, lse, dvec, dq, nullptr, nullptr,
            nullptr, bh, t, d, is_bf16, sm_scale, keep_min, drop_scale, c_in,
            seed, t_pad, stream);
  if (err) return err;
  return run(Kind::kDkv, q, k, v, dout, lse, dvec, nullptr, dk, dv, nullptr,
             bh, t, d, is_bf16, sm_scale, keep_min, drop_scale, c_in, seed,
             t_pad, stream);
}

// The split pair's kernels one at a time, dvec = rowsum(dO * O) given by
// the caller: dq alone and dk, dv alone.  The port's backward calls
// flash_bwd_split; these let a timing tool time each kernel by itself.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* dvec, void* dq, int bh, int t, int d,
                            int is_bf16, float sm_scale, uint32_t keep_min,
                            float drop_scale, float c_in, uint32_t seed,
                            int t_pad, void* stream) {
  return run(Kind::kDq, q, k, v, dout, lse, dvec, dq, nullptr, nullptr,
             nullptr, bh, t, d, is_bf16, sm_scale, keep_min, drop_scale,
             c_in, seed, t_pad, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* dvec, void* dk, void* dv, int bh,
                             int t, int d, int is_bf16, float sm_scale,
                             uint32_t keep_min, float drop_scale, float c_in,
                             uint32_t seed, int t_pad, void* stream) {
  return run(Kind::kDkv, q, k, v, dout, lse, dvec, nullptr, dk, dv, nullptr,
             bh, t, d, is_bf16, sm_scale, keep_min, drop_scale, c_in, seed,
             t_pad, stream);
}
