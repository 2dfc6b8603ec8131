// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of
// O = softmax(q k^T * scale) v with hash dropout, from q, k, v, dO, the
// forward's row lse and dvec = rowsum(dO * O) (f32, computed by the caller),
// recomputing P = exp(s * scale - lse) tile by tile instead of storing it.
//
// Replaces: deepsense6g_tii_tpu/ops/flash_attention.py::_merged_bwd_kernel
// (flash_bwd_merged here), ::_dq_kernel (flash_bwd_dq) and ::_dkv_kernel
// (flash_bwd_dkv), launched by _mha_bwd_pallas.  The GPT TransFuser's
// training step runs the merged one: 32 launches per step (4 fusion stages
// x 8 GPT blocks) at BH = batch * 4 heads, T = 962, head dims 16..128.
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
// Design.  The TPU kernels walked a sequential grid and carried dk/dv (and,
// merged, dq for the whole sequence) in VMEM from step to step.  Hopper
// blocks run in parallel and in no order, so a block owns a 64-row k/v tile
// of one bh and loops over all 64-row q tiles, keeping dk and dv in
// registers; merged, it also forms the tile's dS k and adds it into an f32
// (bh, T, d) dq buffer with atomics (the order of that sum changes from run
// to run), and a cast pass in the same call writes dq in bf16.  One
// recompute of P per tile instead of the split pair's two.  The merged
// entry starts with a prologue kernel that forms dvec = rowsum(dO * O) in
// f32 from o and dO and zeros the f32 dq buffer (one pass over them, where
// PyTorch took five kernels); the split pair takes dvec from the caller.
//
// bf16 merged (the training path): flash_bwd_mma_kernel, on the tensor
// cores.  4 warps; warp w owns k/v rows 16w..16w+15.  k and v are staged
// once; q, dO, lse and dvec go through a ring of two stages in shared
// memory (bf16 tiles with rows of D + 8, flash_mma.cuh), filled by
// cp.async so that q tile i + 1 arrives while tile i is computed.  Per
// 16-row chunk of the q tile, S^T = k q^T and dP^T = (c v) dO^T run as
// mma.sync.m16n8k16 (bf16 operands, f32 accumulation; c v rounded in
// registers by one bf16 multiply, which rounds as the plain version's f32
// product rounded to bf16 does; the k and c v fragments stay in registers
// across the loop at D <= 64 and are read again each chunk at D = 128); P = exp2(s * scale * log2 e - lse log2 e),
// keep from the hash at its global (q row, k col), the dropped P and dS go
// back into the tensor cores from registers as A fragments:
// dV += (keep P)^T (c dO) and dK += dS^T q, accumulated in registers over
// the whole loop (2 * D / 2 f32 a thread, 128 at D = 128; S and dP are
// formed 16 q columns at a time so that they add only 16).  dS^T goes to
// shared memory; after one barrier each warp forms dq = dS k for 16 q rows
// (<= 64 columns a pass) and adds it with float2 atomics (RED.E.ADD.F32x2
// on sm_90), as FlashAttention-2 does.  Why mma.sync and not wgmma: the
// five products per tile are 64 x 64 x D, their operands change roles
// (transposed, from registers, from shared memory) from product to product,
// and the exp and hash per element weigh as much as the products at small
// D; the warp-level product keeps each layout explicit.
//
// f32, and the split pair in both dtypes: the first version's design on
// the CUDA cores (TF32 tensor cores could not meet the f32 bounds; the split
// pair is the deterministic cross-check of the merged kernel, off the
// path):
// - dkv: one block owns a 64-row k/v tile of one bh, loops over all 64-row
//   q tiles and keeps dk and dv in registers;
// - dq: one block owns a 64-row q tile and loops over the k tiles; dq stays
//   in registers.  The split pair (dq + dkv) is deterministic;
// - f32 merged: the dkv kernel also adds dS k into dq with atomicAdd.
// Each block has 256 threads: thread (ty, tx) = (tid / 8, tid % 8) owns
// tile rows 2ty, 2ty+1 and columns tx + 8j of the 64 x 64 score tile, and
// output columns tx + 8c of its two rows.  Operands sit in shared memory in
// f32, transposed or row-major with a padded stride so that the inner
// loops read without bank conflicts.
//
// Bound on an H100 SXM: the function needs 10 * BH * T^2 * D operations
// (five T x T x D products) against ~ (8 BH T D elements + 2 BH T f32)
// bytes, so it is bound by operations: 0.575 ms per training step at the
// bf16 tensor-core rate over the step's 32 launches.  Not in that bound:
// one exp per T^2 element (7.2 us a launch at B = 8 at the SFUs' rate) and,
// with dropout, the hash.  The split pair recomputes S and dP in both
// kernels: 14 * BH * T^2 * D operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_dropout.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int TILE = 64;       // rows of a q or k/v tile
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to the input dtype T (unchanged for f32)
__device__ __forceinline__ float round_in(float x, const float*) { return x; }
__device__ __forceinline__ float round_in(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows [r0, r0 + 64) of a (t, D) matrix into shared memory, scaled by `mul`
// and rounded to the input dtype (mul = 1 leaves values unchanged); rows
// past t read as zero.  TRANS stores element (r, d) at dst[d * LDT + r],
// otherwise at dst[r * (D + 4) + d].
template <bool TRANS, int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int t, float mul) {
  for (int idx = threadIdx.x; idx < TILE * D / 4; idx += NT) {
    const int r = TRANS ? idx % TILE : idx / (D / 4);
    const int d = TRANS ? (idx / TILE) * 4 : (idx % (D / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < t) load4(src + (size_t)(r0 + r) * D + d, x);
    if (mul != 1.f) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = round_in(x[e] * mul, src);
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
// each Y value is scaled and rounded to the input dtype T first
template <int D, int XR, int XN, int YN, int YC, typename T>
__device__ __forceinline__ void accumulate(float (&acc)[2][D / 8],
                                           const float* x, const float* y,
                                           int ty, int tx, float ymul,
                                           const T* rnd) {
#pragma unroll 2
  for (int n = 0; n < TILE; ++n) {
    const float x0 = x[(2 * ty) * XR + n * XN];
    const float x1 = x[(2 * ty + 1) * XR + n * XN];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      float w = y[n * YN + (tx + 8 * c) * YC];
      if (ymul != 1.f) w = round_in(w * ymul, rnd);
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

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *dvec;
  void *dq, *dk, *dv;
  float* dq_acc;  // merged: f32 (bh, t, d) buffer of zeros
  int t;
  float sm_scale, c_in;  // c_in: 1/(1-p) rounded to the input dtype
  DropoutStream drop;
};

template <int D>
constexpr int smem_bytes() {
  return (2 * D * LDT + 2 * TILE * (D + 4) + 2 * TILE * LDT + 2 * TILE) *
         (int)sizeof(float);
}

// One block per (k/v tile, bh).  MERGED adds dS k into args.dq_acc.
template <typename T, int D, bool MERGED>
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
  const T* qb = static_cast<const T*>(args.q) + base;
  const T* dob = static_cast<const T*>(args.dout) + base;
  const float* lseb = static_cast<const float*>(args.lse) + (size_t)bh * t;
  const float* dvecb = static_cast<const float*>(args.dvec) + (size_t)bh * t;
  const T* rnd = qb;  // selects round_in's input dtype

  load_tile<true, D>(kt, static_cast<const T*>(args.k) + base, k0, t, 1.f);
  load_tile<true, D>(cvt, static_cast<const T*>(args.v) + base, k0, t,
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
        pds[kr * LDT + qc] = round_in(g.pd, rnd);
        dss[kr * LDT + qc] = round_in(g.ds, rnd);
      }
    }
    __syncthreads();

    // dv += (keep P)^T (c dO);  dk += dS^T q
    accumulate<D, LDT, 1, D + 4, 1>(dv, pds, dos, ty, tx, args.c_in, rnd);
    accumulate<D, LDT, 1, D + 4, 1>(dk, dss, qs, ty, tx, 1.f, rnd);
    if (MERGED) {
      // this tile's dq rows q0 + 2ty + i: sum over k rows of dS k
      float dq[2][CPT];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) dq[i][c] = 0.f;
      accumulate<D, 1, LDT, 1, LDT>(dq, dss, kt, ty, tx, 1.f, rnd);
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
    T* dkrow = static_cast<T*>(args.dk) + base + (size_t)row * D;
    T* dvrow = static_cast<T*>(args.dv) + base + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      store(dkrow + tx + 8 * c, dk[i][c]);
      store(dvrow + tx + 8 * c, dv[i][c]);
    }
  }
}

// One block per (q tile, bh): dq = sum over k tiles of dS k.
template <typename T, int D>
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
  const T* kb = static_cast<const T*>(args.k) + base;
  const T* vb = static_cast<const T*>(args.v) + base;
  const T* rnd = kb;

  load_tile<true, D>(qt, static_cast<const T*>(args.q) + base, q0, t, 1.f);
  load_tile<true, D>(dot, static_cast<const T*>(args.dout) + base, q0, t,
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
        dss[kc * LDT + qr] = round_in(g.ds, rnd);
      }
    }
    __syncthreads();

    accumulate<D, 1, LDT, D + 4, 1>(dq, dss, ks, ty, tx, 1.f, rnd);
    __syncthreads();  // the next k tile overwrites ks, cvs and dss
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 2 * ty + i;
    if (row >= t) continue;
    T* dqrow = static_cast<T*>(args.dq) + base + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(dqrow + tx + 8 * c, dq[i][c]);
  }
}

// -- bf16 merged, tensor cores --------------------------------------------

constexpr int MMA_NT = 128;  // 4 warps; warp w owns k/v rows 16w..16w+15

template <int D>
constexpr int mma_smem_bytes() {
  // k, c-less v, 2 stages of (q, dO) in bf16 rows of D + 8; dS^T in bf16
  // rows of 72; 2 stages of (lse, dvec) in f32
  return (6 * TILE * (D + 8) + TILE * (TILE + 8)) *
             (int)sizeof(__nv_bfloat16) +
         4 * TILE * (int)sizeof(float);
}

// One block per (k/v tile, bh), looping over the q tiles.  Per q tile,
// warp w forms the transposed scores S^T = k q^T and dP^T = (c v) dO^T of
// its 16 k/v rows in 16-column chunks, then P, the dropped P and dS in
// registers, and feeds them back as m16n8k16 A fragments: dV += (keep P)^T
// (c dO) and dK += dS^T q accumulate in registers across the loop.  dS^T
// goes to shared memory; after one barrier each warp forms dq for 16 q rows
// of the tile, dS k, and adds it into the f32 buffer with vector atomics.
template <int D>
__global__ void __launch_bounds__(MMA_NT) flash_bwd_mma_kernel(BwdArgs args) {
  using namespace fmma;
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8, TL = TILE * LD;
  constexpr int LDS = TILE + 8;            // dS^T row stride
  constexpr int KB = D / 16, NB = D / 8;
  constexpr int QNB = NB < 8 ? NB : 8;     // dq: 8-column blocks a pass
  extern __shared__ uint4 smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + TL;
  bf16* qs = vs + TL;                      // 2 stages
  bf16* dos = qs + 2 * TL;                 // 2 stages
  bf16* dst = dos + 2 * TL;                // [k/v row][LDS]  dS^T
  float* lse_s = reinterpret_cast<float*>(dst + TILE * LDS);  // 2 stages
  float* dvec_s = lse_s + 2 * TILE;                           // 2 stages

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
      bf16* drow = dst + kr * LDS + ch * 16 + 2 * tq;
      *reinterpret_cast<uint32_t*>(drow) = sa[0];
      *reinterpret_cast<uint32_t*>(drow + 8 * LDS) = sa[1];
      *reinterpret_cast<uint32_t*>(drow + 8) = sa[2];
      *reinterpret_cast<uint32_t*>(drow + 8 * LDS + 8) = sa[3];

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
    __syncthreads();  // dS^T of the whole tile is in shared memory

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

// The merged backward's prologue: dvec = rowsum(dO * O) in f32 (products
// of the inputs widened to f32, summed in f32) and zeros in the f32 dq
// buffer, D / 8 threads a row, 8 elements each.
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

template <typename T>
cudaError_t dispatch_prep(const void* dout, const void* o, void* dvec,
                          void* dq_acc, int rows, int d,
                          cudaStream_t stream) {
  switch (d) {
    case 16: return launch_prep<T, 16>(dout, o, dvec, dq_acc, rows, stream);
    case 32: return launch_prep<T, 32>(dout, o, dvec, dq_acc, rows, stream);
    case 64: return launch_prep<T, 64>(dout, o, dvec, dq_acc, rows, stream);
    case 128: return launch_prep<T, 128>(dout, o, dvec, dq_acc, rows, stream);
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

template <int D>
cudaError_t launch_merged_bf16(const BwdArgs& args, int bh,
                               cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((args.t + TILE - 1) / TILE, bh);
  flash_bwd_mma_kernel<D><<<grid, MMA_NT, smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)bh * args.t * D;
  const int blocks = (int)((n + 4 * NT - 1) / (4 * NT));
  cast_bf16_kernel<<<blocks < 4096 ? blocks : 4096, NT, 0, stream>>>(
      args.dq_acc, static_cast<__nv_bfloat16*>(args.dq), n);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(Kind kind, const BwdArgs& args, int bh,
                   cudaStream_t stream) {
  if constexpr (sizeof(T) == sizeof(__nv_bfloat16)) {
    if (kind == Kind::kMerged) return launch_merged_bf16<D>(args, bh, stream);
  }
  const int smem = smem_bytes<D>();
  const dim3 grid((args.t + TILE - 1) / TILE, bh);
  cudaError_t err;
  if (kind == Kind::kDq) {
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(args);
    return cudaGetLastError();
  }
  if (kind == Kind::kDkv) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<T, D, false><<<grid, NT, smem, stream>>>(args);
    return cudaGetLastError();
  }
  if constexpr (sizeof(T) == sizeof(float)) {
    // f32 merged: dq_acc is dq itself
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<T, D, true><<<grid, NT, smem, stream>>>(args);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_d(Kind kind, const BwdArgs& args, int bh, int d,
                       cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(kind, args, bh, stream);
    case 32: return launch<T, 32>(kind, args, bh, stream);
    case 64: return launch<T, 64>(kind, args, bh, stream);
    case 128: return launch<T, 128>(kind, args, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(Kind kind, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* dvec, void* dq,
        void* dk, void* dv, void* dq_acc, int bh, int t, int d, int is_bf16,
        float sm_scale, uint32_t keep_min, float drop_scale, float c_in,
        uint32_t seed, int t_pad, void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0 || t_pad < t)
    return (int)cudaErrorInvalidValue;
  const BwdArgs args{q, k, v, dout, lse, dvec, dq, dk, dv,
                     static_cast<float*>(dq_acc), t, sm_scale, c_in,
                     DropoutStream{keep_min, drop_scale, seed,
                                   (uint32_t)t_pad}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch_d<__nv_bfloat16>(kind, args, bh, d, s)
                       : dispatch_d<float>(kind, args, bh, d, s));
}

}  // namespace

// q, k, v, dout: (bh, t, d) contiguous, f32 (is_bf16 = 0) or bf16
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
  if (bh <= 0 || bh > 65535 || t <= 0 || t_pad < t)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      (int)(is_bf16 ? dispatch_prep<__nv_bfloat16>(dout, o, dvec, dq_acc,
                                                   bh * t, d, s)
                    : dispatch_prep<float>(dout, o, dvec, dq_acc, bh * t, d,
                                           s));
  if (err) return err;
  return run(Kind::kMerged, q, k, v, dout, lse, dvec, dq, dk, dv, dq_acc, bh,
             t, d, is_bf16, sm_scale, keep_min, drop_scale, c_in, seed,
             t_pad, stream);
}

// split (dvec = rowsum(dO * O) computed by the caller): dq alone
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

// split: dk and dv
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
