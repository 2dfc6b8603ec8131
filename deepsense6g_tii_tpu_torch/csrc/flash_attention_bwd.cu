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
// blocks run in parallel and in no order, so:
// - dkv: one block owns a 64-row k/v tile of one bh, loops over all 64-row
//   q tiles and keeps dk and dv in registers;
// - dq: one block owns a 64-row q tile and loops over the k tiles; dq stays
//   in registers.  The split pair (dq + dkv) is deterministic;
// - merged: the dkv kernel also forms the tile's dS k and adds it into an
//   f32 (bh, T, d) dq buffer with atomicAdd (the order of that sum changes
//   from run to run); a cast pass writes dq in bf16.  One recompute of P
//   per tile instead of the split pair's two.
// Each block has 256 threads: thread (ty, tx) = (tid / 8, tid % 8) owns
// tile rows 2ty, 2ty+1 and columns tx + 8j of the 64 x 64 score tile, and
// output columns tx + 8c of its two rows.  Operands sit in shared memory in
// f32, transposed or row-major with a padded stride so that the inner
// loops read without bank conflicts.
//
// Bound on an H100 SXM: the function needs 10 * BH * T^2 * D operations
// (five T x T x D products) against ~ (8 BH T D elements + 2 BH T f32)
// bytes, so it is bound by operations: 0.575 ms per training step at bf16
// tensor-core rate over the step's 32 launches.  This first version does
// the products on the CUDA cores in f32 (f32 peak 67 TFLOP/s) and reaches
// neither bound; the tensor cores (mma.sync/wgmma), TMA staging and a dq
// reduction without atomics are later work.  The split pair recomputes S
// and dP in both kernels: 14 * BH * T^2 * D operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_dropout.cuh"

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
  float* dq_acc;  // merged: f32 (bh, t, d) buffer, zeroed by the caller
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
        const bool keep = args.drop.p <= 0.f ||
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
        const bool keep = args.drop.p <= 0.f ||
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

// the merged kernel's f32 dq buffer in the input dtype
__global__ void cast_bf16_kernel(const float* __restrict__ src,
                                 __nv_bfloat16* __restrict__ dst, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

enum class Kind { kMerged, kDq, kDkv };

template <typename T, int D>
cudaError_t launch(Kind kind, const BwdArgs& args, int bh,
                   cudaStream_t stream) {
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
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D, true><<<grid, NT, smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || sizeof(T) == sizeof(float)) return err;
  const size_t n = (size_t)bh * args.t * D;
  const int blocks = (int)((n + 4 * NT - 1) / (4 * NT));
  cast_bf16_kernel<<<blocks < 4096 ? blocks : 4096, NT, 0, stream>>>(
      args.dq_acc, static_cast<__nv_bfloat16*>(args.dq), n);
  return cudaGetLastError();
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
        float sm_scale, float dropout_p, float drop_scale, float c_in,
        uint32_t seed, int t_pad, void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0 || t_pad < t)
    return (int)cudaErrorInvalidValue;
  const BwdArgs args{q, k, v, dout, lse, dvec, dq, dk, dv,
                     static_cast<float*>(dq_acc), t, sm_scale, c_in,
                     DropoutStream{dropout_p, drop_scale, seed,
                                   (uint32_t)t_pad}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch_d<__nv_bfloat16>(kind, args, bh, d, s)
                       : dispatch_d<float>(kind, args, bh, d, s));
}

}  // namespace

// q, k, v, dout: (bh, t, d) contiguous, f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1), 16-byte aligned; lse, dvec: (bh, t) f32; c_in: 1/(1-p)
// rounded to the input dtype (1 for p = 0).  Each launches on `stream`
// without synchronising and returns cudaGetLastError() of its launches.
//
// merged: dq, dk, dv in one pass; dq_acc is an f32 (bh, t, d) buffer of
// zeros.  For f32 inputs it must be dq itself, and no cast pass runs.
extern "C" int flash_bwd_merged(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* dvec, void* dq, void* dk,
                                void* dv, void* dq_acc, int bh, int t, int d,
                                int is_bf16, float sm_scale, float dropout_p,
                                float drop_scale, float c_in, uint32_t seed,
                                int t_pad, void* stream) {
  return run(Kind::kMerged, q, k, v, dout, lse, dvec, dq, dk, dv, dq_acc, bh,
             t, d, is_bf16, sm_scale, dropout_p, drop_scale, c_in, seed,
             t_pad, stream);
}

// split: dq alone
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* dvec, void* dq, int bh, int t, int d,
                            int is_bf16, float sm_scale, float dropout_p,
                            float drop_scale, float c_in, uint32_t seed,
                            int t_pad, void* stream) {
  return run(Kind::kDq, q, k, v, dout, lse, dvec, dq, nullptr, nullptr,
             nullptr, bh, t, d, is_bf16, sm_scale, dropout_p, drop_scale,
             c_in, seed, t_pad, stream);
}

// split: dk and dv
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* dvec, void* dk, void* dv, int bh,
                             int t, int d, int is_bf16, float sm_scale,
                             float dropout_p, float drop_scale, float c_in,
                             uint32_t seed, int t_pad, void* stream) {
  return run(Kind::kDkv, q, k, v, dout, lse, dvec, nullptr, dk, dv, nullptr,
             bh, t, d, is_bf16, sm_scale, dropout_p, drop_scale, c_in, seed,
             t_pad, stream);
}
