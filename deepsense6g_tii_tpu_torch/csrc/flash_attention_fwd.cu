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
// p == 0 the stream is skipped and the kernel computes what it computed
// without it.
//
// Bound on an H100 SXM: 4*BH*T^2*D operations against 4*BH*T*D*bytes moved,
// about T/bytes = 481 operations per byte in bf16 at T = 962, above the
// card's ~295 balance point, so the work is bound by operations: 15.3 us
// for BH = 32, D = 128 at the 989 TFLOP/s bf16 tensor-core rate (in f32,
// 240 operations per byte against the 67 TFLOP/s CUDA-core rate).  This first
// version is a simple, exact design that does the products on the CUDA
// cores in f32 and reaches neither bound; the tensor cores (mma.sync/wgmma)
// and TMA staging are later work.  What the design does about the bound:
// one block per (bh, 64-row q tile) streams 64-row k/v tiles through shared
// memory, so each q tile reads k and v once and the scores never leave the
// chip; each thread keeps a 4 x 8 score tile and a 4 x D/8 output tile in
// registers, so every shared-memory value read feeds 4-8 FMAs; the q and k
// tiles are stored transposed and P with a padded stride so that the inner
// loops read shared memory without bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_dropout.cuh"

namespace {

constexpr int BM = 64;        // q rows per block
constexpr int BN = 64;        // k/v rows per tile
constexpr int NT = 128;       // threads per block: 16 row groups x 8 lanes
constexpr int PT_LD = BM + 4; // padded stride of the transposed P tile

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

// P as it enters the P.V product: unchanged in f32, rounded to bf16 in bf16
__device__ __forceinline__ float round_p(float p, const float*) { return p; }
__device__ __forceinline__ float round_p(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
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
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

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
    if (drop.p > 0.f) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][j] = drop.keep(blockIdx.y, q0 + ty * 4 + i, k0 + tx + 8 * j)
                        ? s[i][j] * drop.scale : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = round_p(s[i][j], q);
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
    T* orow = o + base + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(orow + tx + 8 * c, acc[i][c] / l[i]);
    if (tx == 0) lse[(size_t)blockIdx.y * t + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int t, float sm_scale,
                   DropoutStream drop, cudaStream_t stream) {
  const int smem = (D * BM + 2 * D * BN + BN * PT_LD) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + BM - 1) / BM, bh);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      t, sm_scale, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t, int d, float sm_scale,
                       DropoutStream drop, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, t, sm_scale, drop, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, t, sm_scale, drop, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, t, sm_scale, drop, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, t, sm_scale, drop, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (bh, t, d) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// 16-byte aligned; lse: (bh, t) f32.  dropout_p > 0 drops attention
// probabilities by the hash stream of (seed, t_pad) and scales the kept ones
// by drop_scale.  Launches on `stream` without synchronising and returns
// cudaGetLastError() of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int bh,
                                   int t, int d, int is_bf16, float sm_scale,
                                   float dropout_p, float drop_scale,
                                   uint32_t seed, int t_pad, void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0 || t_pad < t)
    return (int)cudaErrorInvalidValue;
  const DropoutStream drop{dropout_p, drop_scale, seed, (uint32_t)t_pad};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, t, d,
                                               sm_scale, drop, s)
                   : dispatch_d<float>(q, k, v, o, lse, bh, t, d, sm_scale,
                                       drop, s));
}
