// Tensor-core building blocks of the bf16 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu) for Hopper (sm_90a):
// cp.async tile copies, ldmatrix and the warp-level bf16 product
// mma.sync.m16n8k16 with f32 accumulation.
//
// Fragment layouts of m16n8k16 (lane = 4 * g + tq, g = lane / 4 in 0..7,
// tq = lane % 4), each 32-bit register holding two bf16, the lower column
// in the lower half:
//   A (16 x 16, rows x k):  a0 (g, 2tq..2tq+1)     a1 (g+8, 2tq..)
//                           a2 (g, 2tq+8..2tq+9)   a3 (g+8, 2tq+8..)
//   B (16 x 8, k x cols):   b0 (k 2tq..2tq+1, col g)  b1 (k 2tq+8.., col g)
//   C (16 x 8, f32):        c0, c1 (g, 2tq..2tq+1)  c2, c3 (g+8, 2tq..)
// ldmatrix.x4 loads four 8 x 8 bf16 matrices whose row addresses lanes
// 0-7, 8-15, 16-23 and 24-31 give; lane L receives, of matrix i, row L / 4,
// columns 2(L % 4) and 2(L % 4) + 1 in register i (with .trans the
// transpose: rows 2(L % 4) and 2(L % 4) + 1 of column L / 4).
//
// Tiles sit in shared memory row-major with rows of D + 8 bf16 (LD): the
// 16 bytes of padding put the 8 rows that one ldmatrix matrix reads in 8
// different bank groups for every D in {16, 32, 64, 128}, so no load
// conflicts; a row's 16-byte chunks stay 16-byte aligned for cp.async.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fmma {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared, asynchronously; zeros when !valid
// (src is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, the same way
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b (16 x 8 f32 += 16 x 16 bf16 * 16 x 8 bf16)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (round to nearest even), lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// both bf16 halves of x times the bf16 pair c, rounded once (the exact
// product of two bf16 values rounded to bf16, as x * c in f32 rounded to
// bf16 gives it)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t x, uint32_t c) {
  const __nv_bfloat162 r =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&x),
              *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// 2^x by the special-function unit (ex2.approx, within 2 ulps; results
// below 2^-126 flush to zero, far below a bf16 rounding of P)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// sums and maxima over the 4 lanes of a quad (the lanes of one row of a C
// fragment)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [r0, r0 + ROWS) of a (t, D) bf16 matrix into a shared tile of row
// stride D + 8, by cp.async from all NT threads; rows past t are zeros
template <int D, int NT, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int t) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < t;
    cp_async16(dst + r * (D + 8) + c * 8,
               src + (size_t)(ok ? r0 + r : 0) * D + c * 8, ok);
  }
}

}  // namespace fmma
