// Export of the flash kernels' dropout scale for Hopper (sm_90a): the
// (n_bh, T, T) f32 matrix of {0, 1/(1-p)} that the forward and backward
// kernels draw element by element (flash_dropout.cuh).
//
// Replaces: deepsense6g_tii_tpu/ops/flash_attention.py::_mask_kernel
// (launched by dropout_mask), the TPU's oracle for the in-kernel stream.  It
// calls the same device function as the attention kernels, so comparing its
// output with the plain dropout_scale_reference shows that the kernels draw
// the JAX package's bits.  A test tool, off the training path.
//
// Bound on an H100 SXM: it writes 4 * n_bh * T^2 bytes and reads nothing,
// about 15 integer operations per element, so it is bound by bytes (35 us
// for n_bh = 32, T = 962 at 3.35 TB/s).  Design: one block per (bh, row),
// its threads on neighbouring columns, so every store is coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_dropout.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
dropout_mask_kernel(float* __restrict__ out, int t, DropoutStream drop) {
  const uint32_t bh = blockIdx.y, row = blockIdx.x;
  float* orow = out + ((size_t)bh * t + row) * t;
  for (int col = threadIdx.x; col < t; col += NT)
    orow[col] = drop.keep(bh, row, col) ? drop.scale : 0.f;
}

}  // namespace

// out: (n_bh, t, t) f32 contiguous; keep_min = ceil(p * 2^24) for the f32
// p (flash_dropout.cuh).  Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch.
extern "C" int flash_dropout_mask(void* out, int n_bh, int t,
                                  uint32_t keep_min, float scale,
                                  uint32_t seed, int t_pad, void* stream) {
  if (n_bh <= 0 || n_bh > 65535 || t <= 0 || t_pad < t)
    return (int)cudaErrorInvalidValue;
  const DropoutStream drop{keep_min, scale, seed, (uint32_t)t_pad};
  dropout_mask_kernel<<<dim3(t, n_bh), NT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), t, drop);
  return (int)cudaGetLastError();
}
