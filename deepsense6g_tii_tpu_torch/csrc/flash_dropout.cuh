// The attention-probability dropout stream shared by every flash kernel of
// the port (forward, merged backward, dq, dkv and the mask export).
//
// Counterpart of deepsense6g_tii_tpu/ops/flash_attention.py::_uniform_hash
// and ::_keep_block (impl="hash"): element (bh, row, col) of the (n_bh, T, T)
// attention matrix has the id ((bh * t_pad + row) * t_pad + col) in uint32
// arithmetic (wrapping), and is kept when the 24-bit uniform drawn from
// murmur3-fmix32(id ^ seed) is >= p.  t_pad is T rounded up to the JAX
// package's 512 block (or the block the caller names), whatever the tile of
// the Hopper kernel: the bits depend on it.  A kept element is scaled by
// 1 / (1 - p); the kernels take that scale from the host, as the f32 value
// the plain version uses.
#pragma once

#include <stdint.h>

struct DropoutStream {
  float p;        // drop probability; 0 disables the stream
  float scale;    // 1 / (1 - p) as f32
  uint32_t seed;  // the int32 seed reinterpreted as uint32
  uint32_t t_pad;

  __device__ __forceinline__ bool keep(uint32_t bh, uint32_t row,
                                       uint32_t col) const {
    uint32_t x = ((bh * t_pad + row) * t_pad + col) ^ seed;
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    // (x >> 8) < 2^24 converts to f32 exactly; the product is exact too
    return (float)(x >> 8) * 5.9604644775390625e-08f >= p;
  }
};
