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
//
// The compare runs in its exact integer form, as the JAX package's "hw"
// stream does (flash_attention.py::_keep_block): u = (x >> 8) * 2^-24 and
// p (f32) give u >= p exactly when (x >> 8) >= ceil(p * 2^24), which the
// host computes once (ops/flash_attention.py::keep_threshold).  That saves
// the integer-to-float conversion, which runs at the slow conversion rate,
// and the multiply, on every T^2 element.
#pragma once

#include <stdint.h>

struct DropoutStream {
  uint32_t keep_min;  // ceil(p * 2^24) for the f32 p; 0 disables the stream
  float scale;        // 1 / (1 - p) as f32
  uint32_t seed;      // the int32 seed reinterpreted as uint32
  uint32_t t_pad;

  // the id of element (bh, row, 0); element (bh, row, col) has id + col
  __device__ __forceinline__ uint32_t row_id(uint32_t bh,
                                             uint32_t row) const {
    return (bh * t_pad + row) * t_pad;
  }

  // fmix32's first step on id ^ seed, x ^ (x >> 16), is id ^ (id >> 16)
  // ^ (seed ^ (seed >> 16)): one shift and one three-input xor an element,
  // the seed's part computed once; and (x >> 8) >= keep_min is
  // x >= keep_min * 2^8, as keep_min < 2^24 (p < 1 in f32)
  __device__ __forceinline__ bool keep_id(uint32_t id) const {
    uint32_t x = id ^ (id >> 16) ^ (seed ^ (seed >> 16));
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x >= (keep_min << 8);
  }

  __device__ __forceinline__ bool keep(uint32_t bh, uint32_t row,
                                       uint32_t col) const {
    return keep_id(row_id(bh, row) + col);
  }

  __host__ __device__ __forceinline__ bool active() const {
    return keep_min > 0;
  }
};
