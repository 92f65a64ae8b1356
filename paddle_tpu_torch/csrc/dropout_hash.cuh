// The stateless dropout hash shared by the fused dropout kernel
// (dropout.cu) and the kernels that drop attention probabilities
// (flash_attention_fwd.cu, flash_attention_bwd.cu).
//
// Port of paddle_tpu/ops/pallas/rng.py::fmix32 (the murmur3 finalizer)
// and of flash_attention.py::_dropout_keep: a pure function of the
// absolute (batch, head, query row, key column) and the two seed words,
// in wrapping uint32 arithmetic, so the backward regenerates the
// forward's mask bit for bit and nothing is stored.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// bh = b * 0xAC564B05 + h * 19349663; seed = s0 ^ (s1 << 1)
__device__ __forceinline__ bool attention_keep(uint32_t row, uint32_t col,
                                               uint32_t bh, uint32_t seed,
                                               uint32_t threshold) {
  return fmix32(row * 0x9E3779B1u ^ col * 0x85EBCA6Bu ^ bh ^ seed) >=
         threshold;
}
