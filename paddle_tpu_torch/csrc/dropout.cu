// Fused dropout for Hopper (sm_90a): y = keep ? x * inv : 0, f32 or bf16.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/dropout.py::_run
// (_drop_kernel, pallas_call at :69). The keep bit is the TPU kernel's
// stateless hash over the flat element index and the two seed words,
//   keep = fmix32(idx * 0x9E3779B1 ^ s0 ^ (s1 << 1)) >= threshold
// in wrapping uint32 arithmetic (ops/pallas/rng.py), so the backward
// reruns this kernel on the gradient and regenerates the same mask;
// nothing is stored. The TPU kernel's two 2-D views ([*, C] and padded
// [*, 128]) both index the flat array, so this kernel takes the flat
// array and needs no tiling of its own. `inv` arrives already rounded to
// x's dtype (x * jnp.asarray(1/(1-rate), x.dtype) at dropout.py:54); the
// product of a bf16 and a bf16-valued float is exact in f32, so rounding
// it once to bf16 gives the TPU kernel's bits.
//
// What bounds it on this card: memory. It reads x once and writes y once
// (a few integer operations per element, far below the card's ratio of
// operations to bytes). What the design does about it: each thread moves
// 16 bytes per load and store (4 f32 or 8 bf16 elements) in a grid-stride
// loop, with a scalar path for a misaligned pointer and the ragged tail.
//
// Plain C interface, bound from Python with ctypes; returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ T drop_one(T x, long long i, uint32_t seed,
                                      uint32_t thr, float inv) {
  const bool keep =
      fmix32(static_cast<uint32_t>(i) * 0x9E3779B1u ^ seed) >= thr;
  return keep ? from_f32<T>(to_f32(x) * inv) : from_f32<T>(0.f);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                   uint32_t seed, uint32_t thr, float inv) {
  constexpr int VEC = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * THREADS * VEC;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  for (long long base = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
       base < n; base += stride) {
    if (aligned && base + VEC <= n) {
      alignas(16) T v[VEC];
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(x + base);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        v[e] = drop_one(v[e], base + e, seed, thr, inv);
      *reinterpret_cast<uint4*>(y + base) = *reinterpret_cast<uint4*>(v);
    } else {
      for (long long i = base; i < n && i < base + VEC; ++i)
        y[i] = drop_one(x[i], i, seed, thr, inv);
    }
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, uint32_t seed, uint32_t thr,
           float inv, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const long long per_block = (long long)THREADS * VEC;
  // enough blocks to fill the card several times over; the grid-stride
  // loop covers the rest
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  dropout_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, seed, thr, inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. seed = s0 ^ (s1 << 1) in uint32,
// thr = keep_threshold(rate), inv = 1/(1-rate) rounded to x's dtype.
extern "C" int fused_dropout(const void* x, void* y, long long n,
                             unsigned int seed, unsigned int thr, float inv,
                             int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, n, seed, thr, inv, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, n, seed, thr, inv, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
