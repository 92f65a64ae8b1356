// Streamed-vocab cross-entropy for Hopper (sm_90a): the row logsumexp and
// the logits gradient of the hard-label loss, f32 or bf16 logits.
//
// Replaces two TPU kernels of paddle_tpu/ops/pallas/chunked_ce.py:
//   chunked_ce_lse     <- _online_lse (_lse_kernel, pallas_call at :128):
//                         lse[n] = log sum_v exp(logits[n, v]) with an
//                         online f32 (m, s) recurrence; a row whose sum
//                         is 0 gets -1e30 (the s == 0 guard of :117);
//   chunked_ce_dlogits <- _dlogits (_dlogits_kernel, pallas_call at :168):
//                         d[n, v] = (exp(logits[n, v] - lse[n])
//                                    - (v == label[n])) * g[n], written in
//                         the logits' dtype, with the lse == -1e30 -> shift
//                         0 guard.
// The TPU kernels walk the vocab in chunks through a sequential grid axis
// and keep (m, s) in VMEM scratch; here one block owns a whole row, so
// the vocab loop lives inside the block and needs no chunking, and lse
// comes back as [N] (the TPU's [N, 8] tile was its lane width).
//
// What bounds them on this card: memory. lse reads the logits once; the
// gradient reads them once and writes the gradient once (one exp per
// element, below the card's ratio of operations to bytes). What the
// design does about it: 16-byte loads and stores (8 bf16 or 4 f32
// elements a thread), one exp per element plus one rescale per 16-byte
// vector in the lse loop, and the (m, s) pairs of a row merged by warp
// shuffles and once through shared memory. A scalar path covers rows
// whose start is not 16-byte aligned (V not a multiple of the vector).
//
// Plain C interface, bound from Python with ctypes; each entry returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// merge two online-softmax states (m, s) into the first
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mn = fmaxf(m, m2);
  const float shift = mn == NEG_INF ? 0.f : mn;
  s = s * expf(m - shift) + s2 * expf(m2 - shift);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lse_kernel(const T* __restrict__ logits, float* __restrict__ lse, int V) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float sm[THREADS / 32], ss[THREADS / 32];
  const T* row = logits + (long long)blockIdx.x * V;
  float m = NEG_INF, s = 0.f;
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  const int nvec = aligned ? V / VEC : 0;
  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    alignas(16) T v[VEC];
    *reinterpret_cast<uint4*>(v) = reinterpret_cast<const uint4*>(row)[i];
    float x[VEC];
    float mx = NEG_INF;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      x[e] = to_f32(v[e]);
      mx = fmaxf(mx, x[e]);
    }
    const float mn = fmaxf(m, mx);
    const float shift = mn == NEG_INF ? 0.f : mn;
    float add = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) add += expf(x[e] - shift);
    s = s * expf(m - shift) + add;
    m = mn;
  }
  for (int c = nvec * VEC + threadIdx.x; c < V; c += THREADS)
    merge(m, s, to_f32(row[c]), 1.f);

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) merge(m, s, sm[w], ss[w]);
    lse[blockIdx.x] = s == 0.f ? NEG_INF : m + logf(s);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dlogits_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   T* __restrict__ out, int V) {
  constexpr int VEC = 16 / sizeof(T);
  const long long off = (long long)blockIdx.x * V;
  const T* row = logits + off;
  T* orow = out + off;
  const float l = lse[blockIdx.x];
  const float shift = l == NEG_INF ? 0.f : l;
  const int label = labels[blockIdx.x];
  const float gn = g[blockIdx.x];
  const int c0 = (blockIdx.y * THREADS + threadIdx.x) * VEC;
  if (c0 >= V) return;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(row) | reinterpret_cast<uintptr_t>(orow)) &
       15) == 0;
  if (aligned && c0 + VEC <= V) {
    alignas(16) T v[VEC];
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(row + c0);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float p = expf(to_f32(v[e]) - shift);
      store(&v[e], (p - (c0 + e == label ? 1.f : 0.f)) * gn);
    }
    *reinterpret_cast<uint4*>(orow + c0) = *reinterpret_cast<uint4*>(v);
  } else {
    for (int c = c0; c < V && c < c0 + VEC; ++c) {
      const float p = expf(to_f32(row[c]) - shift);
      store(&orow[c], (p - (c == label ? 1.f : 0.f)) * gn);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. logits [N, V] contiguous, lse [N] f32.
extern "C" int chunked_ce_lse(const void* logits, void* lse, int N, int V,
                              int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0) return 0;
  if (dtype == 0)
    lse_kernel<float><<<N, THREADS, 0, st>>>(
        static_cast<const float*>(logits), static_cast<float*>(lse), V);
  else if (dtype == 1)
    lse_kernel<__nv_bfloat16><<<N, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<float*>(lse),
        V);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// labels [N] int32, lse and g [N] f32, out [N, V] in the logits' dtype.
extern "C" int chunked_ce_dlogits(const void* logits, const void* labels,
                                  const void* lse, const void* g, void* out,
                                  int N, int V, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0) return 0;
  const int vec = dtype == 0 ? 4 : 8;
  const dim3 grid(N, (V + THREADS * vec - 1) / (THREADS * vec));
  if (dtype == 0)
    dlogits_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(logits), static_cast<const int*>(labels),
        static_cast<const float*>(lse), static_cast<const float*>(g),
        static_cast<float*>(out), V);
  else if (dtype == 1)
    dlogits_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits),
        static_cast<const int*>(labels), static_cast<const float*>(lse),
        static_cast<const float*>(g), static_cast<__nv_bfloat16*>(out), V);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
