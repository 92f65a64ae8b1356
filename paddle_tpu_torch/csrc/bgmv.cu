// Batched gather-matmul (bgmv) for multi-tenant LoRA on Hopper (sm_90a):
// x in f32 or bf16, float32 adapter pools, f32 accumulation.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/bgmv.py::bgmv
// (_bgmv_kernel, pallas_call at :103): every batch row b applies its own
// low-rank adapter, picked by ids[b] out of stacked pools A [A, r, E] and
// B [A, r, O],
//
//     delta[b, s, :] = (x[b, s, :] . A[ids[b]]^T) . B[ids[b]]
//
// shrink to r values per token, then expand to O. Row 0 of the pools is
// the zero adapter, so a base-model row gets exactly 0.0.
//
// What bounds it on this card: memory. At the serving shapes (E=1024,
// r=8, O=3072) a token costs 2*r*(E+O) = 65536 operations against
// 4*(E+O) = 16 KB of its own x read and delta written in f32: 4
// operations a byte, far below the ~20 a byte at which f32 arithmetic
// (67 TFLOP/s) would take over. Writing the [B, S, O] delta is most of
// the bytes. What the design does about it: the adapter rows are read
// in place through ids[b] -- the gathered [B, r, E] / [B, r, O] copies of
// the plain version never exist -- and the rank-r intermediate h never
// leaves the block. A block takes one batch row, a tile of ST=16 tokens
// and a tile of 1024 output columns (4 a thread). It first computes h
// for its tokens: every thread sums a strided share of E for RC=8 ranks
// at a time, a warp shuffle and then one pass over the 8 warps' partial
// sums in shared memory finish each of the ST*r values in a fixed order
// (so a run repeats itself bit for bit). Then each thread walks the r
// rows of B once, RC rows at a time with all their loads issued first,
// one coalesced load per column, and keeps its 16 x 4 outputs in
// registers until they are written. h lives in shared memory,
// which bounds r at RMAX=64; the wrapper raises above it.
//
// Plain C interface, bound from Python with ctypes; returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ST = 16;                  // tokens per block
constexpr int COLS = 4;                 // output columns per thread
constexpr int TO = THREADS * COLS;      // output columns per block
constexpr int RC = 8;                   // ranks per pass of the shrink
constexpr int RMAX = 64;                // the largest rank h holds

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// TX: x and the delta
template <typename TX>
__global__ void __launch_bounds__(THREADS)
    bgmv_kernel(const TX* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, const int* __restrict__ ids,
                TX* __restrict__ out, int S, int E, int r, int O) {
  __shared__ float part[ST][RMAX][WARPS];  // per-warp partial sums of h
  __shared__ float h[ST][RMAX];

  const int o0 = blockIdx.x * TO;
  const int s0 = blockIdx.y * ST;
  const int row = blockIdx.z;
  const int ns = min(ST, S - s0);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long id = ids[row];
  const float* A = a + id * r * E;
  const float* Bw = b + id * r * O;
  const TX* X = x + ((long long)row * S + s0) * E;

  // shrink: h[s, j] = x[s] . A[j], E split over the block's threads
  for (int s = 0; s < ns; ++s) {
    const TX* xs = X + (long long)s * E;
    for (int j0 = 0; j0 < r; j0 += RC) {
      const int nj = min(RC, r - j0);
      float acc[RC];
#pragma unroll
      for (int jj = 0; jj < RC; ++jj) acc[jj] = 0.f;
#pragma unroll 4
      for (int e = threadIdx.x; e < E; e += THREADS) {
        const float xv = to_f32(xs[e]);
#pragma unroll
        for (int jj = 0; jj < RC; ++jj)
          if (jj < nj)
            acc[jj] = fmaf(xv, A[(long long)(j0 + jj) * E + e], acc[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < RC; ++jj) {
        float v = acc[jj];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0 && jj < nj) part[s][j0 + jj][w] = v;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ns * r; i += THREADS) {
    const int s = i / r, j = i % r;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) v += part[s][j][k];
    h[s][j] = v;
  }
  __syncthreads();

  // expand: out[s, o] = h[s] . B[:, o], each B element loaded once
  float acc[ST][COLS];
#pragma unroll
  for (int s = 0; s < ST; ++s)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[s][c] = 0.f;
  for (int j0 = 0; j0 < r; j0 += RC) {
    // RC rows of B loaded before any is used, so their loads overlap
    float bv[RC][COLS];
#pragma unroll
    for (int jj = 0; jj < RC; ++jj)
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int o = o0 + threadIdx.x + THREADS * c;
        bv[jj][c] =
            j0 + jj < r && o < O ? Bw[(long long)(j0 + jj) * O + o] : 0.f;
      }
#pragma unroll
    for (int jj = 0; jj < RC; ++jj) {
      if (j0 + jj >= r) break;
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        const float hv = s < ns ? h[s][j0 + jj] : 0.f;
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          acc[s][c] = fmaf(hv, bv[jj][c], acc[s][c]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    if (s >= ns) break;
    TX* os = out + ((long long)row * S + s0 + s) * O;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int o = o0 + threadIdx.x + THREADS * c;
      if (o < O) store(&os[o], acc[s][c]);
    }
  }
}

template <typename TX>
int launch(const void* x, const void* a, const void* b, const void* ids,
           void* out, int B, int S, int E, int r, int O,
           cudaStream_t stream) {
  const dim3 grid((O + TO - 1) / TO, (S + ST - 1) / ST, B);
  bgmv_kernel<TX><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const int*>(ids),
      static_cast<TX*>(out), S, E, r, O);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, S, E] and out [B, S, O] in dtype (0 = float32, 1 = bfloat16);
// a [A, r, E] and b [A, r, O] float32; ids [B] int32, each in [0, A).
extern "C" int bgmv(const void* x, const void* a, const void* b,
                    const void* ids, void* out, int B, int S, int E, int r,
                    int O, int dtype, void* stream) {
  if (r < 1 || r > RMAX || B < 1 || S < 1 || E < 1 || O < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, a, b, ids, out, B, S, E, r, O, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, b, ids, out, B, S, E, r, O, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
