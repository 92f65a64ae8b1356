// int8 x int8 -> int32 matrix product with a dequantize epilogue on
// Hopper (sm_90a): the int8 inference GEMM of slim.QuantizedLinear and of
// the flag-gated AMP int8 linear.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/quant_matmul.py::int8_matmul
// (_mm_kernel, pallas_call at :168):
//
//     out[m, n] = cast( float(sum_k x_q[m, k] * w_q[k, n])
//                       * (act_scale[0] * w_scale[n]) )
//
// x_q [M, K] and w_q [K, N] int8, both row-major (the JAX layout, used as
// it is); w_scale [N] f32 per output channel; act_scale one f32 in device
// memory (a calibrated static scale or the dynamic absmax the wrapper
// computed on the card just before, read here without a host round
// trip); out [M, N] f32 or bf16. The sum is an exact int32 (|acc| <=
// K * 127^2, 4.96e7 at K = 3072). The epilogue multiplies in the JAX
// kernel's order, scale = act_scale * w_scale[n] and then acc * scale,
// each rounded to nearest (__fmul_rn, no FMA), and bf16 output rounds to
// nearest even, so the result equals the plain version bit for bit.
//
// What bounds it on this card: at BERT-base's shapes (M = 24576 rows,
// (K, N) of (768, 768), (768, 3072), (3072, 768)) a call does 2MKN = 29 to
// 116 G integer operations against 95 to 321 MB of traffic, mostly the
// output: about 300 operations a byte, near the int8 tensor cores'
// balance point (1979 TOP/s over 3.35 TB/s = 591). Either bound is a few
// hundredths of a millisecond; what this first design spends is the
// shared-memory load throughput beside the tensor cores.
//
// The design (a simple tiled kernel; wgmma, TMA and a persistent schedule
// are a later redesign): a block of 256 threads computes a 128 x 128
// output tile, each of its 8 warps a 64 x 32 sub-tile as 4 x 4
// accumulators of the int8 tensor-core instruction
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (inline PTX; chosen over __dp4a
// because it runs the int8 product on the tensor cores, at many times
// dp4a's rate). K advances 64 at a time through two shared-memory stages
// filled by cp.async while the other is consumed. The instruction wants
// both operands contiguous in k: x_q rows are, and the A fragments are
// 32-bit loads from a 128 x 64 tile padded to 80-byte rows (conflict-
// free). w_q is k-major only across rows, so its 64 x 128 tile is kept as
// it lies in memory, in 136-byte rows, and each B fragment register
// gathers its four k bytes of one column with four byte loads and a pack;
// the padding puts the 8 words a warp touches per load in 8 banks. Rows
// past M read as zeros (cp.async zero fill) and are not stored.
//
// Plain C interface, bound from Python with ctypes; returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                 // output rows per block
constexpr int BN = 128;                 // output columns per block
constexpr int BK = 64;                  // k per stage
constexpr int THREADS = 256;            // 8 warps: 2 along M x 4 along N
constexpr int WM = 64;                  // warp tile rows
constexpr int WN = 32;                  // warp tile columns
constexpr int MT = WM / 16;             // m16 tiles per warp
constexpr int NT = WN / 8;              // n8 tiles per warp
constexpr int A_STRIDE = BK + 16;       // bytes per x_q row in shared memory
constexpr int B_STRIDE = BN + 8;        // bytes per w_q row in shared memory
constexpr int A_BYTES = BM * A_STRIDE;
constexpr int B_BYTES = BK * B_STRIDE;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// one stage: the x_q tile [BM][BK] and the w_q tile [BK][BN]
__device__ __forceinline__ void load_stage(
    int8_t* As, int8_t* Bs, const int8_t* __restrict__ x,
    const int8_t* __restrict__ w, int M, int K, int N, int m0, int n0,
    int k0) {
  const int tid = threadIdx.x;
  // x_q: BM rows of BK bytes, 4 chunks of 16 a row
#pragma unroll
  for (int i = 0; i < BM * BK / 16 / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 2, q = c & 3;
    const int m = m0 + r;
    const int8_t* src = x + (m < M ? (long long)m * K + k0 + q * 16 : 0);
    cp_async16(As + r * A_STRIDE + q * 16, src, m < M ? 16 : 0);
  }
  // w_q: BK rows of BN bytes, 16 chunks of 8 a row
#pragma unroll
  for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 4, q = c & 15;
    cp_async8(Bs + r * B_STRIDE + q * 8,
              w + (long long)(k0 + r) * N + n0 + q * 8);
  }
}

template <typename TO>
__global__ void __launch_bounds__(THREADS)
    int8_matmul_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ act_scale,
                       TO* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) int8_t As[2][A_BYTES];
  __shared__ __align__(16) int8_t Bs[2][B_BYTES];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * WM;       // warp's rows within the tile
  const int wn = (warp & 3) * WN;        // warp's columns within the tile
  const int g = lane >> 2;               // groupID
  const int t = lane & 3;                // threadID_in_group

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = K / BK;
  load_stage(As[0], Bs[0], x, w, M, K, N, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) {
      load_stage(As[s ^ 1], Bs[s ^ 1], x, w, M, K, N, m0, n0,
                 (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* A = As[s];
    const int8_t* B = Bs[s];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      // B fragments: b0 = k 4t..4t+3, b1 = k 16+4t..16+4t+3, column g
      uint32_t bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* col = B + wn + j * 8 + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int8_t* p = col + (kk + h * 16 + 4 * t) * B_STRIDE;
          const uint32_t b0 = static_cast<uint8_t>(p[0]);
          const uint32_t b1 = static_cast<uint8_t>(p[B_STRIDE]);
          const uint32_t b2 = static_cast<uint8_t>(p[2 * B_STRIDE]);
          const uint32_t b3 = static_cast<uint8_t>(p[3 * B_STRIDE]);
          bf[j][h] = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // A fragments: rows g and g+8, k 4t..4t+3 and 16+4t..16+4t+3
        const int8_t* r0 = A + (wm + i * 16 + g) * A_STRIDE + kk + 4 * t;
        const int8_t* r1 = r0 + 8 * A_STRIDE;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(r0);
        af[1] = *reinterpret_cast<const uint32_t*>(r1);
        af[2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        af[3] = *reinterpret_cast<const uint32_t*>(r1 + 16);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af, bf[j]);
      }
    }
    __syncthreads();
  }

  // epilogue: acc (rows g, g+8; columns 2t, 2t+1 of each n8 tile)
  const float a_s = *act_scale;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn + j * 8 + 2 * t;
    const float s0 = __fmul_rn(a_s, w_scale[n]);
    const float s1 = __fmul_rn(a_s, w_scale[n + 1]);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = m0 + wm + i * 16 + g;
      if (m < M)
        store2(out + (long long)m * N + n,
               __fmul_rn(__int2float_rn(acc[i][j][0]), s0),
               __fmul_rn(__int2float_rn(acc[i][j][1]), s1));
      if (m + 8 < M)
        store2(out + (long long)(m + 8) * N + n,
               __fmul_rn(__int2float_rn(acc[i][j][2]), s0),
               __fmul_rn(__int2float_rn(acc[i][j][3]), s1));
    }
  }
}

template <typename TO>
int launch(const void* x, const void* w, const void* w_scale,
           const void* act_scale, void* out, int M, int K, int N,
           cudaStream_t stream) {
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale),
      static_cast<const float*>(act_scale), static_cast<TO*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_q [M, K] and w_q [K, N] int8 row-major, w_scale [N] f32, act_scale one
// f32 (device pointers); out [M, N] in dtype (0 = float32, 1 = bfloat16).
// K and N must be multiples of 128 (the wrapper's shape gate), M >= 1.
extern "C" int int8_matmul(const void* x_q, const void* w_q,
                           const void* w_scale, const void* act_scale,
                           void* out, int M, int K, int N, int dtype,
                           void* stream) {
  if (M < 1 || K < 128 || N < 128 || K % 128 || N % 128 ||
      (M + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x_q, w_q, w_scale, act_scale, out, M, K, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x_q, w_q, w_scale, act_scale, out, M, K,
                                 N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
