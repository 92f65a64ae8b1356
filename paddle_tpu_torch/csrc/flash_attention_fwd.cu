// Flash-attention forward for Hopper (sm_90a), f32 or bf16 in, f32 math.
//
// Replaces two TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// _fwd2 (_fwd2_kernel, pallas_call at :399), exported as
// flash_attention_fwd, and _fwd_v1 (_fwd_kernel, pallas_call at :239),
// the same forward plus an additive f32 key bias [B, Sk] (the
// [B, 1, 1, Sk] padding mask of BERT and ERNIE), exported as
// flash_attention_bias_fwd. The bias is a template parameter of one
// kernel; it is added after the scale and before the causal mask, as
// _fwd_kernel does (:144-148), as the number it is: an f32 -1e30 absorbs
// any score below 3e22 and a fully masked row then has m == -1e30, so
// the shift-0 guard below gives o = 0 and lse = -1e30; the bf16-rounded
// mask (-1.00026e30) lies below the running max's starting value -1e30,
// with the same result, as in the TPU kernel.
//
// Both: online-softmax attention over the framework layout [B, S, H, D]
// (the same memory as _fwd2's packed [B, S, H*D]; _fwd_v1's [B, H, S, D]
// transpose was its own tiling's), causal masking bottom-right aligned
// (row + Sk - Sq >= col,
// _causal_mask), optional per-row lse [B, H, Sq] in f32, and the
// in-kernel attention dropout of _dropout_keep (:87): the keep bit is a
// hash of the absolute (b, h, query row, key column) and two seed words
// (dropout_hash.cuh), it masks the p.V accumulation only, and the
// softmax denominator l sums the undropped p (:320-333), so the backward
// regenerates the same mask from the same words.
//
// What bounds it on this card: at the serving shapes (D = 64, S <= 512)
// the work is ~4*S*D operations per byte of q/k/v, far above the card's
// ratio of operations to bytes, so arithmetic bounds it. This first
// version does the products on the CUDA cores in f32 (bf16 inputs are
// widened on load), so its ceiling is the card's f32 rate, not the
// tensor cores'; wgmma and TMA come later. What the design does about
// it: one block per (b, h, 64-row q tile); q, k and v tiles live in
// shared memory and each thread keeps a 4x4 score microtile and its
// 4 x D/16 share of the output in registers, so every shared-memory
// float4 feeds 16 fused multiply-adds; the online (m, l) statistics stay
// in registers; causal tiles wholly above the diagonal are never loaded.
// The sequence edge is masked in-kernel, so any S works.
//
// Plain C interface, bound from Python with ctypes; returns
// cudaGetLastError() after the launch. The bias entry reads one 64-float
// bias slice per key tile into shared memory with the K and V tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout_hash.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // key rows per tile
constexpr int THREADS = 256;      // 16 x 16 threads, 4x4 microtile each
constexpr int LD = BQ + 4;        // transposed row stride, float4-aligned
constexpr float NEG_INF = -1e30f; // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int smem_floats() {
  // Qt [D][LD] + Kt [D][LD] + Vs [BK][D] + Pt [BK][LD] + bias [BK]
  return 2 * D * LD + BK * D + BK * LD + BK;
}

template <typename T, int D, bool BIAS>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ o, float* __restrict__ lse, int Sq,
                     int Sk, int H, int causal, float scale, int dropout,
                     uint32_t thr, uint32_t seed, float keep_scale) {
  constexpr int DC = D / 16;  // output columns per thread (4 or 8)
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // q tile, transposed
  float* Kt = Qt + D * LD;                      // k tile, transposed
  float* Vs = Kt + D * LD;                      // v tile
  float* Pt = Vs + BK * D;                      // probabilities, transposed
  float* Bs = Pt + BK * LD;                     // the key tile's bias

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key columns tx*4.. / output columns
  const int ty = tid / 16;  // query rows ty*4..
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long ld_row = (long long)H * D;  // stride between positions
  const T* qb = q + ((long long)b * Sq * H + h) * D;
  const T* kb = k + ((long long)b * Sk * H + h) * D;
  const T* vb = v + ((long long)b * Sk * H + h) * D;
  const int off = Sk - Sq;
  const uint32_t bh = (uint32_t)b * 0xAC564B05u + (uint32_t)h * 19349663u;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    Qt[d * LD + r] = row < Sq ? to_f32(qb[row * ld_row + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // the last key column any row of this tile may see: causal tiles
  // wholly above the diagonal are skipped, loads included
  int last_col = Sk - 1;
  if (causal) last_col = min(last_col, min(q0 + BQ, Sq) - 1 + off);
  const int n_tiles = last_col < 0 ? 0 : last_col / BK + 1;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // Qt written; the previous tile's readers are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int col = k0 + r;
      const bool in = col < Sk;
      Kt[d * LD + r] = in ? to_f32(kb[col * ld_row + d]) : 0.f;
      Vs[r * D + d] = in ? to_f32(vb[col * ld_row + d]) : 0.f;
    }
    if (BIAS && tid < BK)
      Bs[tid] = k0 + tid < Sk ? bias[(long long)b * Sk + k0 + tid] : 0.f;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LD + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // online softmax, one row at a time; the 16 threads of a row are 16
    // neighbouring lanes of one warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool keep = col < Sk && (!causal || row + off >= col);
        const float x = BIAS ? s[i][j] * scale + Bs[tx * 4 + j]
                             : s[i][j] * scale;
        s[i][j] = keep ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      // a row with nothing visible yet keeps shift 0, so masked columns
      // give exactly 0 and never NaN (the TPU kernel's guard)
      const float shift = m_new == NEG_INF ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - shift);
        rs += s[i][j];
      }
      const float alpha = expf(m[i] - shift);
      l[i] = alpha * l[i] + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      // dropout scales what reaches p.V; l above kept the undropped p
      if (dropout) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] *= attention_keep(row, k0 + tx * 4 + j, bh, seed, thr)
                         ? keep_scale
                         : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Pt[kk * LD + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < DC / 4; ++g) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&Vs[kk * D + g * 64 + tx * 4]);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][g * 4 + c] = fmaf(pv[i], vv[c], acc[i][g * 4 + c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int g = 0; g < DC / 4; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        store(&orow[g * 64 + tx * 4 + c], acc[i][g * 4 + c] / safe_l);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Sq + row] =
          l[i] == 0.f ? NEG_INF : m[i] + logf(safe_l);
  }
}

template <typename T, int D, bool BIAS>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, void* lse, int B, int Sq, int Sk, int H, int causal,
           float scale, int dropout, uint32_t thr, uint32_t seed,
           float keep_scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * 4;
  cudaFuncSetAttribute(flash_fwd_kernel<T, D, BIAS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D, BIAS><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), static_cast<float*>(lse), Sq, Sk, H, causal, scale,
      dropout, thr, seed, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool BIAS>
int run(const void* q, const void* k, const void* v, const void* bias,
        void* o, void* lse, int B, int Sq, int Sk, int H, int D, int causal,
        float scale, int dropout, uint32_t thr, uint32_t seed,
        float keep_scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_FWD_ARGS \
  q, k, v, bias, o, lse, B, Sq, Sk, H, causal, scale, dropout, thr, seed, \
      keep_scale, st
  if (dtype == 0 && D == 64) return launch<float, 64, BIAS>(FLASH_FWD_ARGS);
  if (dtype == 0 && D == 128) return launch<float, 128, BIAS>(FLASH_FWD_ARGS);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64, BIAS>(FLASH_FWD_ARGS);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128, BIAS>(FLASH_FWD_ARGS);
#undef FLASH_FWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse may be null. dropout != 0 drops
// with threshold thr (keep_threshold(rate)), seed = s0 ^ (s1 << 1) and
// keep_scale = 1/(1-rate) in f32.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int Sq, int Sk, int H, int D, int causal,
                                   float scale, int dropout, unsigned int thr,
                                   unsigned int seed, float keep_scale,
                                   int dtype, void* stream) {
  return run<false>(q, k, v, nullptr, o, lse, B, Sq, Sk, H, D, causal, scale,
                    dropout, thr, seed, keep_scale, dtype, stream);
}

// The same with bias [B, Sk] f32 contiguous added to every query row's
// scores of batch row b.
extern "C" int flash_attention_bias_fwd(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        void* o, void* lse, int B, int Sq,
                                        int Sk, int H, int D, int causal,
                                        float scale, int dropout,
                                        unsigned int thr, unsigned int seed,
                                        float keep_scale, int dtype,
                                        void* stream) {
  return run<true>(q, k, v, bias, o, lse, B, Sq, Sk, H, D, causal, scale,
                   dropout, thr, seed, keep_scale, dtype, stream);
}
