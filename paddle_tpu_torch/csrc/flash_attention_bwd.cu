// Flash-attention backward for Hopper (sm_90a), f32 or bf16 in, f32 math.
//
// Replaces three TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   - _bwd2 (_bwd2_kernel, pallas_call at :532), the fused no-bias
//     backward, exported as flash_attention_bwd;
//   - the _bwd_v1 dq kernel (_dq_kernel, pallas_call at :702), exported as
//     flash_attention_bias_bwd_dq;
//   - the _bwd_v1 dk/dv kernel (_dkv_kernel, pallas_call at :753), which
//     also returns the key bias's gradient, exported as
//     flash_attention_bias_bwd_dkv.
// All compute dq, dk and dv of causal or full online-softmax attention
// over the framework layout [B, S, H, D], from q, k, v, the forward's
// output o and its per-row lse [B, H, Sq] (f32), with delta = rowsum(dO*O)
// and the forward's dropout mask regenerated from the same seed words
// (dropout_hash.cuh), never stored:
//   p  = exp(s * scale (+ bias) - lse)   (lse == -1e30 -> shift 0, :464)
//   pv = p * keep,  dp = (dO . v) * keep
//   dsr = p * (dp - delta),  ds = dsr * scale
//   dq = ds k,  dk = ds^T q,  dv = pv^T dO,  dbias[h] = sum_q dsr
// The bias ([B, Sk] f32, the [B, 1, 1, Sk] padding mask) is a template
// parameter of the same two kernels; dbias is ds/scale summed over the
// query rows per head (:651) and then over heads (:769).
//
// The TPU kernels carry dk/dv and a full-length dq in VMEM scratch across
// a sequential grid. On Hopper blocks run in parallel and in no order, so
// this port splits the work, with no atomics (the result is deterministic,
// so a resumed run repeats itself bit for bit):
//   1. delta_kernel (no-bias entry only): one warp per (b, query row, h)
//      computes delta once; the two bias entries are separate launches,
//      so each computes delta in the kernel from its own dO tile and the
//      o rows, as _dq_kernel and _dkv_kernel do (:587-589, :628-630).
//      The no-bias entry keeps the pre-pass: with tile_delta in its dk/dv
//      and dq kernels instead, it took 4.233 ms against 3.667 ms at
//      GPT-2 345M's training shape (B=8, S=1024, H=16, D=64, bf16,
//      causal, dropout 0.1; H100 80GB HBM3 at 700 W,
//      tools/time_flash_bwd.py), bit-identical results;
//   2. dkv_kernel: one block per (b, h, 64-key tile) keeps its K and V
//      tiles and its dk/dv (and per-head dbias) accumulators, and sweeps
//      the query tiles that can see those keys;
//   3. dq_kernel: one block per (b, h, 64-query tile) keeps its Q and dO
//      tiles and its dq accumulator, and sweeps the visible key tiles;
//   4. db_sum_kernel (bias dk/dv entry only): dbias summed over heads in
//      a fixed order.
// Scores and dp are computed in both 2 and 3 (14 D operations per
// visible (row, column) pair against the fused TPU kernel's 10).
//
// What bounds it on this card: arithmetic (about 10 D operations per
// visible pair against 4 D * 4 bytes of q/k/v/o/dO per row). This first
// version runs the products on the CUDA cores in f32 (bf16 is widened on
// load), so its ceiling is the card's f32 rate; wgmma comes later. What
// the design does about it: tiles live in shared memory in rows of D + 4
// floats (16-byte aligned, and consecutive rows fall in different banks),
// each thread computes a 4x4 microtile of s and dp with 16-byte loads
// along D (rows ty + 16 i, columns tx + 16 j) and keeps a 4 x D/16 share
// of its accumulators in registers; causal tiles that no row can see are
// never loaded. The sequence edge is masked in-kernel, so any S works.
// dbias needs 4 more registers a thread for its column partial sums,
// merged once through shared memory at the end.
//
// Plain C interface, bound from Python with ctypes; each entry returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // key rows per tile
constexpr int THREADS = 256;      // 16 x 16 threads
constexpr int LDP = BK + 16;      // row stride of the [q][key] p/ds tiles
constexpr int LDQ = BQ + 4;       // row stride of the [key][q] ds tile
constexpr float NEG_INF = -1e30f; // the TPU kernel's mask value

template <int D>
__host__ __device__ constexpr int ldt() {
  return D + 4;  // row stride of the [row][D] q/k/v/dO tiles
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float comp(float4 a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// copy rows r0.. of a [*, H, D] tensor (head h, batch b already applied
// to `src`) into a [64][D+4] f32 tile; rows at or past n are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n, long long ld_row) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    dst[r * ldt<D>() + d] = row < n ? to_f32(src[row * ld_row + d]) : 0.f;
  }
}

// bias_s[c] = bias_b[c0 + c] for the 64 columns of a key tile
__device__ __forceinline__ void load_bias(float* bias_s, const float* bias_b,
                                          int c0, int Sk) {
  if (threadIdx.x < BK)
    bias_s[threadIdx.x] =
        c0 + threadIdx.x < Sk ? bias_b[c0 + threadIdx.x] : 0.f;
}

// delta_s[r] = rowsum(dO * o) of query rows q0 + r, from the dO tile in
// shared memory and the o rows in device memory (`o` at batch b, head h);
// one warp per row, summed in the order delta_kernel sums
template <typename T, int D>
__device__ __forceinline__ void tile_delta(float* delta_s, const float* dOs,
                                           const T* o, int q0, int Sq,
                                           long long ld_row) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < Sq) {
#pragma unroll
      for (int d = lane; d < D; d += 32)
        acc += dOs[r * ldt<D>() + d] * to_f32(o[row * ld_row + d]);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (lane == 0) delta_s[r] = acc;
  }
}

// s[i][j] = a[ty + 16 i] . b[tx + 16 j] over D, from two [64][D+4] tiles
template <int D>
__device__ __forceinline__ void microtile(const float* a, const float* b,
                                          int ty, int tx, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(&a[(ty + 16 * i) * ldt<D>() + d]);
      bv[i] = *reinterpret_cast<const float4*>(&b[(tx + 16 * i) * ldt<D>() + d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += dot4(av[i], bv[j]);
  }
}

struct Dropout {
  int on;
  uint32_t thr, seed, bh;
  float keep_scale;
  __device__ __forceinline__ float keep(int row, int col) const {
    if (!on) return 1.f;
    return attention_keep(row, col, bh, seed, thr) ? keep_scale : 0.f;
  }
};

// p and ds of one 4x4 microtile: rows (queries) q0 + ty + 16 i, columns
// (keys) k0 + tx + 16 j; lse_s holds the shifted lse, delta_s delta,
// bias_s the key tile's bias (BIAS only); db[j] accumulates column j's
// dsr = ds / scale (BIAS only)
template <bool BIAS>
__device__ __forceinline__ void probs_and_ds(
    float (&s)[4][4], float (&dp)[4][4], const float* lse_s,
    const float* delta_s, const float* bias_s, float (&db)[4], int q0,
    int k0, int ty, int tx, int Sq, int Sk, int causal, float scale,
    const Dropout& drop) {
  const int off = Sk - Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool visible =
          row < Sq && col < Sk && (!causal || row + off >= col);
      const float x = BIAS ? s[i][j] * scale + bias_s[tx + 16 * j]
                           : s[i][j] * scale;
      const float p = visible ? expf(x - lse_s[r]) : 0.f;
      const float keep = drop.keep(row, col);
      const float dsr = p * (dp[i][j] * keep - delta_s[r]);
      s[i][j] = p * keep;   // pv
      dp[i][j] = dsr * scale;  // ds
      if (BIAS) db[j] += dsr;
    }
  }
}

template <typename T, int D>
__global__ void delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ delta, int rows, int Sq,
                             int H) {
  // one warp per (b, query row, h), in the memory order of [B, S, H, D]
  const int warp = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= rows) return;
  const T* orow = o + (long long)warp * D;
  const T* drow = dout + (long long)warp * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc += to_f32(drow[d]) * to_f32(orow[d]);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    const int h = warp % H;
    const int bs = warp / H;  // b * Sq + row
    const int b = bs / Sq, row = bs % Sq;
    delta[((long long)b * H + h) * Sq + row] = acc;
  }
}

template <int D>
constexpr int dkv_smem_floats() {
  // K, V, Q, dO tiles + p and ds tiles + lse and delta + the key tile's
  // bias + the dbias partial sums of the 16 thread rows
  return 4 * 64 * ldt<D>() + 2 * BQ * LDP + 2 * BQ + BK + 16 * BK;
}

template <typename T, int D, bool BIAS>
__global__ void __launch_bounds__(THREADS)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ bias,
               const T* __restrict__ o, const float* __restrict__ lse,
               const float* __restrict__ delta, const T* __restrict__ dout,
               T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ db_h, int Sq, int Sk, int H, int causal,
               float scale, Dropout drop) {
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + 64 * ldt<D>();
  float* Qs = Vs + 64 * ldt<D>();
  float* dOs = Qs + 64 * ldt<D>();
  float* Ps = dOs + 64 * ldt<D>();   // [q][key] p * keep
  float* dSs = Ps + BQ * LDP;        // [q][key] ds
  float* lse_s = dSs + BQ * LDP;
  float* delta_s = lse_s + BQ;
  float* bias_s = delta_s + BQ;
  float* db_s = bias_s + BK;         // [16][BK]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y, b = blockIdx.z;
  drop.bh = (uint32_t)b * 0xAC564B05u + (uint32_t)h * 19349663u;
  const long long ld_row = (long long)H * D;
  const long long qoff = ((long long)b * Sq * H + h) * D;
  const long long koff = ((long long)b * Sk * H + h) * D;
  const float* lse_bh = lse + ((long long)b * H + h) * Sq;

  load_tile<T, D>(Ks, k + koff, k0, Sk, ld_row);
  load_tile<T, D>(Vs, v + koff, k0, Sk, ld_row);
  if (BIAS) load_bias(bias_s, bias + (long long)b * Sk, k0, Sk);

  float dk_acc[4][DC], dv_acc[4][DC], db[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // the first query row that sees key k0 is k0 - (Sk - Sq)
  const int first = causal ? max(0, k0 - (Sk - Sq)) / BQ : 0;
  const int n_q = (Sq + BQ - 1) / BQ;
  for (int t = first; t < n_q; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Qs, q + qoff, q0, Sq, ld_row);
    load_tile<T, D>(dOs, dout + qoff, q0, Sq, ld_row);
    if (tid < BQ) {
      const int row = q0 + tid;
      const float l = row < Sq ? lse_bh[row] : 0.f;
      lse_s[tid] = l == NEG_INF ? 0.f : l;
      if (!BIAS)
        delta_s[tid] =
            row < Sq ? delta[((long long)b * H + h) * Sq + row] : 0.f;
    }
    __syncthreads();
    if (BIAS) {
      tile_delta<T, D>(delta_s, dOs, o + qoff, q0, Sq, ld_row);
      __syncthreads();
    }

    float s[4][4], dp[4][4];
    microtile<D>(Qs, Ks, ty, tx, s);
    microtile<D>(dOs, Vs, ty, tx, dp);
    probs_and_ds<BIAS>(s, dp, lse_s, delta_s, bias_s, db, q0, k0, ty, tx,
                       Sq, Sk, causal, scale, drop);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
        dSs[(ty + 16 * i) * LDP + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();

    // dv[key] += pv[q][key] dO[q], dk[key] += ds[q][key] q[q]; this
    // thread's keys are ty * 4 + i, its columns g * 64 + tx * 4 + c
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Ps[r * LDP + ty * 4]);
      const float4 d4 = *reinterpret_cast<const float4*>(&dSs[r * LDP + ty * 4]);
#pragma unroll
      for (int g = 0; g < DC / 4; ++g) {
        const float4 o4 =
            *reinterpret_cast<const float4*>(&dOs[r * ldt<D>() + g * 64 + tx * 4]);
        const float4 q4 =
            *reinterpret_cast<const float4*>(&Qs[r * ldt<D>() + g * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dv_acc[i][g * 4 + c] += comp(p4, i) * comp(o4, c);
            dk_acc[i][g * 4 + c] += comp(d4, i) * comp(q4, c);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Sk) continue;
    T* dkrow = dk + koff + key * ld_row;
    T* dvrow = dv + koff + key * ld_row;
#pragma unroll
    for (int g = 0; g < DC / 4; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        store(&dkrow[g * 64 + tx * 4 + c], dk_acc[i][g * 4 + c]);
        store(&dvrow[g * 64 + tx * 4 + c], dv_acc[i][g * 4 + c]);
      }
  }

  if (BIAS) {
    // merge the 16 thread rows' column sums in a fixed order
#pragma unroll
    for (int j = 0; j < 4; ++j) db_s[ty * BK + tx + 16 * j] = db[j];
    __syncthreads();
    if (tid < BK && k0 + tid < Sk) {
      float acc = 0.f;
      for (int r = 0; r < 16; ++r) acc += db_s[r * BK + tid];
      db_h[((long long)b * H + h) * Sk + k0 + tid] = acc;
    }
  }
}

template <int D>
constexpr int dq_smem_floats() {
  // Q, dO, K, V tiles + the [key][q] ds tile + lse and delta + the key
  // tile's bias
  return 4 * 64 * ldt<D>() + BK * LDQ + 2 * BQ + BK;
}

template <typename T, int D, bool BIAS>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ bias,
              const T* __restrict__ o, const float* __restrict__ lse,
              const float* __restrict__ delta, const T* __restrict__ dout,
              T* __restrict__ dq, int Sq, int Sk, int H, int causal,
              float scale, Dropout drop) {
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + 64 * ldt<D>();
  float* Ks = dOs + 64 * ldt<D>();
  float* Vs = Ks + 64 * ldt<D>();
  float* dSt = Vs + 64 * ldt<D>();   // [key][q] ds
  float* lse_s = dSt + BK * LDQ;
  float* delta_s = lse_s + BQ;
  float* bias_s = delta_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  drop.bh = (uint32_t)b * 0xAC564B05u + (uint32_t)h * 19349663u;
  const long long ld_row = (long long)H * D;
  const long long qoff = ((long long)b * Sq * H + h) * D;
  const long long koff = ((long long)b * Sk * H + h) * D;
  const float* lse_bh = lse + ((long long)b * H + h) * Sq;

  load_tile<T, D>(Qs, q + qoff, q0, Sq, ld_row);
  load_tile<T, D>(dOs, dout + qoff, q0, Sq, ld_row);
  if (tid < BQ) {
    const int row = q0 + tid;
    const float l = row < Sq ? lse_bh[row] : 0.f;
    lse_s[tid] = l == NEG_INF ? 0.f : l;
    if (!BIAS)
      delta_s[tid] =
          row < Sq ? delta[((long long)b * H + h) * Sq + row] : 0.f;
  }
  if (BIAS) {
    __syncthreads();  // dO loaded
    tile_delta<T, D>(delta_s, dOs, o + qoff, q0, Sq, ld_row);
  }

  float acc[4][DC], unused[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  // the last key column any row of this tile may see
  int last_col = Sk - 1;
  if (causal) last_col = min(last_col, min(q0 + BQ, Sq) - 1 + (Sk - Sq));
  const int n_k = last_col < 0 ? 0 : last_col / BK + 1;
  for (int t = 0; t < n_k; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // Q/dO/delta ready; the previous tile's readers done
    load_tile<T, D>(Ks, k + koff, k0, Sk, ld_row);
    load_tile<T, D>(Vs, v + koff, k0, Sk, ld_row);
    if (BIAS) load_bias(bias_s, bias + (long long)b * Sk, k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    microtile<D>(Qs, Ks, ty, tx, s);
    microtile<D>(dOs, Vs, ty, tx, dp);
    probs_and_ds<BIAS>(s, dp, lse_s, delta_s, bias_s, unused, q0, k0, ty,
                       tx, Sq, Sk, causal, scale, drop);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSt[(tx + 16 * j) * LDQ + ty + 16 * i] = dp[i][j];
    __syncthreads();

    // dq[q] += ds[q][key] k[key]; this thread's queries are ty * 4 + i
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      const float4 d4 = *reinterpret_cast<const float4*>(&dSt[kk * LDQ + ty * 4]);
#pragma unroll
      for (int g = 0; g < DC / 4; ++g) {
        const float4 k4 =
            *reinterpret_cast<const float4*>(&Ks[kk * ldt<D>() + g * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][g * 4 + c] += comp(d4, i) * comp(k4, c);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    T* dqrow = dq + qoff + row * ld_row;
#pragma unroll
    for (int g = 0; g < DC / 4; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        store(&dqrow[g * 64 + tx * 4 + c], acc[i][g * 4 + c]);
  }
}

// db[b, c] = sum over h of db_h[b, h, c], heads in order
__global__ void db_sum_kernel(const float* __restrict__ db_h,
                              float* __restrict__ db, int B, int H, int Sk) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)B * Sk) return;
  const long long b = i / Sk, c = i % Sk;
  float acc = 0.f;
  for (int h = 0; h < H; ++h) acc += db_h[(b * H + h) * Sk + c];
  db[i] = acc;
}

template <typename T, int D, bool BIAS>
int launch_dkv(const void* q, const void* k, const void* v, const void* bias,
               const void* o, const void* lse, const void* delta,
               const void* dout, void* dk, void* dv, void* db_h, int B,
               int Sq, int Sk, int H, int causal, float scale, Dropout drop,
               cudaStream_t stream) {
  constexpr int bytes = dkv_smem_floats<D>() * 4;
  cudaFuncSetAttribute(dkv_kernel<T, D, BIAS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  dkv_kernel<T, D, BIAS><<<dim3((Sk + BK - 1) / BK, H, B), THREADS, bytes,
                           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(o), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const T*>(dout),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(db_h),
      Sq, Sk, H, causal, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool BIAS>
int launch_dq(const void* q, const void* k, const void* v, const void* bias,
              const void* o, const void* lse, const void* delta,
              const void* dout, void* dq, int B, int Sq, int Sk, int H,
              int causal, float scale, Dropout drop, cudaStream_t stream) {
  constexpr int bytes = dq_smem_floats<D>() * 4;
  cudaFuncSetAttribute(dq_kernel<T, D, BIAS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  dq_kernel<T, D, BIAS><<<dim3((Sq + BQ - 1) / BQ, H, B), THREADS, bytes,
                          stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(o), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const T*>(dout),
      static_cast<T*>(dq), Sq, Sk, H, causal, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* delta, int B, int Sq, int Sk, int H, int causal, float scale,
           Dropout drop, cudaStream_t stream) {
  const int rows = B * Sq * H;
  delta_kernel<T, D><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
                       stream>>>(static_cast<const T*>(o),
                                 static_cast<const T*>(dout),
                                 static_cast<float*>(delta), rows, Sq, H);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = launch_dkv<T, D, false>(q, k, v, nullptr, o, lse, delta, dout, dk, dv,
                                nullptr, B, Sq, Sk, H, causal, scale, drop,
                                stream);
  if (err) return err;
  return launch_dq<T, D, false>(q, k, v, nullptr, o, lse, delta, dout, dq, B,
                                Sq, Sk, H, causal, scale, drop, stream);
}

// which of the four (dtype, D) instantiations; -1 if none
int variant(int dtype, int D) {
  if (dtype != 0 && dtype != 1) return -1;
  if (D != 64 && D != 128) return -1;
  return dtype * 2 + (D == 128);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o, dout [B, S, H, D]
// contiguous; lse [B, H, Sq] f32; delta is [B, H, Sq] f32 scratch.
// dropout != 0 regenerates the forward's mask: threshold thr, seed =
// s0 ^ (s1 << 1), keep_scale = 1/(1-rate) in f32.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int B, int Sq, int Sk, int H, int D,
                                   int causal, float scale, int dropout,
                                   unsigned int thr, unsigned int seed,
                                   float keep_scale, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{dropout, thr, seed, 0u, keep_scale};
#define FLASH_BWD_ARGS \
  q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, causal, scale, \
      drop, st
  switch (variant(dtype, D)) {
    case 0: return launch<float, 64>(FLASH_BWD_ARGS);
    case 1: return launch<float, 128>(FLASH_BWD_ARGS);
    case 2: return launch<__nv_bfloat16, 64>(FLASH_BWD_ARGS);
    case 3: return launch<__nv_bfloat16, 128>(FLASH_BWD_ARGS);
  }
#undef FLASH_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// dq of the biased forward (flash_attention_bias_fwd): the arguments of
// flash_attention_bwd without the delta scratch, plus bias [B, Sk] f32.
extern "C" int flash_attention_bias_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias,
    const void* o, const void* lse, const void* dout, void* dq, int B,
    int Sq, int Sk, int H, int D, int causal, float scale, int dropout,
    unsigned int thr, unsigned int seed, float keep_scale, int dtype,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{dropout, thr, seed, 0u, keep_scale};
#define FLASH_DQ_ARGS \
  q, k, v, bias, o, lse, nullptr, dout, dq, B, Sq, Sk, H, causal, scale, \
      drop, st
  switch (variant(dtype, D)) {
    case 0: return launch_dq<float, 64, true>(FLASH_DQ_ARGS);
    case 1: return launch_dq<float, 128, true>(FLASH_DQ_ARGS);
    case 2: return launch_dq<__nv_bfloat16, 64, true>(FLASH_DQ_ARGS);
    case 3: return launch_dq<__nv_bfloat16, 128, true>(FLASH_DQ_ARGS);
  }
#undef FLASH_DQ_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// dk, dv and db [B, Sk] f32 of the biased forward; db_h is [B, H, Sk] f32
// scratch for the per-head rows.
extern "C" int flash_attention_bias_bwd_dkv(
    const void* q, const void* k, const void* v, const void* bias,
    const void* o, const void* lse, const void* dout, void* dk, void* dv,
    void* db_h, void* db, int B, int Sq, int Sk, int H, int D, int causal,
    float scale, int dropout, unsigned int thr, unsigned int seed,
    float keep_scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{dropout, thr, seed, 0u, keep_scale};
#define FLASH_DKV_ARGS \
  q, k, v, bias, o, lse, nullptr, dout, dk, dv, db_h, B, Sq, Sk, H, causal, \
      scale, drop, st
  int err = static_cast<int>(cudaErrorInvalidValue);
  switch (variant(dtype, D)) {
    case 0: err = launch_dkv<float, 64, true>(FLASH_DKV_ARGS); break;
    case 1: err = launch_dkv<float, 128, true>(FLASH_DKV_ARGS); break;
    case 2: err = launch_dkv<__nv_bfloat16, 64, true>(FLASH_DKV_ARGS); break;
    case 3: err = launch_dkv<__nv_bfloat16, 128, true>(FLASH_DKV_ARGS); break;
  }
#undef FLASH_DKV_ARGS
  if (err) return err;
  const long long n = (long long)B * Sk;
  db_sum_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      static_cast<const float*>(db_h), static_cast<float*>(db), B, H, Sk);
  return static_cast<int>(cudaGetLastError());
}
