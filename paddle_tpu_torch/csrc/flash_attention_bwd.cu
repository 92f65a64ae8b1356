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
// What bounds it on this card: operations. The function does five
// products a visible (row, column) pair, 10 D operations (s, dp, dq, dk,
// dv), against 8 D * 2 bytes a row (q, k, v, o, dO read once, dq, dk,
// dv written once): at GPT-2 345M's training shape 60 GFLOP (the split
// does seven products, 14 D) against 0.13 GB, so the bound is the bf16
// tensor-core rate of 989 TFLOP/s, far above the card's 3.35 TB/s line.
//
// float32 inputs (variants 0, 1) run the products on the CUDA cores in
// f32: tiles live in shared memory in rows of D + 4 floats (16-byte
// aligned, consecutive rows in different banks), each of 256 threads
// computes a 4x4 microtile of s and dp with 16-byte loads along D (rows
// ty + 16 i, columns tx + 16 j) and keeps a 4 x D/16 share of its
// accumulators in registers. Its ceiling is the card's f32 rate (67
// TFLOP/s); it is the reference path the f32 parity tests hold.
//
// bfloat16 inputs (variants 2, 3) run every product on the tensor cores
// (dkv_tc_kernel, dq_tc_kernel), as the TPU kernels run theirs on the
// MXU: `_dot` (:115) casts both operands to `_mxu_dtype` (bf16 under the
// default precision policy) and sums in f32, so p.V's and ds's operands
// enter the MXU rounded to bf16 (:476-478, :601, :645, :647). Here:
//   - operands stay bf16 in shared memory, in rows of D + 8 elements
//     (mma_bf16.cuh holds these building blocks, shared with the bf16
//     forward); tiles arrive by 16-byte cp.async, and the swept operand
//     (Q and dO in dkv, K and V in dq) is double-buffered, so the next
//     tile's copy overlaps this tile's math (commit_group / wait_group
//     1);
//   - products are mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
//     operands fed by ldmatrix (.trans where an operand is used
//     transposed), sums in f32;
//   - a block is 4 warps; each warp owns 16 rows of the block's 64
//     (keys in dkv, queries in dq). dkv computes S^T = K Q^T and dP^T =
//     V dO^T, dq computes S = Q K^T and dP = dO V^T, into f32 fragments;
//     p, pv, dsr and ds are formed in registers from each fragment's
//     (row, column): the lse shift (lse == -1e30 -> 0), the bias, the
//     causal and sequence-edge mask (only on tiles that cross an edge or
//     the diagonal), and the dropout keep bit of dropout_hash.cuh, so the
//     mask stays bit-equal to the forward's;
//   - pv and ds are rounded to bf16 and the accumulator fragments are
//     used directly as the A operands of dV += Pv^T dO, dK += dS^T Q and
//     dQ += dS K (an m16n8 f32 fragment pair is an m16k16 bf16 A
//     fragment), with no shared-memory round trip;
//   - dbias sums the f32 dsr, never the rounded ds, per key row in
//     registers over the sweep, then over the row's four lanes by quad
//     shuffles in a fixed order; db_sum_kernel sums the heads as before;
//   - the bias entries' delta: dkv_tc_kernel stages each query tile's o
//     rows beside its dO rows and sums delta from shared memory; dq_tc
//     sums it once from its dO tile and the o rows.
// The sweep tile is 64 rows, and 32 in dkv at D = 128, which keeps its
// dK/dV accumulators (128 floats a thread) clear of spills.
// wgmma, TMA and warp specialisation are a later redesign.
//
// Plain C interface, bound from Python with ctypes; each entry returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"
#include "mma_bf16.cuh"

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

// bh enters a kernel as the launch's base term, b0 * 0xAC564B05 +
// h0 * 19349663 for a launch over batch rows b0.. and heads h0.. of a
// larger tensor (0 for a whole one); each block adds its own (b, h), so
// the hash sees the absolute coordinates (b0 + b, h0 + h). row0 and col0
// are the absolute index of the launch's first query row and key column
// (a sequence shard, a ring attention's K/V block; 0 for a whole one).
// Only the unbiased kernels (row 3) take them: keep<false>, the biased
// kernels' (rows 4 and 5), compiles without the two adds.
struct Dropout {
  int on;
  uint32_t thr, seed, bh;
  float keep_scale;
  uint32_t row0, col0;
  template <bool BASES>
  __device__ __forceinline__ float keep(int row, int col) const {
    if (!on) return 1.f;
    const uint32_t r = BASES ? (uint32_t)row + row0 : (uint32_t)row;
    const uint32_t c = BASES ? (uint32_t)col + col0 : (uint32_t)col;
    return attention_keep(r, c, bh, seed, thr) ? keep_scale : 0.f;
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
      const float keep = drop.keep<!BIAS>(row, col);
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
  drop.bh += (uint32_t)b * 0xAC564B05u + (uint32_t)h * 19349663u;
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
  drop.bh += (uint32_t)b * 0xAC564B05u + (uint32_t)h * 19349663u;
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

// ---------------------------------------------------------------------------
// the bf16 path on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;   // 4 warps, 16 rows each
constexpr int TC_ROWS = 64;       // rows a block owns

// the swept query tile of dkv_tc_kernel
template <int D>
__host__ __device__ constexpr int dkv_qt() {
  return D == 128 ? 32 : 64;
}

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc += u.x * w.x + u.y * w.y;
  }
  return acc;
}

// delta_s[r] = rowsum(dO * o) of ROWS rows, dO from a shared tile and o
// from a shared tile (os_shared) or from device memory (o_rows at row 0,
// rows at or past n read as zeros)
template <int ROWS, int D>
__device__ __forceinline__ void tc_delta(float* delta_s, const bf16* dOs,
                                         const bf16* os_shared,
                                         const bf16* o_rows, int r0, int n,
                                         long long ld_row) {
  constexpr int TPR = TC_THREADS / ROWS;  // threads a row, adjacent lanes
  constexpr int PART = D / TPR;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const bf16* d = dOs + r * tc_ld<D>() + part * PART;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < PART; i += 8) {
    const uint4 dv = *reinterpret_cast<const uint4*>(d + i);
    uint4 ov;
    if (os_shared != nullptr) {
      ov = *reinterpret_cast<const uint4*>(os_shared + r * tc_ld<D>() +
                                           part * PART + i);
    } else {
      const int row = r0 + r;
      ov = row < n ? *reinterpret_cast<const uint4*>(o_rows + row * ld_row +
                                                     part * PART + i)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    acc += dot8(dv, ov);
  }
#pragma unroll
  for (int m = TPR / 2; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (part == 0) delta_s[r] = acc;
}

template <int D, bool BIAS>
constexpr int dkv_tc_smem_bytes() {
  // K and V tiles, then two stages of the swept Q, dO (and o) tiles, all
  // bf16; then two stages of lse and delta
  return (2 * TC_ROWS + 2 * (BIAS ? 3 : 2) * dkv_qt<D>()) * tc_ld<D>() * 2 +
         2 * 2 * dkv_qt<D>() * 4;
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(TC_THREADS)
    dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ bias,
                  const bf16* __restrict__ o, const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const bf16* __restrict__ dout, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, float* __restrict__ db_h, int Sq,
                  int Sk, int H, int causal, float scale, Dropout drop) {
  constexpr int QT = dkv_qt<D>();
  constexpr int LD = tc_ld<D>();
  constexpr int NQ = QT / 8;        // n8 tiles across a query tile
  constexpr int ND = D / 8;         // n8 tiles across D
  constexpr int NT = BIAS ? 3 : 2;  // tiles a stage
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + TC_ROWS * LD;
  bf16* stages = Vs + TC_ROWS * LD;  // stage s at stages + s * NT * QT * LD
  float* vecs = reinterpret_cast<float*>(stages + 2 * NT * QT * LD);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * TC_ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  drop.bh += (uint32_t)b * 0xAC564B05u + (uint32_t)h * 19349663u;
  const long long ld_row = (long long)H * D;
  const long long qoff = ((long long)b * Sq * H + h) * D;
  const long long koff = ((long long)b * Sk * H + h) * D;
  const float* lse_bh = lse + ((long long)b * H + h) * Sq;
  const float* delta_bh = BIAS ? nullptr : delta + ((long long)b * H + h) * Sq;
  const int off = Sk - Sq;
  const int kr = warp * 16 + g;  // this thread's key rows: kr, kr + 8

  float brow[2] = {0.f, 0.f};
  if (BIAS) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int key = k0 + kr + 8 * rr;
      brow[rr] = key < Sk ? bias[(long long)b * Sk + key] : 0.f;
    }
  }

  auto prefetch = [&](int tq, int s) {
    bf16* st = stages + s * NT * QT * LD;
    const int q0 = tq * QT;
    tile_async<QT, D, TC_THREADS>(st, q + qoff, q0, Sq, ld_row);
    tile_async<QT, D, TC_THREADS>(st + QT * LD, dout + qoff, q0, Sq,
                                  ld_row);
    if (BIAS)
      tile_async<QT, D, TC_THREADS>(st + 2 * QT * LD, o + qoff, q0, Sq,
                                    ld_row);
    float* vs = vecs + s * 2 * QT;
    vec_async<QT, TC_THREADS>(vs, lse_bh, q0, Sq);
    if (!BIAS) vec_async<QT, TC_THREADS>(vs + QT, delta_bh, q0, Sq);
  };

  // the first query row that sees key k0 is k0 - (Sk - Sq)
  const int first = causal ? max(0, k0 - off) / QT : 0;
  const int n_q = (Sq + QT - 1) / QT;
  tile_async<TC_ROWS, D, TC_THREADS>(Ks, k + koff, k0, Sk, ld_row);
  tile_async<TC_ROWS, D, TC_THREADS>(Vs, v + koff, k0, Sk, ld_row);
  if (first < n_q) prefetch(first, 0);
  cp_async_commit();

  float dk_acc[ND][4], dv_acc[ND][4], db[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int tq = first; tq < n_q; ++tq) {
    const int s = (tq - first) & 1;
    __syncthreads();  // the stage refilled next was read last iteration
    if (tq + 1 < n_q) prefetch(tq + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qs = stages + s * NT * QT * LD;
    const bf16* dOs = Qs + QT * LD;
    const float* lse_s = vecs + s * 2 * QT;
    float* delta_s = vecs + s * 2 * QT + QT;
    if (BIAS) {
      tc_delta<QT, D>(delta_s, dOs, dOs + QT * LD, nullptr, 0, 0, 0);
      __syncthreads();
    }

    // S^T = K Q^T and dP^T = V dO^T over this warp's 16 keys
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      const int arow = (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(ka, Ks + arow);
      ldsm_x4(va, Vs + arow);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        uint32_t qb[4], ob[4];
        const int brow_i = (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                           kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(qb, Qs + brow_i);
        ldsm_x4(ob, dOs + brow_i);
        mma_bf16(st[j], ka, qb[0], qb[1]);
        mma_bf16(st[j + 1], ka, qb[2], qb[3]);
        mma_bf16(dpt[j], va, ob[0], ob[1]);
        mma_bf16(dpt[j + 1], va, ob[2], ob[3]);
      }
    }

    // pv and ds in the fragments; element (j, e) is key k0 + kr + 8 (e / 2),
    // query q0 + 8 j + 2 t + e % 2
    const int q0 = tq * QT;
    const bool edge = q0 + QT > Sq || k0 + TC_ROWS > Sk ||
                      (causal && q0 + off < k0 + TC_ROWS - 1);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const int rr = e >> 1;
        const int qrow = q0 + c, key = k0 + kr + 8 * rr;
        const float l = lse_s[c] == NEG_INF ? 0.f : lse_s[c];
        const float x = BIAS ? st[j][e] * scale + brow[rr] : st[j][e] * scale;
        const bool visible =
            !edge || (qrow < Sq && key < Sk && (!causal || qrow + off >= key));
        const float p = visible ? expf(x - l) : 0.f;
        const float keep = drop.keep<!BIAS>(qrow, key);
        const float dsr = p * (dpt[j][e] * keep - delta_s[c]);
        st[j][e] = p * keep;      // pv
        dpt[j][e] = dsr * scale;  // ds
        if (BIAS) db[rr] += dsr;
      }

    // dV += Pv^T dO and dK += dS^T Q, the fragments as A operands
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      uint32_t pa[4], da[4];
      frag_a(pa, st, kk);
      frag_a(da, dpt, kk);
#pragma unroll
      for (int jd = 0; jd < ND; jd += 2) {
        uint32_t ob[4], qb[4];
        const int brow_i = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                           jd * 8 + (lane >> 4) * 8;
        ldsm_x4_t(ob, dOs + brow_i);
        ldsm_x4_t(qb, Qs + brow_i);
        mma_bf16(dv_acc[jd], pa, ob[0], ob[1]);
        mma_bf16(dv_acc[jd + 1], pa, ob[2], ob[3]);
        mma_bf16(dk_acc[jd], da, qb[0], qb[1]);
        mma_bf16(dk_acc[jd + 1], da, qb[2], qb[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = k0 + kr + 8 * rr;
    if (key < Sk) {
      bf16* dkrow = dk + koff + key * ld_row + 2 * t;
      bf16* dvrow = dv + koff + key * ld_row + 2 * t;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        *reinterpret_cast<uint32_t*>(dkrow + jd * 8) =
            pack_bf16(dk_acc[jd][2 * rr], dk_acc[jd][2 * rr + 1]);
        *reinterpret_cast<uint32_t*>(dvrow + jd * 8) =
            pack_bf16(dv_acc[jd][2 * rr], dv_acc[jd][2 * rr + 1]);
      }
    }
    if (BIAS) {
      // the row's four lanes, in a fixed order
      float acc = db[rr];
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (t == 0 && key < Sk) db_h[((long long)b * H + h) * Sk + key] = acc;
    }
  }
}

template <int D, bool BIAS>
constexpr int dq_tc_smem_bytes() {
  // Q and dO tiles, two stages of the swept K and V tiles, all bf16; then
  // two stages of the key tile's bias and the block's delta
  return (2 * TC_ROWS + 2 * 2 * TC_ROWS) * tc_ld<D>() * 2 +
         (2 * TC_ROWS + TC_ROWS) * 4;
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(TC_THREADS)
    dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 const bf16* __restrict__ o, const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const bf16* __restrict__ dout, bf16* __restrict__ dq, int Sq,
                 int Sk, int H, int causal, float scale, Dropout drop) {
  constexpr int KT = TC_ROWS;  // the swept key tile
  constexpr int LD = tc_ld<D>();
  constexpr int NK = KT / 8;   // n8 tiles across a key tile
  constexpr int ND = D / 8;    // n8 tiles across D
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* dOs = Qs + TC_ROWS * LD;
  bf16* stages = dOs + TC_ROWS * LD;  // stage s: K, V at stages + s * 2 KT LD
  float* bias_st = reinterpret_cast<float*>(stages + 2 * 2 * KT * LD);
  float* delta_s = bias_st + 2 * KT;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TC_ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  drop.bh += (uint32_t)b * 0xAC564B05u + (uint32_t)h * 19349663u;
  const long long ld_row = (long long)H * D;
  const long long qoff = ((long long)b * Sq * H + h) * D;
  const long long koff = ((long long)b * Sk * H + h) * D;
  const float* lse_bh = lse + ((long long)b * H + h) * Sq;
  const int off = Sk - Sq;
  const int qr = warp * 16 + g;  // this thread's query rows: qr, qr + 8

  auto prefetch = [&](int tk, int s) {
    bf16* st = stages + s * 2 * KT * LD;
    const int k0 = tk * KT;
    tile_async<KT, D, TC_THREADS>(st, k + koff, k0, Sk, ld_row);
    tile_async<KT, D, TC_THREADS>(st + KT * LD, v + koff, k0, Sk,
                                  ld_row);
    if (BIAS)
      vec_async<KT, TC_THREADS>(bias_st + s * KT, bias + (long long)b * Sk,
                                k0, Sk);
  };

  // the last key column any row of this tile may see
  int last_col = Sk - 1;
  if (causal) last_col = min(last_col, min(q0 + TC_ROWS, Sq) - 1 + off);
  const int n_k = last_col < 0 ? 0 : last_col / KT + 1;
  tile_async<TC_ROWS, D, TC_THREADS>(Qs, q + qoff, q0, Sq, ld_row);
  tile_async<TC_ROWS, D, TC_THREADS>(dOs, dout + qoff, q0, Sq, ld_row);
  if (n_k > 0) prefetch(0, 0);
  cp_async_commit();

  float l_r[2], d_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + qr + 8 * rr;
    const float l = row < Sq ? lse_bh[row] : 0.f;
    l_r[rr] = l == NEG_INF ? 0.f : l;
    d_r[rr] = (!BIAS && row < Sq) ? delta[((long long)b * H + h) * Sq + row]
                                  : 0.f;
  }
  if (BIAS) {
    cp_async_wait<0>();
    __syncthreads();
    tc_delta<TC_ROWS, D>(delta_s, dOs, nullptr, o + qoff, q0, Sq, ld_row);
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) d_r[rr] = delta_s[qr + 8 * rr];
  }

  float dq_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  for (int tk = 0; tk < n_k; ++tk) {
    const int s = tk & 1;
    __syncthreads();  // the stage refilled next was read last iteration
    if (tk + 1 < n_k) prefetch(tk + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Ks = stages + s * 2 * KT * LD;
    const bf16* Vs = Ks + KT * LD;
    const float* bias_s = bias_st + s * KT;

    // S = Q K^T and dP = dO V^T over this warp's 16 query rows
    float sc[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      const int arow = (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(qa, Qs + arow);
      ldsm_x4(oa, dOs + arow);
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        uint32_t kb[4], vb[4];
        const int brow_i = (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                           kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(kb, Ks + brow_i);
        ldsm_x4(vb, Vs + brow_i);
        mma_bf16(sc[j], qa, kb[0], kb[1]);
        mma_bf16(sc[j + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[j], oa, vb[0], vb[1]);
        mma_bf16(dp[j + 1], oa, vb[2], vb[3]);
      }
    }

    // ds in the fragments; element (j, e) is query q0 + qr + 8 (e / 2),
    // key k0 + 8 j + 2 t + e % 2
    const int k0 = tk * KT;
    const bool edge = q0 + TC_ROWS > Sq || k0 + KT > Sk ||
                      (causal && q0 + off < k0 + KT - 1);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const int rr = e >> 1;
        const int qrow = q0 + qr + 8 * rr, key = k0 + c;
        const float x = BIAS ? sc[j][e] * scale + bias_s[c] : sc[j][e] * scale;
        const bool visible =
            !edge || (qrow < Sq && key < Sk && (!causal || qrow + off >= key));
        const float p = visible ? expf(x - l_r[rr]) : 0.f;
        const float keep = drop.keep<!BIAS>(qrow, key);
        sc[j][e] = p * (dp[j][e] * keep - d_r[rr]) * scale;  // ds
      }

    // dQ += dS K, the fragments as A operands
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t da[4];
      frag_a(da, sc, kk);
#pragma unroll
      for (int jd = 0; jd < ND; jd += 2) {
        uint32_t kb[4];
        const int brow_i = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                           jd * 8 + (lane >> 4) * 8;
        ldsm_x4_t(kb, Ks + brow_i);
        mma_bf16(dq_acc[jd], da, kb[0], kb[1]);
        mma_bf16(dq_acc[jd + 1], da, kb[2], kb[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + qr + 8 * rr;
    if (row >= Sq) continue;
    bf16* dqrow = dq + qoff + row * ld_row + 2 * t;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      *reinterpret_cast<uint32_t*>(dqrow + jd * 8) =
          pack_bf16(dq_acc[jd][2 * rr], dq_acc[jd][2 * rr + 1]);
  }
}

template <int D, bool BIAS>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* bias, const void* o, const void* lse,
                  const void* delta, const void* dout, void* dk, void* dv,
                  void* db_h, int B, int Sq, int Sk, int H, int causal,
                  float scale, Dropout drop, cudaStream_t stream) {
  constexpr int bytes = dkv_tc_smem_bytes<D, BIAS>();
  cudaFuncSetAttribute(dkv_tc_kernel<D, BIAS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  dkv_tc_kernel<D, BIAS><<<dim3((Sk + TC_ROWS - 1) / TC_ROWS, H, B),
                           TC_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const bf16*>(o), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(db_h), Sq, Sk, H, causal, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool BIAS>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* bias, const void* o, const void* lse,
                 const void* delta, const void* dout, void* dq, int B, int Sq,
                 int Sk, int H, int causal, float scale, Dropout drop,
                 cudaStream_t stream) {
  constexpr int bytes = dq_tc_smem_bytes<D, BIAS>();
  cudaFuncSetAttribute(dq_tc_kernel<D, BIAS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  dq_tc_kernel<D, BIAS><<<dim3((Sq + TC_ROWS - 1) / TC_ROWS, H, B),
                          TC_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const bf16*>(o), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), Sq, Sk, H, causal, scale, drop);
  return static_cast<int>(cudaGetLastError());
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
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_dkv_tc<D, BIAS>(q, k, v, bias, o, lse, delta, dout, dk, dv,
                                  db_h, B, Sq, Sk, H, causal, scale, drop,
                                  stream);
  } else {
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
}

template <typename T, int D, bool BIAS>
int launch_dq(const void* q, const void* k, const void* v, const void* bias,
              const void* o, const void* lse, const void* delta,
              const void* dout, void* dq, int B, int Sq, int Sk, int H,
              int causal, float scale, Dropout drop, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_dq_tc<D, BIAS>(q, k, v, bias, o, lse, delta, dout, dq, B,
                                 Sq, Sk, H, causal, scale, drop, stream);
  } else {
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
// s0 ^ (s1 << 1), keep_scale = 1/(1-rate) in f32, bh_base the hash's
// batch and head base, row_base and col_base its first query row and key
// column (see Dropout; 0 for a whole tensor).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int B, int Sq, int Sk, int H, int D,
                                   int causal, float scale, int dropout,
                                   unsigned int thr, unsigned int seed,
                                   float keep_scale, unsigned int bh_base,
                                   unsigned int row_base,
                                   unsigned int col_base, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{dropout,    thr,      seed,    bh_base,
                     keep_scale, row_base, col_base};
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
// flash_attention_bwd without the delta scratch and the row and column
// bases, plus bias [B, Sk] f32.
extern "C" int flash_attention_bias_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias,
    const void* o, const void* lse, const void* dout, void* dq, int B,
    int Sq, int Sk, int H, int D, int causal, float scale, int dropout,
    unsigned int thr, unsigned int seed, float keep_scale,
    unsigned int bh_base, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{dropout, thr, seed, bh_base, keep_scale, 0u, 0u};
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
    float keep_scale, unsigned int bh_base, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{dropout, thr, seed, bh_base, keep_scale, 0u, 0u};
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
