// Flash-attention forward for Hopper (sm_90a): float32 and bfloat16 inputs,
// both on the tensor cores.
//
// Replaces two TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// _fwd2 (_fwd2_kernel, pallas_call at :399), exported as
// flash_attention_fwd, and _fwd_v1 (_fwd_kernel, pallas_call at :239),
// the same forward plus an additive f32 key bias [B, Sk] (the
// [B, 1, 1, Sk] padding mask of BERT and ERNIE), exported as
// flash_attention_bias_fwd. The bias is a template parameter of each
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
// What bounds it on this card: the function does two products a visible
// (row, column) pair, 4 D operations, against 8 D bytes a row in bf16 (q,
// k, v read once, o written once), so with n visible keys a row it does
// n / 2 operations a byte: about 256 at GPT-2 345M's training shape
// (causal S = 1024, 512 keys a row on average) and 242 at BERT-base's
// padded batch (S = 512, 485), just below the card's 295 bf16 operations
// a byte of device memory. So the memory rate bounds it by a little and
// the tensor-core rate close behind (chip_smoke.py's bound_ms). Beside
// the products, every visible pair costs an exp, a max, a sum and, with
// dropout, a hash on the CUDA cores, which take about as long as its
// tensor-core work (longer with dropout): a kernel that keeps both
// units busy is the target.
//
// float32 inputs (flash_fwd_f32_kernel) are computed at f32 accuracy, as
// the TPU kernels compute them under the default "highest" matmul
// precision (`_mxu_dtype` keeps f32 operands, :63-73), where the MXU runs
// an f32 product as several bf16 passes. The card's counterpart is the
// error-compensated 3xTF32 split (CUTLASS's OpMultiplyAddFastF32): each
// f32 operand x becomes big = tf32(x) and small = tf32(x - big), both
// rounded to nearest, ties away (what cvt.rna.tf32.f32 gives, done as an
// integer add and an and), and a b is summed from small_a big_b + big_a
// small_b + big_a big_b, the cross terms first, on mma.sync m16n8k8 .tf32
// with f32 accumulation: about 2^-21 of each product, the order of f32
// rounding, for three tensor-core products an f32 product. Plain TF32, or
// raw f32 registers fed to a tf32 product (which truncates them), would
// keep 10 mantissa bits and is not used. The design is the bf16 kernel's
// below, in f32:
//   - one block per (b, h, 64-row query tile), 4 warps of 16 rows, the
//     bottom tiles first; causal key tiles no row of the block sees are
//     never loaded;
//   - Q, K and V tiles arrive by 16-byte cp.async in rows of D + 4
//     floats, K and V (and the key tile's bias) double-buffered in
//     32-key tiles. Every fragment load is then free of bank conflicts
//     with no transposed copy: Q's A fragment reads Q[g][t] and K's B
//     fragment for Q K^T reads K[g][t] (g = lane / 4, t = lane % 4), rows
//     4 banks apart; V's B fragment for P V reads rows 2t and 2t + 1
//     (below), 8 banks apart;
//   - the split happens in registers as each fragment is loaded, Q's
//     anew at every key tile: held for the sweep, its big and small
//     fragments would take D registers a thread;
//   - P feeds P V as an A fragment with no shuffle and no shared-memory
//     round trip: the m16n8k8 accumulator gives lane (g, t) keys 2t, 2t + 1
//     of an 8-key chunk, and the tf32 A fragment wants its k indices t and
//     t + 4, so the product's k index i stands for key 2 (i % 4) + i / 4
//     and V's B fragment reads keys 2t and 2t + 1: the same sum in another
//     order. Dropout's keep scales pv after p is formed, before the split;
//   - the online softmax is the bf16 kernel's (exp2 with log2(e) folded
//     into one FMA, the shift-0 guard, l summed from the unsplit p), and
//     o = acc / l is stored from the fragments in 8-byte pieces.
// Measured on an H100 80GB HBM3 at 700 W (tools/time_torch_flash_f32.py,
// PERF.md section 6), at BERT-base's padded batch (B=48, S=512, H=12, D=64):
// 32-key tiles at 4 blocks an SM (122-126 registers, 52 KB) took 0.78 ms;
// 64-key tiles at 2 blocks an SM 0.81-0.83, whether Q's fragments were
// held in registers (228 registers) or not, and splitting K and V once a
// block in shared memory instead of once a warp gained nothing;
// cvt.rna.tf32.f32, which ptxas expands into compares and selects,
// 0.95-0.99. mma.sync m16n8k8 tf32 alone sustains 279-324 TFLOP/s there,
// so 3xTF32 on it cannot pass 0.34 ms; a build that drops one of the
// three products (wrong) took 0.62: the tensor-core instruction is most
// of the time. One launch, no atomics: every call
// gives the same bits. It is the path of the f32 serving prefill and the
// f32 and int8 predictors. wgmma takes tf32 operands only K-major, and V
// is D-major, so it would need a transposed V: a later redesign.
//
// bfloat16 inputs (flash_fwd_tc_kernel) run both products on the tensor
// cores, as the TPU kernels run theirs on the MXU: `_dot` (:115) casts
// both operands to `_mxu_dtype` (bf16 under the default precision
// policy) and sums in f32, so q.k takes bf16 q and k and p.V takes pv = p
// * keep rounded to bf16 (:144, :164, :313, :333); l sums the unrounded
// f32 p. FlashAttention-2's forward, from the building blocks the bf16
// backward uses (mma_bf16.cuh):
//   - one block per (b, h, 64-row query tile), 4 warps of 16 rows;
//     causal grids start with the bottom (heaviest) tiles, which keeps
//     the grid's tail short. At D = 64 __launch_bounds__ asks for 4
//     blocks an SM (16 warps, so at most 128 registers a thread; ptxas:
//     128, no spills without the bias, 20 bytes spilled with it); at
//     D = 128 the compiler chooses (227 and 238 registers, no spills),
//     as a cap of 3 or 4 blocks there spilled 44 to 620 bytes. Measured on an H100 80GB
//     HBM3 at 700 W with dropout 0.1 (PERF.md, PR 7): 8 warps a block
//     took 9.3% longer at GPT-2 345M's causal training shape and 5.9%
//     longer at BERT-base's padded batch; without the D = 64 cap the
//     BERT shape took 0.3183 ms against 0.2997;
//   - Q arrives once by 16-byte cp.async into rows of D + 8 bf16 and
//     goes by ldmatrix into A fragments that stay in registers for the
//     whole sweep;
//   - K, V (and the key tile's 64 bias floats) are double-buffered: the
//     next key tile's cp.async copies overlap this tile's math
//     (commit_group / wait_group 1);
//   - S = Q K^T with mma.sync m16n8k16 (K by ldmatrix), O += Pv V with V
//     by ldmatrix.trans, Pv being the S accumulator fragments rounded to
//     bf16 and repacked as A fragments, with no shared-memory round trip;
//   - the online softmax runs on the accumulator fragments in registers:
//     row max and the causal / sequence-edge mask (to -1e30, only on
//     tiles that cross the diagonal or an edge) in natural units,
//     p = exp(x - shift) as exp2 with log2(e) folded into one FMA, the
//     row's four lanes reduced by quad shuffles, the per-lane share of l
//     reduced once at the end; causal tiles that no row of the block sees
//     are never loaded; dropout is attention_keep's hash with each row's
//     term computed once, and scales only pv;
//   - the epilogue divides by l, rounds o to bf16 and stages it in the
//     warp's own Q rows, then stores it in 16-byte pieces.
// wgmma, TMA and warp specialisation are a later redesign.
//
// Plain C interface, bound from Python with ctypes; returns
// cudaGetLastError() after the launch. Both paths copy rows in 16-byte
// pieces, so q, k, v and o must be 16-byte aligned (the wrappers check
// it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr float NEG_INF = -1e30f; // the TPU kernel's mask value

// ---------------------------------------------------------------------------
// the bf16 path on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_MIN_BLOCKS_64 = 4;  // blocks an SM at D = 64
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_BQ = 16 * TC_WARPS;  // query rows a block
constexpr int TC_BK = 64;             // key rows a tile
constexpr float LOG2E = 1.4426950408889634f;

// 2^x; ftz: a p below 2^-126 counts as 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, bool BIAS>
constexpr int fwd_tc_smem_bytes() {
  // the Q tile and two stages of the K and V tiles, all bf16; then two
  // stages of the key tile's bias
  return (TC_BQ + 2 * 2 * TC_BK) * tc_ld<D>() * 2 + (BIAS ? 2 * TC_BK * 4 : 0);
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(TC_THREADS, D == 64 ? TC_MIN_BLOCKS_64 : 1)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ bias, bf16* __restrict__ o,
                        float* __restrict__ lse, int Sq, int Sk, int H,
                        int causal, float scale, int dropout, uint32_t thr,
                        uint32_t seed, float keep_scale) {
  constexpr int LD = tc_ld<D>();
  constexpr int NK = TC_BK / 8;  // n8 tiles across a key tile
  constexpr int ND = D / 8;      // n8 tiles across D
  constexpr int KD = D / 16;     // k16 steps across D
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* stages = Qs + TC_BQ * LD;  // stage s: K, V at stages + s * 2 BK LD
  float* bias_st = reinterpret_cast<float*>(stages + 2 * 2 * TC_BK * LD);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // the bottom query tiles, which see the most keys under a causal mask,
  // start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long ld_row = (long long)H * D;
  const long long qoff = ((long long)b * Sq * H + h) * D;
  const long long koff = ((long long)b * Sk * H + h) * D;
  const int off = Sk - Sq;
  const int w0 = q0 + warp * 16;  // the warp's rows: w0 .. w0 + 15
  const int qr = w0 + g;          // this thread's rows: qr, qr + 8

  auto prefetch = [&](int tk, int s) {
    bf16* st = stages + s * 2 * TC_BK * LD;
    const int k0 = tk * TC_BK;
    tile_async<TC_BK, D, TC_THREADS>(st, k + koff, k0, Sk, ld_row);
    tile_async<TC_BK, D, TC_THREADS>(st + TC_BK * LD, v + koff, k0, Sk,
                                     ld_row);
    if (BIAS)
      vec_async<TC_BK, TC_THREADS>(bias_st + s * TC_BK,
                                   bias + (long long)b * Sk, k0, Sk);
  };

  // the last key column any row of this tile may see: causal tiles
  // wholly above the diagonal are skipped, loads included
  int last_col = Sk - 1;
  if (causal) last_col = min(last_col, min(q0 + TC_BQ, Sq) - 1 + off);
  const int n_k = last_col < 0 ? 0 : last_col / TC_BK + 1;
  tile_async<TC_BQ, D, TC_THREADS>(Qs, q + qoff, q0, Sq, ld_row);
  if (n_k > 0) prefetch(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the warp's 16 Q rows as A fragments, for the whole sweep
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qa[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                        (lane >> 4) * 8);

  // the dropout hash's row terms: attention_keep(row, col, bh, seed, thr)
  // is fmix32(row_h ^ col * 0x85EBCA6B) >= thr
  const uint32_t bh = (uint32_t)b * 0xAC564B05u + (uint32_t)h * 19349663u;
  uint32_t row_h[2];
  float m_r[2], shl_r[2], l_r[2];  // running max, its exp2 shift, lane's l
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row_h[rr] = (uint32_t)(qr + 8 * rr) * 0x9E3779B1u ^ bh ^ seed;
    m_r[rr] = NEG_INF;
    shl_r[rr] = 0.f;
    l_r[rr] = 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int tk = 0; tk < n_k; ++tk) {
    const int s = tk & 1;
    __syncthreads();  // the stage refilled next was read last iteration
    if (tk + 1 < n_k) prefetch(tk + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Ks = stages + s * 2 * TC_BK * LD;
    const bf16* Vs = Ks + TC_BK * LD;
    const float* bias_s = bias_st + s * TC_BK;

    // S = Q K^T over this warp's 16 rows; element (j, e) is row
    // qr + 8 (e / 2), key k0 + 8 j + 2 t + e % 2
    float sc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, Ks + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[j], qa[kk], kb[0], kb[1]);
        mma_bf16(sc[j + 1], qa[kk], kb[2], kb[3]);
      }

    // scale, bias, then the mask, in natural units; only a tile that
    // crosses the sequence edge or this warp's diagonal is masked
    const int k0 = tk * TC_BK;
    const bool edge =
        k0 + TC_BK > Sk || (causal && w0 + off < k0 + TC_BK - 1);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        float x = sc[j][e] * scale;
        if (BIAS) x += bias_s[c];
        if (edge) {
          const int row = qr + 8 * (e >> 1), key = k0 + c;
          if (key >= Sk || (causal && row + off < key)) x = NEG_INF;
        }
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m_r[rr], mx[rr]);
      // a row with nothing visible yet keeps shift 0, so masked columns
      // give exactly 0 and never NaN (the TPU kernel's guard)
      const float shl = (m_new == NEG_INF ? 0.f : m_new) * LOG2E;
      // exp(m_prev - shift), in the same exp2 units as p; 0 while nothing
      // was visible (l and acc are 0 then)
      alpha[rr] = m_r[rr] == NEG_INF ? 0.f : ex2(shl_r[rr] - shl);
      m_r[rr] = m_new;
      shl_r[rr] = shl;
      l_r[rr] *= alpha[rr];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // p = exp(x - shift) = 2^(x log2(e) - shift log2(e)); l sums the
    // unrounded p
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(sc[j][e], LOG2E, -shl_r[e >> 1]));
        l_r[e >> 1] += p;
        sc[j][e] = p;
      }
    // dropout scales what reaches p.V; l above kept the undropped p
    if (dropout) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t col = k0 + j * 8 + 2 * t + (e & 1);
          sc[j][e] *= fmix32(row_h[e >> 1] ^ col * 0x85EBCA6Bu) >= thr
                          ? keep_scale
                          : 0.f;
        }
    }

    // O += Pv V: Pv rounded to bf16 in the fragments, V transposed
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t pa[4];
      frag_a(pa, sc, kk);
#pragma unroll
      for (int jd = 0; jd < ND; jd += 2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              LD + jd * 8 + (lane >> 4) * 8);
        mma_bf16(acc[jd], pa, vb[0], vb[1]);
        mma_bf16(acc[jd + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

  // o = acc / l in bf16, staged in the warp's own Q rows (no other warp
  // reads them), then stored in 16-byte pieces
  bf16* Os = Qs + warp * 16 * LD;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_r[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float safe_l = l == 0.f ? 1.f : l;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      *reinterpret_cast<uint32_t*>(Os + (g + 8 * rr) * LD + jd * 8 + 2 * t) =
          pack_bf16(acc[jd][2 * rr] / safe_l, acc[jd][2 * rr + 1] / safe_l);
    const int row = qr + 8 * rr;
    if (lse != nullptr && t == 0 && row < Sq)
      lse[((long long)b * H + h) * Sq + row] =
          l == 0.f ? NEG_INF : m_r[rr] + logf(safe_l);
  }
  __syncwarp();
  constexpr int CH = D / 8;  // 16-byte pieces a row
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    if (w0 + r < Sq)
      *reinterpret_cast<uint4*>(o + qoff + (w0 + r) * ld_row + c * 8) =
          *reinterpret_cast<const uint4*>(Os + r * LD + c * 8);
  }
}

template <int D, bool BIAS>
int launch_tc(const void* q, const void* k, const void* v, const void* bias,
              void* o, void* lse, int B, int Sq, int Sk, int H, int causal,
              float scale, int dropout, uint32_t thr, uint32_t seed,
              float keep_scale, cudaStream_t stream) {
  constexpr int bytes = fwd_tc_smem_bytes<D, BIAS>();
  cudaFuncSetAttribute(flash_fwd_tc_kernel<D, BIAS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid((Sq + TC_BQ - 1) / TC_BQ, H, B);
  flash_fwd_tc_kernel<D, BIAS><<<grid, TC_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Sk, H, causal,
      scale, dropout, thr, seed, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the f32 path on the tensor cores, by the 3xTF32 split
// ---------------------------------------------------------------------------

constexpr int F32_MIN_BLOCKS_64 = 4;  // blocks an SM at D = 64
constexpr int F32_BK = 32;            // key rows a tile

template <int D>
__host__ __device__ constexpr int f32_ld() {
  return D + 4;  // floats a shared-memory row (tile_async's padding)
}

template <int D, bool BIAS>
constexpr int fwd_f32_smem_bytes() {
  // Q's tile, two stages of the K and V tiles, then two stages of the
  // key tile's bias
  return (TC_BQ + 2 * 2 * F32_BK) * f32_ld<D>() * 4 +
         (BIAS ? 2 * F32_BK * 4 : 0);
}

// x rounded to the nearest tf32, ties away from zero, as a b32 register
// whose low 13 mantissa bits are 0: what cvt.rna.tf32.f32 gives for every
// finite x (adding half a tf32 ulp to the magnitude's bits carries into
// the kept bits exactly when the dropped ones are at least half), in an
// integer add and an and at full rate where the conversion is slower
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to about 2^-22 of x, both tf32; x - big is exact in f32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// c += a b, a 16x8 tf32 (row), b 8x8 tf32 (col), c 16x8 f32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b at f32 accuracy from the split operands: the two cross terms,
// then big . big (small . small, about 2^-22 of the product, is dropped)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(c, a_small, b_big[0], b_big[1]);
  mma_tf32(c, a_big, b_small[0], b_small[1]);
  mma_tf32(c, a_big, b_big[0], b_big[1]);
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(TC_THREADS,
                                  D == 64 ? F32_MIN_BLOCKS_64 : 1)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         float* __restrict__ o, float* __restrict__ lse,
                         int Sq, int Sk, int H, int causal, float scale,
                         int dropout, uint32_t thr, uint32_t seed,
                         float keep_scale) {
  constexpr int LD = f32_ld<D>();
  constexpr int BK = F32_BK;
  constexpr int NK = BK / 8;  // n8 tiles across a key tile (Q K^T)
  constexpr int ND = D / 8;   // k8 steps across D (Q K^T), n8 tiles (P V)
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* stages = Qs + TC_BQ * LD;  // stage s: K, V at stages + s * 2 BK LD
  float* bias_st = stages + 4 * BK * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // the bottom query tiles, which see the most keys under a causal mask,
  // start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long ld_row = (long long)H * D;
  const long long qoff = ((long long)b * Sq * H + h) * D;
  const long long koff = ((long long)b * Sk * H + h) * D;
  const int off = Sk - Sq;
  const int w0 = q0 + warp * 16;  // the warp's rows: w0 .. w0 + 15
  const int qr = w0 + g;          // this thread's rows: qr, qr + 8

  auto prefetch = [&](int tk, int s) {
    float* st = stages + s * 2 * BK * LD;
    const int k0 = tk * BK;
    tile_async<BK, D, TC_THREADS>(st, k + koff, k0, Sk, ld_row);
    tile_async<BK, D, TC_THREADS>(st + BK * LD, v + koff, k0, Sk, ld_row);
    if (BIAS)
      vec_async<BK, TC_THREADS>(bias_st + s * BK, bias + (long long)b * Sk,
                                k0, Sk);
  };

  // the last key column any row of this tile may see: causal tiles
  // wholly above the diagonal are skipped, loads included
  int last_col = Sk - 1;
  if (causal) last_col = min(last_col, min(q0 + TC_BQ, Sq) - 1 + off);
  const int n_k = last_col < 0 ? 0 : last_col / BK + 1;
  tile_async<TC_BQ, D, TC_THREADS>(Qs, q + qoff, q0, Sq, ld_row);
  if (n_k > 0) prefetch(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q's A fragment for d = 8 kk .. 8 kk + 7, split anew at every key tile
  // (held for the sweep, big and small, it would take D registers): (row,
  // d) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of the warp's rows
  const float* Qw = Qs + warp * 16 * LD;
  auto q_frag = [&](int kk, uint32_t(&big)[4], uint32_t(&small)[4]) {
    const float* p = Qw + g * LD + kk * 8 + t;
    split(p[0], big[0], small[0]);
    split(p[8 * LD], big[1], small[1]);
    split(p[4], big[2], small[2]);
    split(p[8 * LD + 4], big[3], small[3]);
  };

  // the dropout hash's row terms: attention_keep(row, col, bh, seed, thr)
  // is fmix32(row_h ^ col * 0x85EBCA6B) >= thr
  const uint32_t bh = (uint32_t)b * 0xAC564B05u + (uint32_t)h * 19349663u;
  uint32_t row_h[2];
  float m_r[2], shl_r[2], l_r[2];  // running max, its exp2 shift, lane's l
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row_h[rr] = (uint32_t)(qr + 8 * rr) * 0x9E3779B1u ^ bh ^ seed;
    m_r[rr] = NEG_INF;
    shl_r[rr] = 0.f;
    l_r[rr] = 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int tk = 0; tk < n_k; ++tk) {
    const int s = tk & 1;
    __syncthreads();  // the stage refilled next was read last iteration
    if (tk + 1 < n_k) prefetch(tk + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Ks = stages + s * 2 * BK * LD;
    const float* Vs = Ks + BK * LD;
    const float* bias_s = bias_st + s * BK;

    // S = Q K^T over this warp's 16 rows; element (j, e) is row
    // qr + 8 (e / 2), key k0 + 8 j + 2 t + e % 2. K's B fragment for keys
    // 8 j .. 8 j + 7: (d, key) = (t, g) and (t + 4, g)
    float sc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t a_big[4], a_small[4];
      q_frag(kk, a_big, a_small);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float* p = Ks + (j * 8 + g) * LD + kk * 8 + t;
        uint32_t kb[2], ks[2];
        split(p[0], kb[0], ks[0]);
        split(p[4], kb[1], ks[1]);
        mma_3xtf32(sc[j], a_big, a_small, kb, ks);
      }
    }

    // scale, bias, then the mask, in natural units; only a tile that
    // crosses the sequence edge or this warp's diagonal is masked
    const int k0 = tk * BK;
    const bool edge = k0 + BK > Sk || (causal && w0 + off < k0 + BK - 1);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        float x = sc[j][e] * scale;
        if (BIAS) x += bias_s[c];
        if (edge) {
          const int row = qr + 8 * (e >> 1), key = k0 + c;
          if (key >= Sk || (causal && row + off < key)) x = NEG_INF;
        }
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m_r[rr], mx[rr]);
      // a row with nothing visible yet keeps shift 0, so masked columns
      // give exactly 0 and never NaN (the TPU kernel's guard)
      const float shl = (m_new == NEG_INF ? 0.f : m_new) * LOG2E;
      // exp(m_prev - shift) in the same exp2 units as p; 0 while nothing
      // was visible (l and acc are 0 then)
      alpha[rr] = m_r[rr] == NEG_INF ? 0.f : ex2(shl_r[rr] - shl);
      m_r[rr] = m_new;
      shl_r[rr] = shl;
      l_r[rr] *= alpha[rr];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // p = exp(x - shift) = 2^(x log2(e) - shift log2(e)); l sums p
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(sc[j][e], LOG2E, -shl_r[e >> 1]));
        l_r[e >> 1] += p;
        sc[j][e] = p;
      }
    // dropout scales what reaches p.V; l above kept the undropped p
    if (dropout) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t col = k0 + j * 8 + 2 * t + (e & 1);
          sc[j][e] *= fmix32(row_h[e >> 1] ^ col * 0x85EBCA6Bu) >= thr
                          ? keep_scale
                          : 0.f;
        }
    }

    // O += Pv V over keys 8 kk .. 8 kk + 7. The product's k index i stands
    // for key 8 kk + 2 (i % 4) + i / 4, so lane (g, t)'s accumulator
    // elements (keys 2t, 2t + 1 of rows g, g + 8) are its A fragment's
    // (row, i) = (g, t), (g, t + 4), (g + 8, t), (g + 8, t + 4) as they
    // stand, and V's B fragment (i, d) = (t, g), (t + 4, g) reads keys
    // 8 kk + 2t and 8 kk + 2t + 1
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t pb[4], ps[4];
      split(sc[kk][0], pb[0], ps[0]);
      split(sc[kk][2], pb[1], ps[1]);
      split(sc[kk][1], pb[2], ps[2]);
      split(sc[kk][3], pb[3], ps[3]);
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        const float* p = Vs + (kk * 8 + 2 * t) * LD + jd * 8 + g;
        uint32_t vb[2], vs[2];
        split(p[0], vb[0], vs[0]);
        split(p[LD], vb[1], vs[1]);
        mma_3xtf32(acc[jd], pb, ps, vb, vs);
      }
    }
  }
  cp_async_wait<0>();

  // o = acc / l, stored from the fragments: a quad writes 32 contiguous
  // bytes of a row
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_r[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float safe_l = l == 0.f ? 1.f : l;
    const int row = qr + 8 * rr;
    if (row >= Sq) continue;
    float* orow = o + qoff + row * ld_row;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      *reinterpret_cast<float2*>(orow + jd * 8 + 2 * t) = make_float2(
          acc[jd][2 * rr] / safe_l, acc[jd][2 * rr + 1] / safe_l);
    if (lse != nullptr && t == 0)
      lse[((long long)b * H + h) * Sq + row] =
          l == 0.f ? NEG_INF : m_r[rr] + logf(safe_l);
  }
}

template <int D, bool BIAS>
int launch_f32(const void* q, const void* k, const void* v, const void* bias,
               void* o, void* lse, int B, int Sq, int Sk, int H, int causal,
               float scale, int dropout, uint32_t thr, uint32_t seed,
               float keep_scale, cudaStream_t stream) {
  constexpr int bytes = fwd_f32_smem_bytes<D, BIAS>();
  cudaFuncSetAttribute(flash_fwd_f32_kernel<D, BIAS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid((Sq + TC_BQ - 1) / TC_BQ, H, B);
  flash_fwd_f32_kernel<D, BIAS><<<grid, TC_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(lse), Sq, Sk, H, causal,
      scale, dropout, thr, seed, keep_scale);
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
  if (dtype == 0 && D == 64) return launch_f32<64, BIAS>(FLASH_FWD_ARGS);
  if (dtype == 0 && D == 128) return launch_f32<128, BIAS>(FLASH_FWD_ARGS);
  if (dtype == 1 && D == 64) return launch_tc<64, BIAS>(FLASH_FWD_ARGS);
  if (dtype == 1 && D == 128) return launch_tc<128, BIAS>(FLASH_FWD_ARGS);
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
