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
//   2. dkv_tc_kernel (bf16) or dkv_f32_kernel (f32): one block per (b, h,
//      64-key tile) keeps its K and V tiles and its dk/dv (and per-head
//      dbias) accumulators, and sweeps the query tiles that can see those
//      keys, each key tile's in one order;
//   3. dq_tc_kernel or dq_f32_kernel: one block per (b, h, 64-query tile)
//      keeps its Q and dO tiles and its dq accumulator, and sweeps the
//      visible key tiles in one order;
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
// float32 inputs (variants 0, 1; dkv_f32_kernel, dq_f32_kernel) are
// computed at f32 accuracy, as the TPU kernels compute them under the
// default "highest" matmul precision (`_mxu_dtype` keeps f32 operands,
// :63-73). All five products (s, dp, dv += pv^T dO, dk += ds^T q, dq +=
// ds k) run on mma.sync m16n8k8 .tf32 by the error-compensated 3xTF32
// split of mma_tf32.cuh, the f32 forward's: both operands split into big
// = tf32(x) and small = tf32(x - big), the cross terms summed before
// big . big. Plain TF32, or raw f32 registers fed to a tf32 product,
// would keep 10 mantissa bits and is not used. The layout is the bf16
// kernels' below, in f32:
//   - tiles arrive by 16-byte cp.async in rows of D + 4 floats, the swept
//     operand double-buffered (Q and dO in dkv, 32-query tiles, 16 at
//     D = 128, where the dK and dV accumulators take 128 floats a thread;
//     K and V in dq, 32-key tiles);
//   - every fragment is read straight from those rows with no bank
//     conflict and no transposed copy: A fragments, and B fragments of a
//     tile used transposed (Q^T, dO^T, K^T, V^T), read banks 4g + t (g =
//     lane / 4, t = lane % 4); pv and ds feed dV, dK and dQ as A
//     fragments in the accumulator's own layout (the product's k index i
//     stands for query or key 2 (i % 4) + i / 4, the forward's P.V trick),
//     so their B operand reads rows 2t and 2t + 1 of dO, Q or K, banks
//     8t + g, with no shared-memory round trip;
//   - the split: K's and V's (dkv), Q's and dO's (dq) A fragments anew at
//     every swept tile, the accumulator fragments as they feed the next
//     product, and the B fragments of the swept tile in dkv once a block
//     at D = 64 (split_tile: the big halves in place, the small ones in a
//     tile of their own), in dq as each warp loads them;
//   - dK, dV and dQ sum each swept tile's products from zero on the
//     tensor cores and add them to their running sums on the CUDA cores,
//     rounded to nearest (add_tile): the tensor cores' f32 accumulation
//     truncates, and a sum kept there over a whole sweep drifts;
//   - causal grids run tile-major, every head's heaviest tile first (dkv's
//     first key tiles, dq's last query tiles): a grid of a wave or two
//     then ends on light tiles instead of a few heavy ones;
//   - pv, ds, dsr, the masks, dropout and dbias as the bf16 kernels form
//     them, from f32 fragments.
// What bounds it: the tensor-core instruction. mma.sync m16n8k8 tf32
// sustains 279-324 TFLOP/s on the card (tools/time_torch_flash_f32.py),
// and the split runs seven products a visible pair, 14 D operations, as
// three of them: at a dp = 2 x mp = 2 rank's causal training shape (B=2,
// S=1024, H=8, D=64, dropout 0.1) 7.5 GFLOP, a floor of 0.07-0.08 ms.
// Measured on an H100 80GB HBM3 at 700 W (tools/time_flash_bwd.py
// --dtype float32 --shape rank,bert; PERF.md section 6): there the
// no-bias entry took 0.2732-0.2753 ms (dkv 144.4 us, dq 119.4, delta
// 4.2) against the CUDA-core design's 0.7393-0.7486; at BERT-base's
// padded batch (B=48, S=512, H=12, D=64, dropout 0.1) dq took
// 1.2029-1.2133 ms and dk/dv/db 1.7416-1.7699 against 2.6398-2.6423 and
// 3.6119-3.6237. What moved it, at the rank's shape: the tile-major
// causal grid, 0.3437 -> 0.3062 ms; 32-query dkv tiles against 64,
// 0.2929; the split once a block in dkv, dkv 165.3 -> 145.8 us (1.7876
// -> 1.7200 ms at BERT's batch). What did not: the split once a block in
// dq (1.1979 -> 1.2744 ms at BERT's batch, 3 blocks an SM down to 2), and
// dq holding Q's and dO's split A fragments in registers for the sweep
// (1.2021 -> 1.2538 ms at 2 blocks an SM, 1.7314 at 3 with spills). The
// tile sums cost 1% at the rank's shape (0.2705 -> 0.2732 ms) and 2-4% of
// dk/dv/db at BERT's batch. The bias and D = 128 kernels take the same
// templates; at D = 128 the kernels are checked, not tuned.
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
#include "mma_tf32.cuh"

namespace {

constexpr int THREADS = 256;      // delta_kernel's and db_sum_kernel's block
constexpr int TC_THREADS = 128;   // 4 warps, 16 rows each
constexpr int TC_ROWS = 64;       // rows a block owns
constexpr float NEG_INF = -1e30f; // the TPU kernel's mask value

// elements a shared-memory row of a [rows][D] tile of T: 16 bytes of
// padding (tile_async's layout; tc_ld<D>() for bf16, D + 4 for f32)
template <typename T, int D>
__host__ __device__ constexpr int row_ld() {
  return D + 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// the dot product of two 16-byte chunks of bf16 or f32 (the pointer's
// type picks the element)
__device__ __forceinline__ float dot16(uint4 a, uint4 b, const bf16*) {
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
__device__ __forceinline__ float dot16(uint4 a, uint4 b, const float*) {
  const float4 x = *reinterpret_cast<const float4*>(&a);
  const float4 y = *reinterpret_cast<const float4*>(&b);
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}

// delta_s[r] = rowsum(dO * o) of ROWS rows, dO from a shared tile and o
// from a shared tile (os_shared) or from device memory (o_rows at row 0,
// rows at or past n read as zeros)
template <int ROWS, int D, typename T>
__device__ __forceinline__ void tc_delta(float* delta_s, const T* dOs,
                                         const T* os_shared,
                                         const T* o_rows, int r0, int n,
                                         long long ld_row) {
  constexpr int E = 16 / sizeof(T);       // elements a 16-byte chunk
  constexpr int TPR = TC_THREADS / ROWS;  // threads a row, adjacent lanes
  constexpr int PART = D / TPR;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const T* d = dOs + r * row_ld<T, D>() + part * PART;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < PART; i += E) {
    const uint4 dv = *reinterpret_cast<const uint4*>(d + i);
    uint4 ov;
    if (os_shared != nullptr) {
      ov = *reinterpret_cast<const uint4*>(os_shared + r * row_ld<T, D>() +
                                           part * PART + i);
    } else {
      const int row = r0 + r;
      ov = row < n ? *reinterpret_cast<const uint4*>(o_rows + row * ld_row +
                                                     part * PART + i)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    acc += dot16(dv, ov, d);
  }
#pragma unroll
  for (int m = TPR / 2; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (part == 0) delta_s[r] = acc;
}

// ---------------------------------------------------------------------------
// the bf16 path on the tensor cores
// ---------------------------------------------------------------------------

// the swept query tile of dkv_tc_kernel
template <int D>
__host__ __device__ constexpr int dkv_qt() {
  return D == 128 ? 32 : 64;
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
      tc_delta<QT, D, bf16>(delta_s, dOs, dOs + QT * LD, nullptr, 0, 0,
                            0);
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
    tc_delta<TC_ROWS, D, bf16>(delta_s, dOs, nullptr, o + qoff, q0, Sq,
                               ld_row);
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

// ---------------------------------------------------------------------------
// the f32 path on the tensor cores, by the 3xTF32 split
// ---------------------------------------------------------------------------

constexpr int F32_DQ_KT = 32;  // dq_f32_kernel's key tile
// blocks an SM that __launch_bounds__ asks for at D = 64
constexpr int F32_DKV_MIN_BLOCKS_64 = 2;
constexpr int F32_DQ_MIN_BLOCKS_64 = 3;

// the swept query tile of dkv_f32_kernel: at D = 128 the dK and dV
// accumulators take 128 floats a thread
template <int D>
__host__ __device__ constexpr int dkv_f32_qt() {
  return D == 128 ? 16 : 32;
}

// The f32 grids: (row tile, head, batch row) as dim3(tiles, H, B), or
// under a causal mask tile-major, dim3(H, B, tiles), so that blocks start
// in order of falling work (dkv's first key tiles and dq's last query
// tiles see the most of the other side), every head's heaviest tile
// first: a grid of one or two waves then ends with its light tiles
// instead of waiting on a few heavy ones
dim3 f32_grid(int tiles, int H, int B, int causal) {
  return causal ? dim3(H, B, tiles) : dim3(tiles, H, B);
}

// this block's (tile, h, b) of f32_grid, tiles in launch order
struct GridPos {
  int tile, h, b;
};
__device__ __forceinline__ GridPos grid_pos(int causal) {
  if (causal) return {(int)blockIdx.z, (int)blockIdx.x, (int)blockIdx.y};
  return {(int)blockIdx.x, (int)blockIdx.y, (int)blockIdx.z};
}

// The split tf32 fragments of mma.sync m16n8k8 (g = lane / 4, t = lane %
// 4), read from f32 tiles in rows of LD = D + 4 floats.
//
// A, rows r .. r + 15 and columns c .. c + 7 of a tile from p = &tile[r][c]:
// (row, k) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); the reads
// fall in banks 4g + t, free of conflicts
template <int LD>
__device__ __forceinline__ void a_frag(const float* p, int g, int t,
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  p += g * LD + t;
  split(p[0], big[0], small[0]);
  split(p[8 * LD], big[1], small[1]);
  split(p[4], big[2], small[2]);
  split(p[8 * LD + 4], big[3], small[3]);
}

// the swept tile's ROWS rows split once a block, in place: the big
// halves over the f32 values, the small ones at the same offsets in
// `small`
template <int ROWS, int D>
__device__ __forceinline__ void split_tile(float* tile, float* small) {
  constexpr int LD = row_ld<float, D>();
  constexpr int CH = D / 4;  // 16-byte chunks a row
  static_assert(ROWS * CH % TC_THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / TC_THREADS; ++it) {
    const int i = threadIdx.x + it * TC_THREADS;
    const int o = i / CH * LD + i % CH * 4;
    float4 x = *reinterpret_cast<float4*>(tile + o), y;
    uint32_t b, sm;
    split(x.x, b, sm), x.x = __uint_as_float(b), y.x = __uint_as_float(sm);
    split(x.y, b, sm), x.y = __uint_as_float(b), y.y = __uint_as_float(sm);
    split(x.z, b, sm), x.z = __uint_as_float(b), y.z = __uint_as_float(sm);
    split(x.w, b, sm), x.w = __uint_as_float(b), y.w = __uint_as_float(sm);
    *reinterpret_cast<float4*>(tile + o) = x;
    *reinterpret_cast<float4*>(small + o) = y;
  }
}

// element i of a B fragment from p: split here, or (PS) read from a tile
// split_tile split, its small half `off` floats on
template <bool PS>
__device__ __forceinline__ void b_elem(const float* p, int i, long off,
                                       uint32_t& big, uint32_t& small) {
  if (PS) {
    big = __float_as_uint(p[i]);
    small = __float_as_uint(p[i + off]);
  } else {
    split(p[i], big, small);
  }
}

// B of X^T, k down the columns c .. c + 7 and n across rows r .. r + 7
// of X from p = &X[r][c]: (k, n) = (t, g), (t + 4, g); banks 4g + t
template <int LD, bool PS>
__device__ __forceinline__ void bt_frag(const float* p, long off, int g,
                                        int t, uint32_t (&big)[2],
                                        uint32_t (&small)[2]) {
  p += g * LD + t;
  b_elem<PS>(p, 0, off, big[0], small[0]);
  b_elem<PS>(p, 4, off, big[1], small[1]);
}

// B of X, k down rows r .. r + 7 and n across columns c .. c + 7 from p =
// &X[r][c], the k index i standing for row r + 2 (i % 4) + i / 4 (see
// acc_frag): (k, n) = (t, g), (t + 4, g) read rows 2t and 2t + 1; banks
// 8t + g
template <int LD, bool PS>
__device__ __forceinline__ void b_frag(const float* p, long off, int g,
                                       int t, uint32_t (&big)[2],
                                       uint32_t (&small)[2]) {
  p += 2 * t * LD + g;
  b_elem<PS>(p, 0, off, big[0], small[0]);
  b_elem<PS>(p, LD, off, big[1], small[1]);
}

// an m16n8 accumulator fragment as the A operand of the next product:
// lane (g, t) holds columns 2t and 2t + 1 of rows g and g + 8, and the A
// fragment wants k indices t and t + 4, so k index i stands for column
// 2 (i % 4) + i / 4: (row, k) = (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4) are c[0], c[2], c[1], c[3] as they stand
__device__ __forceinline__ void acc_frag(const float (&c)[4],
                                         uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  split(c[0], big[0], small[0]);
  split(c[2], big[1], small[1]);
  split(c[1], big[2], small[2]);
  split(c[3], big[3], small[3]);
}

// acc += t, a swept tile's products summed from zero on the tensor cores,
// rounded to nearest on the CUDA cores. The tensor cores' f32 accumulation
// truncates: a sum kept there over a whole sweep (hundreds of adds) drifts
// toward zero by up to an ulp an add. At a dp = 2 x mp = 2 rank's shape
// that read 1.279e-05 and 1.446e-05 of the largest dk and dv against the
// plain version (the CUDA-core design 5.450e-07, 3.484e-07); summed a tile
// at a time 2.325e-06 and 2.613e-06, for 1% more time (H100 80GB HBM3 at
// 700 W; tools/emulate_tf32_accumulation.py models both)
__device__ __forceinline__ void add_tile(float (&acc)[4], const float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

template <int D, bool BIAS>
constexpr int dkv_f32_smem_bytes() {
  // K and V tiles, then two stages of the swept Q, dO (and o) tiles, all
  // f32; then two stages of lse and delta; then at D = 64 the small halves
  // of the split Q and dO tiles
  return (2 * TC_ROWS + 2 * (BIAS ? 3 : 2) * dkv_f32_qt<D>() +
          (D == 64 ? 2 * dkv_f32_qt<D>() : 0)) *
             row_ld<float, D>() * 4 +
         2 * 2 * dkv_f32_qt<D>() * 4;
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(TC_THREADS,
                                  D == 64 ? F32_DKV_MIN_BLOCKS_64 : 1)
    dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ bias,
                   const float* __restrict__ o,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const float* __restrict__ dout, float* __restrict__ dk,
                   float* __restrict__ dv, float* __restrict__ db_h, int Sq,
                   int Sk, int H, int causal, float scale, Dropout drop) {
  constexpr int QT = dkv_f32_qt<D>();
  constexpr int LD = row_ld<float, D>();
  constexpr int NQ = QT / 8;        // n8 tiles (S^T), k8 steps (dV, dK)
  constexpr int ND = D / 8;         // k8 steps (S^T), n8 tiles (dV, dK)
  constexpr int NT = BIAS ? 3 : 2;  // tiles a stage
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + TC_ROWS * LD;
  // at D = 64 each swept Q and dO tile is split once a block (split_tile)
  // and every warp reads its B fragments' halves; at D = 128 the warps
  // split them as they load them, as that took spills there
  constexpr bool PS = D == 64;
  float* stages = Vs + TC_ROWS * LD;  // stage s at stages + s * NT * QT * LD
  float* q_small = stages + 2 * NT * QT * LD;  // PS: the small halves
  float* o_small = q_small + QT * LD;
  float* vecs = q_small + (PS ? 2 * QT * LD : 0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const GridPos pos = grid_pos(causal);  // the first key tiles first
  const int k0 = pos.tile * TC_ROWS;
  const int h = pos.h, b = pos.b;
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
    float* st = stages + s * NT * QT * LD;
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
  const float* Kw = Ks + warp * 16 * LD;  // this warp's 16 keys
  const float* Vw = Vs + warp * 16 * LD;

  for (int tq = first; tq < n_q; ++tq) {
    const int s = (tq - first) & 1;
    __syncthreads();  // the stage refilled next was read last iteration
    if (tq + 1 < n_q) prefetch(tq + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* Qs = stages + s * NT * QT * LD;
    float* dOs = Qs + QT * LD;
    const float* lse_s = vecs + s * 2 * QT;
    float* delta_s = vecs + s * 2 * QT + QT;
    if (BIAS) {
      tc_delta<QT, D, float>(delta_s, dOs, dOs + QT * LD, nullptr, 0, 0, 0);
      __syncthreads();
    }
    if (PS) {
      split_tile<QT, D>(Qs, q_small);
      split_tile<QT, D>(dOs, o_small);
      __syncthreads();
    }
    const long q_off = q_small - Qs, o_off = o_small - dOs;

    // S^T = K Q^T and dP^T = V dO^T over this warp's 16 keys; K's and
    // V's A fragments are split anew at every query tile (held for the
    // sweep, big and small, they would take 2 D registers a thread)
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t kb[4], ks[4], vb[4], vs[4];
      a_frag<LD>(Kw + kk * 8, g, t, kb, ks);
      a_frag<LD>(Vw + kk * 8, g, t, vb, vs);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        uint32_t xb[2], xs[2];
        bt_frag<LD, PS>(Qs + j * 8 * LD + kk * 8, q_off, g, t, xb, xs);
        mma_3xtf32(st[j], kb, ks, xb, xs);
        bt_frag<LD, PS>(dOs + j * 8 * LD + kk * 8, o_off, g, t, xb, xs);
        mma_3xtf32(dpt[j], vb, vs, xb, xs);
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

    // dV += Pv^T dO and dK += dS^T Q, the fragments as A operands: the
    // product's k index i stands for query 8 kk + 2 (i % 4) + i / 4. The
    // tile's products are summed from zero on the tensor cores and added
    // to dV and dK on the CUDA cores (see add_tile)
    uint32_t pb[NQ][4], ps[NQ][4], sb[NQ][4], ss[NQ][4];
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      acc_frag(st[kk], pb[kk], ps[kk]);
      acc_frag(dpt[kk], sb[kk], ss[kk]);
    }
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      float tv[4] = {0.f, 0.f, 0.f, 0.f}, tk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        uint32_t xb[2], xs[2];
        b_frag<LD, PS>(dOs + kk * 8 * LD + jd * 8, o_off, g, t, xb, xs);
        mma_3xtf32(tv, pb[kk], ps[kk], xb, xs);
        b_frag<LD, PS>(Qs + kk * 8 * LD + jd * 8, q_off, g, t, xb, xs);
        mma_3xtf32(tk, sb[kk], ss[kk], xb, xs);
      }
      add_tile(dv_acc[jd], tv);
      add_tile(dk_acc[jd], tk);
    }
  }
  cp_async_wait<0>();

  // a quad writes 32 contiguous bytes of a row
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = k0 + kr + 8 * rr;
    if (key < Sk) {
      float* dkrow = dk + koff + key * ld_row + 2 * t;
      float* dvrow = dv + koff + key * ld_row + 2 * t;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        *reinterpret_cast<float2*>(dkrow + jd * 8) =
            make_float2(dk_acc[jd][2 * rr], dk_acc[jd][2 * rr + 1]);
        *reinterpret_cast<float2*>(dvrow + jd * 8) =
            make_float2(dv_acc[jd][2 * rr], dv_acc[jd][2 * rr + 1]);
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
constexpr int dq_f32_smem_bytes() {
  // Q and dO tiles, two stages of the swept K and V tiles, all f32; then
  // two stages of the key tile's bias and the block's delta
  return (2 * TC_ROWS + 2 * 2 * F32_DQ_KT) * row_ld<float, D>() * 4 +
         (2 * F32_DQ_KT + TC_ROWS) * 4;
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(TC_THREADS,
                                  D == 64 ? F32_DQ_MIN_BLOCKS_64 : 1)
    dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ bias,
                  const float* __restrict__ o,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ dout, float* __restrict__ dq,
                  int Sq, int Sk, int H, int causal, float scale,
                  Dropout drop) {
  constexpr int KT = F32_DQ_KT;  // the swept key tile
  constexpr int LD = row_ld<float, D>();
  constexpr int NK = KT / 8;     // n8 tiles (S, dP), k8 steps (dQ)
  constexpr int ND = D / 8;      // k8 steps (S, dP), n8 tiles (dQ)
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + TC_ROWS * LD;
  float* stages = dOs + TC_ROWS * LD;  // stage s: K, V at stages + s * 2 KT LD
  float* bias_st = stages + 2 * 2 * KT * LD;
  float* delta_s = bias_st + 2 * KT;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // the last query tiles first under a causal mask
  const GridPos pos = grid_pos(causal);
  const int n_tiles = (Sq + TC_ROWS - 1) / TC_ROWS;
  const int q0 = (causal ? n_tiles - 1 - pos.tile : pos.tile) * TC_ROWS;
  const int h = pos.h, b = pos.b;
  drop.bh += (uint32_t)b * 0xAC564B05u + (uint32_t)h * 19349663u;
  const long long ld_row = (long long)H * D;
  const long long qoff = ((long long)b * Sq * H + h) * D;
  const long long koff = ((long long)b * Sk * H + h) * D;
  const float* lse_bh = lse + ((long long)b * H + h) * Sq;
  const int off = Sk - Sq;
  const int qr = warp * 16 + g;  // this thread's query rows: qr, qr + 8

  auto prefetch = [&](int tk, int s) {
    float* st = stages + s * 2 * KT * LD;
    const int k0 = tk * KT;
    tile_async<KT, D, TC_THREADS>(st, k + koff, k0, Sk, ld_row);
    tile_async<KT, D, TC_THREADS>(st + KT * LD, v + koff, k0, Sk, ld_row);
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
    tc_delta<TC_ROWS, D, float>(delta_s, dOs, nullptr, o + qoff, q0, Sq,
                                ld_row);
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) d_r[rr] = delta_s[qr + 8 * rr];
  }

  float dq_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
  const float* Qw = Qs + warp * 16 * LD;  // this warp's 16 query rows
  const float* dOw = dOs + warp * 16 * LD;

  for (int tk = 0; tk < n_k; ++tk) {
    const int s = tk & 1;
    __syncthreads();  // the stage refilled next was read last iteration
    if (tk + 1 < n_k) prefetch(tk + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Ks = stages + s * 2 * KT * LD;
    const float* Vs = Ks + KT * LD;
    const float* bias_s = bias_st + s * KT;

    // S = Q K^T and dP = dO V^T over this warp's 16 query rows; Q's and
    // dO's A fragments are split anew at every key tile
    float sc[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t qb[4], qs[4], ob[4], os[4];
      a_frag<LD>(Qw + kk * 8, g, t, qb, qs);
      a_frag<LD>(dOw + kk * 8, g, t, ob, os);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t xb[2], xs[2];
        bt_frag<LD, false>(Ks + j * 8 * LD + kk * 8, 0, g, t, xb, xs);
        mma_3xtf32(sc[j], qb, qs, xb, xs);
        bt_frag<LD, false>(Vs + j * 8 * LD + kk * 8, 0, g, t, xb, xs);
        mma_3xtf32(dp[j], ob, os, xb, xs);
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

    // dQ += dS K, the fragments as A operands: the product's k index i
    // stands for key 8 kk + 2 (i % 4) + i / 4; the tile's products summed
    // from zero, then added to dQ (add_tile)
    uint32_t sb[NK][4], ss[NK][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) acc_frag(sc[kk], sb[kk], ss[kk]);
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      float tq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t xb[2], xs[2];
        b_frag<LD, false>(Ks + kk * 8 * LD + jd * 8, 0, g, t, xb, xs);
        mma_3xtf32(tq, sb[kk], ss[kk], xb, xs);
      }
      add_tile(dq_acc[jd], tq);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + qr + 8 * rr;
    if (row >= Sq) continue;
    float* dqrow = dq + qoff + row * ld_row + 2 * t;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      *reinterpret_cast<float2*>(dqrow + jd * 8) =
          make_float2(dq_acc[jd][2 * rr], dq_acc[jd][2 * rr + 1]);
  }
}

// sets the kernel's dynamic shared memory, launches it on a block of
// TC_THREADS with the entries' untyped pointers cast to its parameters,
// and returns cudaGetLastError()
template <typename... P, typename... A>
int launch_tc(void (*kernel)(P...), int bytes, dim3 grid, cudaStream_t stream,
              A... args) {
  static_assert(sizeof...(P) == sizeof...(A), "one argument a parameter");
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  kernel<<<grid, TC_THREADS, bytes, stream>>>(static_cast<P>(args)...);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv (and db_h) by dkv_tc_kernel (bf16) or dkv_f32_kernel (f32)
template <typename T, int D, bool BIAS>
int launch_dkv(const void* q, const void* k, const void* v, const void* bias,
               const void* o, const void* lse, const void* delta,
               const void* dout, void* dk, void* dv, void* db_h, int B,
               int Sq, int Sk, int H, int causal, float scale, Dropout drop,
               cudaStream_t stream) {
  const dim3 grid((Sk + TC_ROWS - 1) / TC_ROWS, H, B);
#define DKV_ARGS \
  q, k, v, bias, o, lse, delta, dout, dk, dv, db_h, Sq, Sk, H, causal, \
      scale, drop
  if constexpr (std::is_same<T, bf16>::value)
    return launch_tc(dkv_tc_kernel<D, BIAS>, dkv_tc_smem_bytes<D, BIAS>(),
                     grid, stream, DKV_ARGS);
  else
    return launch_tc(dkv_f32_kernel<D, BIAS>, dkv_f32_smem_bytes<D, BIAS>(),
                     f32_grid(grid.x, H, B, causal), stream, DKV_ARGS);
#undef DKV_ARGS
}

// dq by dq_tc_kernel (bf16) or dq_f32_kernel (f32)
template <typename T, int D, bool BIAS>
int launch_dq(const void* q, const void* k, const void* v, const void* bias,
              const void* o, const void* lse, const void* delta,
              const void* dout, void* dq, int B, int Sq, int Sk, int H,
              int causal, float scale, Dropout drop, cudaStream_t stream) {
  const dim3 grid((Sq + TC_ROWS - 1) / TC_ROWS, H, B);
#define DQ_ARGS \
  q, k, v, bias, o, lse, delta, dout, dq, Sq, Sk, H, causal, scale, drop
  if constexpr (std::is_same<T, bf16>::value)
    return launch_tc(dq_tc_kernel<D, BIAS>, dq_tc_smem_bytes<D, BIAS>(), grid,
                     stream, DQ_ARGS);
  else
    return launch_tc(dq_f32_kernel<D, BIAS>, dq_f32_smem_bytes<D, BIAS>(),
                     f32_grid(grid.x, H, B, causal), stream, DQ_ARGS);
#undef DQ_ARGS
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
