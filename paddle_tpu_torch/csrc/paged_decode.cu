// Paged flash-decode attention for Hopper (sm_90a), f32 or bf16 in, f32 math,
// over full-precision pools or int8 pools with f32 scales.
//
// Replaces the TPU kernels
// paddle_tpu/ops/pallas/paged_decode.py::paged_decode_attention
// (_decode_kernel, pallas_call at :149) and ::paged_decode_attention_quant
// (_decode_kernel with quant=True, pallas_call at :199): one decode step
// of attention for every batch slot over the paged K/V pools [P, bs, H, D],
// reading each slot's pages in place through its block-table row [MB]; the slot
// at position pos attends to columns 0..pos inclusive, blocks past pos
// are never touched, and the gathered context never exists in memory.
// An inactive slot (pos 0, all-scratch row) attends column 0 of page 0,
// exactly as the TPU kernel does.
//
// What bounds it on this card: memory. Every K/V byte of the visible
// positions is read once and used for 2 operations, so the card's
// 3.35 TB/s sets the floor -- well under a microsecond at the serving
// shape (8 slots x 16 heads, about 1000 visible positions). At that size
// what a call costs is latency: the longest chain of dependent loads and
// reductions that one (slot, head) walks. The first design (one block per
// (slot, head), each warp walking its share of the slot's positions one
// row at a time, the table lookup in device memory before every row's
// load) was bound by that chain: the slot with 512 positions set the time.
//
// What this design does about it:
// - A thread-block cluster of CLUSTER blocks per (slot, head). Block rank r
//   takes the contiguous r-th 1/CLUSTER of the slot's visible positions
//   0..min(pos, MB*bs-1) and ends with its online-softmax state (m, l,
//   acc[D]) in its own shared memory. After a cluster barrier rank 0 reads
//   the other ranks' states through distributed shared memory, merges them
//   in rank order and writes out. No atomics, no scratch in device memory
//   and one launch; the merge order is fixed, so every call repeats bit for
//   bit. A rank with no positions holds m = -1e30, l = 0 and merges to
//   nothing.
// - The slot's table row is copied to shared memory once, so a row's page
//   lookup no longer waits on device memory.
// - Sub-warp rows: each lane loads 16 bytes of a row, so a row takes
//   D * sizeof(elem) / 16 lanes (4 for int8 at D = 64, 8 for bf16, 16 for
//   f32) and one load instruction covers 32 / that many rows. The dot
//   product reduces over those lanes only (2 shuffle levels for int8 at
//   D = 64, against 5 for a whole warp), each row group keeps its own
//   online-softmax state, and the groups merge once at the end.
// - Every lane issues all STEPS of its K, V (and scale) loads before it
//   uses the first.
// CLUSTER, WARPS and STEPS were chosen by timing variants of this source on
// one H100 (tools/time_torch_decode_variants.py, at chip_smoke.py's shape,
// L2 flushed): 2 blocks of 8 warps with 4 loads in flight took 0.0112 ms
// on int8 pools, against 0.0117 for 4 blocks of 4 warps, 0.0171 for 8 of 4
// and 0.0127 for one block of 16 warps; more blocks cost more than the
// shorter walk saves.
//
// The quantized entry (QUANT = true) reads int8 K/V rows and their
// per-(position, head) f32 scales [P, bs, H]: the dot product of q with
// the int8 row is scaled once by the row's K scale, and p times the row's
// V scale weights the int8 V row -- the math of kv_cache.dequant_pages
// up to rounding. The dequantized context never exists in memory.
//
// Plain C interface, bound from Python with ctypes; returns the launch's
// error, or cudaGetLastError() after it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 2;         // blocks per (slot, head)
constexpr int WARPS = 8;           // warps per block
constexpr int STEPS = 4;           // row loads per lane in flight
constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// element e of 16 loaded bytes, widened to f32 (e is a constant after
// unrolling, so this is a byte or half extract, no memory)
__device__ __forceinline__ float elem(const uint4& v, int e, signed char) {
  return static_cast<float>(
      static_cast<signed char>(word(v, e >> 2) >> (8 * (e & 3))));
}
__device__ __forceinline__ float elem(const uint4& v, int e, float) {
  return __uint_as_float(word(v, e));
}
__device__ __forceinline__ float elem(const uint4& v, int e, __nv_bfloat16) {
  const unsigned w = word(v, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// the online-softmax merge of two states: (m, l, acc) takes in (m2, l2,
// acc2); a state that has seen nothing (m = -1e30, l = 0) adds nothing
template <int E>
__device__ __forceinline__ void merge(float& m, float& l, float* acc,
                                      float m2, float l2, const float* acc2) {
  const float mx = fmaxf(m, m2);
  const float shift = mx == NEG_INF ? 0.f : mx;
  const float a = expf(m - shift), a2 = expf(m2 - shift);
  l = fmaf(a, l, a2 * l2);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = fmaf(a, acc[e], a2 * acc2[e]);
  m = mx;
}

// T: q and out; PT: the pools (T, or signed char when QUANT)
template <typename T, typename PT, int D, bool QUANT>
__global__ void __launch_bounds__(WARPS * 32)
    paged_decode_kernel(const T* __restrict__ q, const PT* __restrict__ kp,
                        const PT* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, T* __restrict__ out,
                        int H, int bs, int MB, float scale) {
  constexpr int LANES = D * sizeof(PT) / 16;  // lanes per row
  constexpr int ROWS = 32 / LANES;            // rows per warp load
  constexpr int E = 16 / sizeof(PT);          // elements per lane
  extern __shared__ int sm_tbl[];             // the slot's table row [MB]
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float sm_acc[WARPS][D];
  __shared__ float blk_m, blk_l;  // the block's state, read by rank 0
  __shared__ float blk_acc[D];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.x / CLUSTER;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int sub = lane % LANES;  // which 16 bytes of a row
  const int row = lane / LANES;  // which row of the warp's load

  const int* tbl = table + static_cast<long long>(b) * MB;
  for (int i = tid; i < MB; i += WARPS * 32) sm_tbl[i] = tbl[i];
  // columns past the table's reach do not exist (the plain version
  // gathers exactly MB*bs of them)
  const int n = min(pos[b], MB * bs - 1) + 1;
  const int p0 = static_cast<int>(static_cast<long long>(n) * rank / CLUSTER);
  const int p1 =
      static_cast<int>(static_cast<long long>(n) * (rank + 1) / CLUSTER);

  float qv[E];
  const T* qrow = q + (static_cast<long long>(b) * H + h) * D + sub * E;
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] = to_f32(qrow[e]);
  __syncthreads();  // the table row

  float m = NEG_INF, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  // the loop bound is the warp's, so all its lanes take every step and
  // the shuffles see the whole warp; rows past p1 are masked
  for (int wb = p0 + w * ROWS; wb < p1; wb += WARPS * ROWS * STEPS) {
    uint4 kr[STEPS], vr[STEPS];
    float ksc[STEPS], vsc[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const int p = wb + u * WARPS * ROWS + row;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      ksc[u] = vsc[u] = 0.f;
      if (p < p1) {
        const long long srow =
            (static_cast<long long>(sm_tbl[p / bs]) * bs + p % bs) * H + h;
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kp + srow * D) + sub);
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vp + srow * D) + sub);
        if constexpr (QUANT) {
          ksc[u] = __ldg(ks + srow);
          vsc[u] = __ldg(vs + srow);
        }
      }
    }
    float s[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part = fmaf(qv[e], elem(kr[u], e, PT()), part);
      s[u] = part;
    }
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < STEPS; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    float m_new = m;
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const int p = wb + u * WARPS * ROWS + row;
      const float k_scale = QUANT ? ksc[u] : 1.f;
      s[u] = p < p1 ? s[u] * k_scale * scale : NEG_INF;
      m_new = fmaxf(m_new, s[u]);
    }
    const float shift = m_new == NEG_INF ? 0.f : m_new;
    const float alpha = expf(m - shift);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const float pr = expf(s[u] - shift);  // masked -> exactly 0
      l += pr;
      const float pv = QUANT ? pr * vsc[u] : pr;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[e] = fmaf(pv, elem(vr[u], e, PT()), acc[e]);
    }
    m = m_new;
  }

  // the warp's row groups merge: lanes lane and lane ^ o hold the same
  // 16 bytes of different rows
#pragma unroll
  for (int o = LANES; o < 32; o <<= 1) {
    float acc2[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc2[e] = __shfl_xor_sync(0xffffffffu, acc[e], o);
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    merge<E>(m, l, acc, m2, l2, acc2);
  }
  if (row == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[w][sub * E + e] = acc[e];
    if (lane == 0) {
      sm_m[w] = m;
      sm_l[w] = l;
    }
  }
  __syncthreads();

  // the block's state from its warps', in warp order
  for (int d = tid; d < D; d += WARPS * 32) {
    float bm = NEG_INF, bl = 0.f, bo = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) merge<1>(bm, bl, &bo, sm_m[i], sm_l[i], &sm_acc[i][d]);
    blk_acc[d] = bo;
    if (d == 0) {
      blk_m = bm;
      blk_l = bl;
    }
  }
  cluster.sync();  // every rank's state is in its shared memory

  if (rank == 0) {
    for (int d = tid; d < D; d += WARPS * 32) {
      float rm[CLUSTER], rl[CLUSTER], ro[CLUSTER];
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) {
        rm[r] = *cluster.map_shared_rank(&blk_m, r);
        rl[r] = *cluster.map_shared_rank(&blk_l, r);
        ro[r] = *cluster.map_shared_rank(&blk_acc[d], r);
      }
      float fm = NEG_INF, fl = 0.f, fo = 0.f;
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) merge<1>(fm, fl, &fo, rm[r], rl[r], &ro[r]);
      const float safe_l = fl == 0.f ? 1.f : fl;
      store(&out[(static_cast<long long>(b) * H + h) * D + d], fo / safe_l);
    }
  }
  cluster.sync();  // no rank leaves while rank 0 reads its shared memory
}

template <typename T, typename PT, int D, bool QUANT>
int launch(const void* q, const void* kp, const void* ks, const void* vp,
           const void* vs, const void* table, const void* pos, void* out,
           int B, int H, int bs, int MB, float scale, cudaStream_t stream) {
  auto* kernel = paged_decode_kernel<T, PT, D, QUANT>;
  const size_t table_bytes = static_cast<size_t>(MB) * sizeof(int);
  if (B < 1 || B > 65535 || MB < 1 || table_bytes > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (CLUSTER > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H * CLUSTER, B);
  cfg.blockDim = dim3(WARPS * 32);
  cfg.dynamicSmemBytes = table_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const PT*>(kp),
      static_cast<const PT*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<T*>(out), H, bs, MB, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. table [B, MB] and pos [B] are int32.
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* pos, void* out, int B,
                                      int H, int D, int bs, int MB,
                                      float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && D == 64)
    return launch<float, float, 64, false>(q, k_pages, nullptr, v_pages,
                                           nullptr, table, pos, out, B, H,
                                           bs, MB, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, float, 128, false>(q, k_pages, nullptr, v_pages,
                                            nullptr, table, pos, out, B, H,
                                            bs, MB, scale, st);
  if (dtype == 1 && D == 64)
    return launch<bf16, bf16, 64, false>(q, k_pages, nullptr, v_pages,
                                         nullptr, table, pos, out, B, H, bs,
                                         MB, scale, st);
  if (dtype == 1 && D == 128)
    return launch<bf16, bf16, 128, false>(q, k_pages, nullptr, v_pages,
                                          nullptr, table, pos, out, B, H, bs,
                                          MB, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q and out float32 [B, H, D]; k/v pages int8 [P, bs, H, D]; k/v scales
// float32 [P, bs, H]; table [B, MB] and pos [B] int32.
extern "C" int paged_decode_attention_quant(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* table,
    const void* pos, void* out, int B, int H, int D, int bs, int MB,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<float, signed char, 64, true>(q, k_pages, k_scales,
                                                v_pages, v_scales, table, pos,
                                                out, B, H, bs, MB, scale, st);
  if (D == 128)
    return launch<float, signed char, 128, true>(q, k_pages, k_scales,
                                                 v_pages, v_scales, table,
                                                 pos, out, B, H, bs, MB,
                                                 scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
