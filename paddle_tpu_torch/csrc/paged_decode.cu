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
// 3.35 TB/s sets the floor, and at the serving shape (8 slots x 16 heads)
// there are too few independent rows to fill 132 SMs by bandwidth per
// block alone. What the design does about it: one block per (head,
// slot) -- 128 blocks, about one wave -- and inside it 8 warps that each
// walk a disjoint share of the positions, 4 positions per step with all
// 8 of their K/V row loads issued before any is used, so each warp keeps
// several loads in flight; the warps' online-softmax states (m, l, acc)
// merge once in shared memory at the end. The table lookup replaces the
// TPU's scalar prefetch: each block reads its own row. Splitting one
// slot's positions across blocks (split-K) is left for later.
//
// The quantized entry (QUANT = true) reads int8 K/V rows and their
// per-(position, head) f32 scales [P, bs, H] through the same table
// lookup. Each lane holds D/32 neighbouring elements of a row, so a row
// of D=64 int8 is one 64-byte coalesced load of 2 bytes a lane (4 bytes
// at D=128), widened to f32 only in registers and multiplied by the
// row's scale there: int8 * scale, the math of kv_cache.dequant_pages.
// The dequantized context never exists in memory. An inactive slot
// reads column 0 of scratch page 0 with page 0's scale, as the TPU
// kernel does.
//
// Measured on one H100 (tools/time_torch_mt_kernels.py and variants of
// this source): the quantized kernel takes longer than the f32 one for
// a quarter of the bytes. It is bound by each warp's serial work per
// position, not by memory: halving the warps doubles its time, while 4,
// 8 or 16 positions a step, or no scale loads at all, change nothing,
// and a compile-time block size (no integer division) saves 12%.
// Splitting a slot's positions over more warps or blocks is the lever.
//
// Plain C interface, bound from Python with ctypes; returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;
constexpr int STEP = 4;            // positions per warp per step
constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// element e of a row held by ``lane``: strided for full-precision rows
// (each load instruction covers the warp's 32 neighbours), neighbouring
// for int8 rows (one vector load a lane)
template <bool QUANT, int E>
__device__ __forceinline__ int col(int lane, int e) {
  return QUANT ? lane * E + e : lane + 32 * e;
}

// E neighbouring int8 values of a row: one 2- or 4-byte load
template <int E>
using I8 = std::conditional_t<E == 2, char2, char4>;

// widened to f32 and scaled in registers: int8 * scale
__device__ __forceinline__ void dequant(char2 c, float s, float* out) {
  out[0] = c.x * s;
  out[1] = c.y * s;
}
__device__ __forceinline__ void dequant(char4 c, float s, float* out) {
  out[0] = c.x * s;
  out[1] = c.y * s;
  out[2] = c.z * s;
  out[3] = c.w * s;
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
  constexpr int E = D / 32;  // elements of a row per lane (2 or 4)
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ float sm_acc[WARPS][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int* tbl = table + (long long)b * MB;
  // columns past the table's reach do not exist (the plain version
  // gathers exactly MB*bs of them)
  const int last = min(pos[b], MB * bs - 1);

  float qv[E];
  const T* qrow = q + ((long long)b * H + h) * D;
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] = to_f32(qrow[col<QUANT, E>(lane, e)]);

  float m = NEG_INF, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int base = w * STEP; base <= last; base += WARPS * STEP) {
    float kv[STEP][E], vv[STEP][E], s[STEP];
    if constexpr (QUANT) {
#pragma unroll
      for (int u = 0; u < STEP; ++u) {
        const int p = base + u;
        if (p <= last) {
          const long long page = tbl[p / bs];
          const long long srow = (page * bs + p % bs) * H + h;
          dequant(*reinterpret_cast<const I8<E>*>(kp + srow * D + lane * E),
                  ks[srow], kv[u]);
          dequant(*reinterpret_cast<const I8<E>*>(vp + srow * D + lane * E),
                  vs[srow], vv[u]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kv[u][e] = vv[u][e] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < STEP; ++u) {
        const int p = base + u;
        if (p <= last) {
          const long long page = tbl[p / bs];
          const long long row = ((page * bs + p % bs) * H + h) * D;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            kv[u][e] = to_f32(kp[row + lane + 32 * e]);
            vv[u][e] = to_f32(vp[row + lane + 32 * e]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kv[u][e] = vv[u][e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < STEP; ++u) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part = fmaf(qv[e], kv[u][e], part);
      s[u] = part;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < STEP; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    float m_new = m;
#pragma unroll
    for (int u = 0; u < STEP; ++u) {
      s[u] = base + u <= last ? s[u] * scale : NEG_INF;
      m_new = fmaxf(m_new, s[u]);
    }
    const float shift = m_new == NEG_INF ? 0.f : m_new;
    const float alpha = expf(m - shift);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < STEP; ++u) {
      const float pr = expf(s[u] - shift);  // masked -> exactly 0
      l += pr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(pr, vv[u][e], acc[e]);
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[w] = m;
    sm_l[w] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[w][col<QUANT, E>(lane, e)] = acc[e];
  __syncthreads();

  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) mx = fmaxf(mx, sm_m[i]);
    const float shift = mx == NEG_INF ? 0.f : mx;
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      const float a = expf(sm_m[i] - shift);  // an idle warp gives 0
      L = fmaf(a, sm_l[i], L);
      O = fmaf(a, sm_acc[i][d], O);
    }
    const float safe_l = L == 0.f ? 1.f : L;
    store(&out[((long long)b * H + h) * D + d], O / safe_l);
  }
}

template <typename T, typename PT, int D, bool QUANT>
int launch(const void* q, const void* kp, const void* ks, const void* vp,
           const void* vs, const void* table, const void* pos, void* out,
           int B, int H, int bs, int MB, float scale, cudaStream_t stream) {
  const dim3 grid(H, B);
  paged_decode_kernel<T, PT, D, QUANT><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const PT*>(kp),
      static_cast<const PT*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<T*>(out), H, bs, MB, scale);
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
