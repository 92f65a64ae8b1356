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
// the zero adapter, so a base-model row gets exactly +0.0 (rows on it are
// computed like any other: qkv + delta depends on the sign of the zero).
//
// What bounds it on this card: memory, and at the decode dispatch
// latency. A token costs 2 r (E + O) operations against 4 (E + O) bytes
// of its own x read and delta written in f32; at the serving shapes (E =
// 1024, r = 8, O = 3072) that is 4 operations a byte, far below the ~20 at
// which f32 arithmetic (67 TFLOP/s) would take over, and writing the
// [B, S, O] delta is most of the bytes (12.6 MB at the prefill dispatch,
// B = 4, S = 256). At the decode dispatch (B = 8, S = 1) the bytes take
// 0.3 us and what a call costs is its chain of dependent steps: the
// first design (a block per (row, 1024 columns), 24 blocks) loaded x and
// A, reduced the shrink, and only then loaded B: two dependent trips to
// device memory on 24 of 132 SMs.
//
// What this design does about it: one thread-block cluster of CLUSTER
// blocks per (batch row, tile of ST tokens, group of output columns).
//   - Rank c takes the c-th 1/CLUSTER of E for the shrink and the c-th
//     1/CLUSTER of the group's columns for the expand. Right after reading
//     ids[b] it issues cp.async copies of its slices of A [r, E/C] and x
//     (f32 x; bf16 x is widened by plain loads) and then of B [r, O/C]
//     into shared memory, 16 bytes a copy where E and O are multiples of
//     4 and the tensors 16-byte aligned, else 4: one dependent trip (ids,
//     then the pools) before any arithmetic, and B's copy waited for only
//     before the expand.
//   - The shrink: each (token, rank) sum over the slice is one warp's,
//     lanes striding over E and a shuffle tree finishing it, a fixed order.
//     A slice longer than the chunk shared memory holds goes in chunks.
//   - The rank's partial h [ST, r] stays in its shared memory. After a
//     cluster barrier every rank sums the CLUSTER partials in rank order
//     through distributed shared memory, so every rank holds the same h,
//     bit for bit, on every call: one launch, no atomics, no scratch.
//   - The expand: each thread keeps COLS columns of the tile's ST tokens
//     in registers over the r rows of its B slice, h read four tokens at a
//     time; the stores of a token's columns are coalesced. A second
//     cluster barrier, at the end, keeps each rank's shared memory alive
//     until the others have read it.
// The host splits the columns into groups when a rank's B slice would
// pass B_FLOATS floats (O > CLUSTER * B_FLOATS / r), each group's cluster
// repeating the shrink. r is at most RMAX = 64; the wrapper raises above.
// The schedule was chosen by timing C in {2, 4, 8, 16} and ST in {4, 8,
// 16} on an H100 80GB HBM3 at 700 W (tools/time_torch_bgmv_variants.py,
// L2 flushed, f32; PERF.md section 6): at the decode dispatch clusters of 8
// took 0.0083-0.0087 ms, of 2 0.0095-0.0101, where the first design took
// 0.0119-0.0123 and a launch of this kernel that returns at once
// 0.0048-0.0051; at the prefill one (B = 4, S = 256) clusters of 2 took
// 0.0172-0.0178 ms, of 8 0.0276-0.0336, the first design 0.0289-0.0295:
// there the cluster's repeated per-block work outweighs the split of E.
// So S = 1 launches clusters of 8 and longer dispatches clusters of 2,
// both over tiles of ST = 8 tokens (4 was no faster at decode and slower
// at prefill, 16 slower at both).
//
// Plain C interface, bound from Python with ctypes; returns the launch's
// error, or cudaGetLastError() after it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma_bf16.cuh"  // cp.async

namespace cg = cooperative_groups;

namespace {

// blocks a cluster: at the decode dispatch (S = 1), and at a prefill one
constexpr int DECODE_CLUSTER = 8;
constexpr int PREFILL_CLUSTER = 2;
constexpr int ST = 8;                // tokens a cluster
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 2;              // output columns a thread a pass
constexpr int RMAX = 64;             // the largest rank
constexpr int B_FLOATS = 16384;      // a rank's B slice at most (64 KB)
constexpr int CHUNK_FLOATS = 8192;   // A's and x's chunk at most (32 KB)
static_assert(ST % 4 == 0, "h is read as float4 across tokens");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [r][n] of a row-major pool slice (row stride ld, from src) into
// dst [r][ldd] by the block, 16 bytes a copy when vec (n, ld, src and
// ldd multiples of 4 floats), else 4
__device__ __forceinline__ void slice_async(float* dst, int ldd,
                                            const float* src, long long ld,
                                            int r, int n, bool vec) {
  if (vec) {
    const int ch = n / 4;
    for (int i = threadIdx.x; i < r * ch; i += THREADS) {
      const int j = i / ch, c = i % ch;
      cp_async16(dst + j * ldd + 4 * c, src + j * ld + 4 * c, true);
    }
  } else {
    for (int i = threadIdx.x; i < r * n; i += THREADS) {
      const int j = i / n, c = i % n;
      cp_async4(dst + j * ldd + c, src + j * ld + c, true);
    }
  }
}

// TX: x and the delta. Dynamic shared memory: B's slice [r][OC], A's
// chunk [r][EH], x's chunk [ST][EH], this rank's partial h [ST][r] and
// the cluster's h transposed, [r][ST], all f32. vec: bit 0, the pools
// go by 16-byte copies; bit 1, f32 x does.
template <typename TX, int CLUSTER>
__global__ void __launch_bounds__(THREADS)
    bgmv_kernel(const TX* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, const int* __restrict__ ids,
                TX* __restrict__ out, int S, int E, int r, int O, int OC,
                int EC, int EH, int vec) {
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);
  float* As = Bs + r * OC;
  float* xs = As + r * EH;
  float* hpart = xs + ST * EH;
  float* h = hpart + ST * r;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int s0 = blockIdx.y * ST;
  const int row = blockIdx.z;
  const int ns = min(ST, S - s0);
  // this rank's columns o0 .. o0 + no - 1 and E slice e0 .. e0 + ne - 1
  const int o0 = blockIdx.x * OC;
  const int no = max(0, min(OC, O - o0));
  const int e0 = rank * EC;
  const int ne = max(0, min(EC, E - e0));

  const long long id = ids[row];
  const float* A = a + id * r * E + e0;
  const TX* X = x + (static_cast<long long>(row) * S + s0) * E + e0;
  // A's chunk c0 .. c0 + nh - 1 and x's, by cp.async (x widened to f32
  // on the way where it is bf16)
  auto load_chunk = [&](int c0, int nh) {
    slice_async(As, EH, A + c0, E, r, nh, vec & 1);
    if constexpr (sizeof(TX) == sizeof(float)) {
      slice_async(xs, EH, reinterpret_cast<const float*>(X) + c0, E, ns, nh,
                  vec & 2);
    } else {
      for (int i = tid; i < ns * nh; i += THREADS)
        xs[(i / nh) * EH + i % nh] =
            to_f32(X[(long long)(i / nh) * E + c0 + i % nh]);
    }
    cp_async_commit();
  };
  int nh = min(EH, ne);  // the chunk's length
  if (nh > 0) load_chunk(0, nh);
  // B's slice is waited for only before the expand
  if (no > 0) slice_async(Bs, OC, b + id * r * O + o0, O, r, no, vec & 1);
  cp_async_commit();
  for (int i = tid; i < ST * r; i += THREADS) hpart[i] = 0.f;

  // the shrink over this rank's E slice, chunk by chunk: (token, rank)
  // pair p = s r + j is warp p % WARPS's, lanes striding over the chunk
  for (int c0 = 0;;) {
    if (c0 == 0)
      cp_async_wait<1>();  // all but B's slice
    else
      cp_async_wait<0>();
    __syncthreads();
    for (int p = w; p < ns * r; p += WARPS) {
      const float* xr = xs + (p / r) * EH;
      const float* ar = As + (p % r) * EH;
      float v = 0.f;
#pragma unroll 4
      for (int e = lane; e < nh; e += 32) v = fmaf(xr[e], ar[e], v);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) hpart[p] += v;
    }
    c0 += EH;
    if (c0 >= ne) break;
    __syncthreads();  // the chunk's readers are done
    nh = min(EH, ne - c0);
    load_chunk(c0, nh);
  }
  cluster.sync();  // every rank's partial h is in its shared memory

  // h = the ranks' partials summed in rank order (tokens past ns are 0)
  for (int i = tid; i < ST * r; i += THREADS) {
    float v = 0.f;
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c) v += *cluster.map_shared_rank(hpart + i, c);
    h[i % r * ST + i / r] = v;
  }
  cp_async_wait<0>();  // B's slice
  __syncthreads();

  // the expand: out[s, o] = h[s] . B[:, o] for this rank's columns
  TX* ob = out + (static_cast<long long>(row) * S + s0) * O + o0;
  for (int c0 = 0; c0 < no; c0 += THREADS * COLS) {
    float acc[ST][COLS];
#pragma unroll
    for (int s = 0; s < ST; ++s)
#pragma unroll
      for (int k = 0; k < COLS; ++k) acc[s][k] = 0.f;
    for (int j = 0; j < r; ++j) {
      float bv[COLS];
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        const int c = c0 + tid + THREADS * k;
        bv[k] = c < no ? Bs[j * OC + c] : 0.f;
      }
#pragma unroll
      for (int s4 = 0; s4 < ST; s4 += 4) {
        const float4 h4 = *reinterpret_cast<const float4*>(h + j * ST + s4);
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int k = 0; k < COLS; ++k)
            acc[s4 + s][k] = fmaf(hv[s], bv[k], acc[s4 + s][k]);
      }
    }
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      if (s >= ns) break;
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        const int c = c0 + tid + THREADS * k;
        if (c < no) store(&ob[(long long)s * O + c], acc[s][k]);
      }
    }
  }
  cluster.sync();  // no rank leaves while another reads its partial h
}

int round4(int n) { return (n + 3) / 4 * 4; }

template <typename TX, int CLUSTER>
int launch(const void* x, const void* a, const void* b, const void* ids,
           void* out, int B, int S, int E, int r, int O,
           cudaStream_t stream) {
  auto* kernel = bgmv_kernel<TX, CLUSTER>;
  // a rank's columns: the groups keep a B slice within B_FLOATS
  const int oc_max = B_FLOATS / r / 4 * 4;
  const int groups = (O + CLUSTER * oc_max - 1) / (CLUSTER * oc_max);
  const int OC = round4((O + groups * CLUSTER - 1) / (groups * CLUSTER));
  const int EC = round4((E + CLUSTER - 1) / CLUSTER);
  const int EH = std::min(EC, CHUNK_FLOATS / std::max(r, ST) / 4 * 4);
  const int tiles = (S + ST - 1) / ST;
  if (tiles > 65535 || B > 65535 ||
      static_cast<long long>(groups) * CLUSTER > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (E % 4 == 0 && O % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0) |
                  (E % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) << 1;
  const size_t bytes =
      sizeof(float) * (static_cast<size_t>(r) * OC + r * EH + ST * EH +
                       2 * ST * r);
  cudaError_t err = cudaSuccess;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (CLUSTER > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * CLUSTER, tiles, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TX*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const int*>(ids),
      static_cast<TX*>(out), S, E, r, O, OC, EC, EH, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && S == 1)
    return launch<float, DECODE_CLUSTER>(x, a, b, ids, out, B, S, E, r, O, st);
  if (dtype == 0)
    return launch<float, PREFILL_CLUSTER>(x, a, b, ids, out, B, S, E, r, O, st);
  if (dtype == 1 && S == 1)
    return launch<bf16, DECODE_CLUSTER>(x, a, b, ids, out, B, S, E, r, O, st);
  if (dtype == 1)
    return launch<bf16, PREFILL_CLUSTER>(x, a, b, ids, out, B, S, E, r, O, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
