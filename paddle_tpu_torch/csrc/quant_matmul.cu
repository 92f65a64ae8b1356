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
// x_q [M, K] int8 row-major, as the JAX layout has it; the weight arrives
// K-major, as w_t [N, K] int8 row-major (the storage under
// slim.QuantizedLinear's [K, N] weight_q view; the wrapper makes it for a
// plain [K, N] weight). w_scale [N] f32 per output channel; act_scale one
// f32 in device memory (a calibrated static scale or the dynamic absmax
// the wrapper computed on the card just before, read here without a host
// round trip); out [M, N] f32 or bf16. The sum is an exact int32 (|acc| <=
// K * 127^2, 4.96e7 at K = 3072). The epilogue multiplies in the JAX
// kernel's order, scale = act_scale * w_scale[n] and then acc * scale,
// each rounded to nearest (__fmul_rn, no FMA), and bf16 output rounds to
// nearest even, so the result equals the plain version bit for bit.
//
// What bounds it on this card: at BERT-base's shapes (M = 24576 rows,
// (K, N) of (768, 768), (768, 3072), (3072, 768)) a call does 2MKN = 29 to
// 116 G integer operations against 95 to 321 MB of traffic, mostly the
// f32 output: the (768, 768) and (768, 3072) calls are bound by the bytes
// (the output's stores), the (3072, 768) one by the int8 tensor cores'
// 1979 TOP/s. The first design (mma.sync with cp.async, each B fragment
// gathered byte by byte from an N-major tile, one output tile a block)
// reached 27% of the bound at (768, 768): its tile's stores never
// overlapped the next tile's loads, and its shared-memory gathers fed the
// tensor cores slowly.
//
// What this design does about it:
// - wgmma.mma_async m64n128k32 s32.s8.s8: Hopper's warpgroup product,
//   both operands read by the tensor cores from shared memory, K-major, in
//   the 128-byte swizzle (wgmma takes 8-bit operands K-major only, hence
//   the K-major weight). Two consumer warpgroups share a 128 x 128 output
//   tile, 64 rows each, the int32 sums in registers.
// - TMA: one producer warp keeps a ring of STAGES tiles of x_q [128 x 128
//   bytes] and w_t [128 x 128 bytes] in flight, each copy reported to a
//   full barrier (mbarrier with a transaction count); the consumers free a
//   stage through its empty barrier once their wgmma on it has completed.
//   Rows past M load as zeros (TMA's out-of-bounds fill) and are not
//   stored.
// - The epilogue by TMA: each consumer warpgroup writes its 64 x 128
//   output tile to shared memory (in the 128-byte swizzle, free of bank
//   conflicts) and one thread hands it to a TMA store, which drops rows
//   past M. The warpgroup then goes on to its next tile while the store
//   drains. Stored from registers instead, the epilogue took half the
//   kernel's time at (768, 768), every SM storing at once and computing
//   at once.
// STAGES was chosen by timing variants of this source on one H100
// (tools/time_torch_int8_variants.py, f32 out at (24576, 768, 768)): 5
// stages took 0.0434-0.0441 ms against 0.0524 for 4, and an evict-first
// L2 policy on the output's stores gained nothing. With no output stores
// at all the kernel takes 0.032 ms: what remains is the operand tiles'
// traffic from L2, which a wider tile or a multicast across a cluster
// would cut.
// - A persistent grid: one block per SM walks the output tiles in row-
//   major tile order, so the blocks that run together share x_q's row
//   blocks in L2, and the producer loads the next tile while the
//   consumers finish this one.
// The tensor maps come from libcuda's cuTensorMapEncodeTiled, looked up
// through the runtime (cudaGetDriverEntryPointByVersion), so the library
// links nothing beyond the runtime.
//
// Plain C interface, bound from Python with ctypes; returns the launch's
// error, or cudaGetLastError() after it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                 // output rows per tile
constexpr int BN = 128;                 // output columns per tile
constexpr int BK = 128;                 // k bytes per stage: one swizzle row
constexpr int STAGES = 5;               // tiles of x_q and w_t in flight
constexpr int CONSUMERS = 2;            // warpgroups, 64 rows each
constexpr int THREADS = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int A_TILE = BM * BK;         // bytes
constexpr int B_TILE = BN * BK;
constexpr int OUT_TILE = 64 * BN * 4;   // a warpgroup's output, f32 at most
constexpr int SMEM_BYTES =
    STAGES * (A_TILE + B_TILE) + CONSUMERS * OUT_TILE + 2 * STAGES * 8 + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a box of the tensor map at (k, row) into shared memory, reported to bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(k),
      "r"(row)
      : "memory");
}

// a box of shared memory to the tensor map at (col, row), in the bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(col), "r"(row)
      : "memory");
}

// the 128 threads of one warpgroup
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte
// swizzle: 8-row groups of 128-byte rows, 1024 bytes apart (SBO); the
// leading offset is unused for this layout
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64] (+)= A[64 x 32] . B[128 x 32]^T, both K-major in shared memory;
// accumulate unless first
__device__ __forceinline__ void wgmma_m64n128k32(int* d, uint64_t a,
                                                 uint64_t b, int first) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.s32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(first));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// columns c, c + 1 of row r of a warpgroup's output tile [64][BN], kept as
// boxes of 64 rows x 128 bytes in the 128-byte swizzle that the output's
// tensor map applies (16-byte chunk j of row r at chunk j ^ (r % 8)): the
// eight rows of one store instruction land in eight different chunks, so
// the writes meet no bank conflict
template <typename TO>
__device__ __forceinline__ void put2(uint8_t* tile, int r, int c, float a,
                                     float b) {
  constexpr int BOX_COLS = 128 / sizeof(TO);
  const int byte = c % BOX_COLS * sizeof(TO);
  store2(reinterpret_cast<TO*>(tile + c / BOX_COLS * (64 * 128) + r * 128 +
                               ((byte >> 4 ^ (r & 7)) << 4) + (byte & 15)),
         a, b);
}

template <typename TO>
__global__ void __launch_bounds__(THREADS, 1)
    int8_matmul_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_out,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ act_scale,
                       int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: tiles start on such a boundary
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* As = smem;                          // [STAGES][BM][BK]
  uint8_t* Bs = smem + STAGES * A_TILE;        // [STAGES][BN][BK]
  uint8_t* Cs = Bs + STAGES * B_TILE;          // [CONSUMERS][OUT_TILE]
  uint64_t* full = reinterpret_cast<uint64_t*>(Cs + CONSUMERS * OUT_TILE);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_n = N / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int KT = K / BK;

  if (warp == CONSUMERS * 4) {
    // the producer: one thread keeps the ring full
    if ((threadIdx.x & 31) == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM;
        const int n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // the first round passes
          mbar_expect_tx(&full[stage], A_TILE + B_TILE);
          tma_load(As + stage * A_TILE, &tm_x, &full[stage], kt * BK, m0);
          tma_load(Bs + stage * B_TILE, &tm_w, &full[stage], kt * BK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // the consumers: warpgroup wg computes rows 64 wg .. 64 wg + 63
    const int wg = warp >> 2;
    const int t = threadIdx.x & 127;
    const int row = 16 * (t >> 5) + ((t & 31) >> 2);  // within the 64
    const int col = 2 * (t & 3);
    uint8_t* tile_out = Cs + wg * OUT_TILE;
    const float a_s = *act_scale;
    int stage = 0;
    uint32_t phase = 0;
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * BM;
      const int n0 = tile % tiles_n * BN;
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint64_t da = smem_desc(As + stage * A_TILE + wg * 64 * BK);
        const uint64_t db = smem_desc(Bs + stage * B_TILE);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 32; ++k)  // 32 bytes: +2 in 16-byte units
          wgmma_m64n128k32(d, da + 2 * k, db + 2 * k, kt == 0 && k == 0);
        wgmma_commit();
        if (kt > 0) {
          wgmma_wait<1>();  // the previous stage's products are done
          if (t == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (t == 0) mbar_arrive(&empty[prev]);

      // epilogue: d[4c], d[4c+1] at (row, 8c + col, +1); d[4c+2], d[4c+3]
      // eight rows below. The output tile goes to shared memory and from
      // there to device memory by TMA, which drops rows past M; the
      // warpgroup goes on to its next tile while the store drains, and
      // waits only before it writes the tile buffer again.
      if (t == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      warpgroup_sync(1 + wg);
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const int n = n0 + 8 * c + col;
        const float2 ws = __ldg(reinterpret_cast<const float2*>(w_scale + n));
        const float s0 = __fmul_rn(a_s, ws.x);
        const float s1 = __fmul_rn(a_s, ws.y);
        put2<TO>(tile_out, row, 8 * c + col,
                 __fmul_rn(__int2float_rn(d[4 * c]), s0),
                 __fmul_rn(__int2float_rn(d[4 * c + 1]), s1));
        put2<TO>(tile_out, row + 8, 8 * c + col,
                 __fmul_rn(__int2float_rn(d[4 * c + 2]), s0),
                 __fmul_rn(__int2float_rn(d[4 * c + 3]), s1));
      }
      // the generic-proxy writes, visible to the TMA unit's reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(1 + wg);
      if (t == 0) {
        constexpr int BOX_COLS = 128 / sizeof(TO);
#pragma unroll
        for (int bx = 0; bx < BN / BOX_COLS; ++bx)
          tma_store(&tm_out, tile_out + bx * (64 * 128), n0 + bx * BOX_COLS,
                    m0 + 64 * wg);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [rows, cols] matrix of elem-byte values moved in boxes of
// box_rows x 128 bytes, 128-byte swizzled; rows past the end read as zeros
// and are not written
bool tensor_map(CUtensorMap* map, EncodeTiled encode, CUtensorMapDataType type,
                int elem, const void* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TO>
int launch(const void* x, const void* w_t, const void* w_scale,
           const void* act_scale, void* out, int M, int K, int N,
           cudaStream_t stream) {
  static_assert(BK == 128, "an operand box row is one swizzle row");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const CUtensorMapDataType out_type =
      sizeof(TO) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tm_x, tm_w, tm_out;
  if (!tensor_map(&tm_x, encode, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, M, K,
                  BM) ||
      !tensor_map(&tm_w, encode, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w_t, N, K,
                  BN) ||
      !tensor_map(&tm_out, encode, out_type, sizeof(TO), out, M, N, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (M + BM - 1LL) / BM * (N / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  int8_matmul_kernel<TO><<<grid, THREADS, SMEM_BYTES, stream>>>(
      tm_x, tm_w, tm_out, static_cast<const float*>(w_scale),
      static_cast<const float*>(act_scale), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_q [M, K] and w_t [N, K] int8 row-major (the weight K-major), w_scale
// [N] f32, act_scale one f32 (device pointers); out [M, N] in dtype (0 =
// float32, 1 = bfloat16). K and N must be multiples of 128 (the wrapper's
// shape gate), M >= 1; x_q and w_t 16-byte aligned.
extern "C" int int8_matmul(const void* x_q, const void* w_t,
                           const void* w_scale, const void* act_scale,
                           void* out, int M, int K, int N, int dtype,
                           void* stream) {
  if (M < 1 || K < 128 || N < 128 || K % 128 || N % 128 ||
      (M + BM - 1LL) / BM * (N / BN) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x_q, w_t, w_scale, act_scale, out, M, K, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x_q, w_t, w_scale, act_scale, out, M, K,
                                 N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
