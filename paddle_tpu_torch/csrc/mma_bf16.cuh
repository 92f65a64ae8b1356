// The bf16 tensor-core building blocks shared by the flash-attention
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu): 16-byte
// cp.async tile copies into padded shared-memory rows (of f32 too, for
// the f32 forward), ldmatrix loads of mma.sync m16n8k16 operand
// fragments, and the repacking of f32 accumulator fragments into bf16 A
// fragments.
//
// Tiles live in shared memory in rows of D + 8 bf16 elements: the 16
// bytes of padding put the 8 rows an ldmatrix phase reads in 8 distinct
// 4-bank groups, so its reads are conflict-free.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

template <int D>
__host__ __device__ constexpr int tc_ld() {
  return D + 8;  // bf16 elements a shared-memory row
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (4 with cp_async4), zero-filled where ok is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b, a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to nearest-even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the m16k16 A fragment of columns 16 kk .. 16 kk + 15 of a warp's 16-row
// band held as m16n8 accumulator fragments c[2 kk], c[2 kk + 1]
template <int N>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float (&c)[N][4],
                                       int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// rows r0 .. r0 + ROWS - 1 of a [*, H, D] tensor of T (`src` at batch b,
// head h) into a [ROWS][D + 16 / sizeof(T)] tile (16 bytes of padding a
// row: tc_ld<D>() for bf16) by a block of THREADS threads; rows at or past
// n are zeros
template <int ROWS, int D, int THREADS, typename T>
__device__ __forceinline__ void tile_async(T* dst, const T* src, int r0,
                                           int n, long long ld_row) {
  constexpr int E = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int CH = D / E;          // 16-byte chunks a row
  static_assert(ROWS * CH % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / CH, c = i % CH;
    const int row = r0 + r;
    const bool ok = row < n;
    cp_async16(dst + r * (D + E) + c * E,
               src + (ok ? row * ld_row + c * E : 0), ok);
  }
}

// dst[i] = src[r0 + i] for i < ROWS, by a block of THREADS threads; zeros
// at or past n
template <int ROWS, int THREADS>
__device__ __forceinline__ void vec_async(float* dst, const float* src, int r0,
                                          int n) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS) {
    const bool ok = r0 + i < n;
    cp_async4(dst + i, src + (ok ? r0 + i : 0), ok);
  }
}
