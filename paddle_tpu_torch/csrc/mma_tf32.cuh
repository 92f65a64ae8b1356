// The 3xTF32 building blocks shared by the float32 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): an f32 product on the
// tensor cores at f32 accuracy, as CUTLASS's OpMultiplyAddFastF32 computes
// it. Each f32 operand x becomes big = tf32(x) and small = tf32(x - big),
// both rounded to nearest, ties away, and a b is summed from small_a big_b
// + big_a small_b + big_a big_b, the cross terms first, on
// mma.sync.aligned.m16n8k8 .tf32 with f32 accumulation: about 2^-21 of
// each product, the order of f32 rounding. Plain TF32, or raw f32
// registers fed to a tf32 product (which truncates them), keeps 10
// mantissa bits.

#pragma once

#include <stdint.h>

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
