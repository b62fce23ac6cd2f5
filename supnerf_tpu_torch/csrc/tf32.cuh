// Float32-accurate products on the tensor cores (3xTF32), shared by K2's
// dense layer (render_common.cuh:dense_mma) and K4 (wgrad.cu).
//
// A TF32 operand keeps 10 of float32's 23 mantissa bits. Each float32
// operand x is split in registers into big = x rounded to TF32 and small =
// x - big truncated to TF32; a product a*b is then big_a*big_b +
// big_a*small_b + small_a*big_b, three mma.sync passes accumulating in
// float32. The dropped small_a*small_b term and the truncation of `small`
// are below 2^-20 of |a*b|, so each product is float32-accurate. The
// tensor core's float32 accumulation truncates instead of rounding to
// nearest; over a 256-term chain of three passes it flips ReLU gates at
// kinks many times more often than float32 sums do, so the kernels sum
// short chains (one k-step of 8 in K2, one 64-row stage in K4) and add
// those into their sums with float32 adds. tests/test_torch_tf32_split.py
// emulates this arithmetic on the CPU against float64.
#pragma once

#include <stdint.h>

namespace supnerf {

// big: x rounded to TF32, to nearest with ties away from zero (cvt.rna's
// rounding: add half of the 13 dropped bits' unit to the magnitude bits,
// then clear them); small: x - big (exact in float32) truncated to TF32.
// Integer and float32 adds and masks, all on the full-rate pipes: the
// conversion instruction (cvt.rna.tf32.f32) is a quarter-rate one, and a
// kernel splits every fragment it loads.
static __device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// d (16 x 8, float32) = a (16 x 8, row) * b (8 x 8, col) + c, TF32 operands
static __device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                                const uint32_t b[2], const float c[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// d = a * b + c to float32 accuracy from split operands: the two cross terms
// first, then big * big. The tensor core adds into c without rounding to
// nearest, so the kernels keep these chains short and add their results
// into float32 sums of their own.
static __device__ __forceinline__ void mma_3xtf32(float d[4], const uint32_t a_big[4],
                                                  const uint32_t a_small[4],
                                                  const uint32_t b_big[2],
                                                  const uint32_t b_small[2],
                                                  const float c[4]) {
  mma_tf32(d, a_small, b_big, c);
  mma_tf32(d, a_big, b_small, d);
  mma_tf32(d, a_big, b_big, d);
}

}  // namespace supnerf
