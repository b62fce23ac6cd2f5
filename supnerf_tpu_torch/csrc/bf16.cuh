// bfloat16 operands on the tensor cores, for the bfloat16 mode of K3, K5,
// K6 and K7 (render_common.cuh:dense_mma_bf16) and K4 (wgrad.cu): the
// precision at which the JAX package runs its Pallas kernels on its
// accelerator (dtype=bfloat16: every matmul operand cast to bfloat16,
// float32 accumulation). K1's and K2's bfloat16 builds take their
// fragments from here and run wgmma (render_bf16.cuh).
//
// A bfloat16 operand keeps float32's exponent and 8 of its 24 significand
// bits, so the product of two of them is exact in float32 and one
// mma.sync m16n8k16 makes each product once, where the float32 mode's
// 3xTF32 makes three (tf32.cuh). The tensor core sums a k-step's 16
// products and its accumulator input without rounding to nearest, so the
// kernels sum each k-step from zero and add it into their float32 sums
// with float32 adds, as tf32.cuh's callers do (render_bf16.cuh sums a
// 64-row K-tile so, on wgmma).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace supnerf {

// x rounded to bfloat16, to nearest with ties to even (what JAX's
// astype(bfloat16) and torch's .to(torch.bfloat16) do), back in float32
static __device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two values as one bfloat16x2 fragment register, each rounded to nearest
// even: lo in the low half (the lower k or row index of the pair)
static __device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (16 x 8, float32) = a (16 x 16, row) * b (16 x 8, col) + c, bfloat16
// operands. Fragments (PTX ISA, mma.m16n8k16 for .bf16), gid = lane / 4,
// tig = lane % 4: a[0] rows gid, k 2 tig + {0, 1}; a[1] row gid + 8; a[2]
// and a[3] the same rows at k + 8; b[0] k 2 tig + {0, 1}, column gid; b[1]
// k + 8; d as the TF32 shape's: rows gid and gid + 8, columns 2 tig + {0,
// 1}.
static __device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                                const uint32_t b[2], const float c[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

}  // namespace supnerf
