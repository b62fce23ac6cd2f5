// Asynchronous global-to-shared copies (cp.async, sm_80+), shared by the
// dense layer of K1, K2 and K3 (render_common.cuh:dense_mma) and K4
// (wgrad.cu).
#pragma once

#include <stdint.h>

namespace supnerf {

// `size` (4 or 16) bytes from global to shared memory, of which the first
// `bytes` are read and the rest zero-filled (nothing is read with bytes 0);
// both addresses aligned to `size`.
template <int size>
static __device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's committed groups are in flight
template <int pending>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

}  // namespace supnerf
