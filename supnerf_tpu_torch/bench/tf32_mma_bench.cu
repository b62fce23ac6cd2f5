// Throughput of the tensor-core instructions the port's 3xTF32 kernels use,
// on one card, with no PyTorch:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o tf32_mma_bench supnerf_tpu_torch/bench/tf32_mma_bench.cu && ./tf32_mma_bench
// 1. mma.sync m16n8k8 TF32 (and m16n8k16 bf16 beside it) in 16 independent
//    accumulator chains a warp, operands in registers: the instruction's
//    ceiling.
// 2. K4's per-stage arithmetic (csrc/wgrad.cu: 8 warps, a 128 x 128 tile, a
//    64-row stage, fragments from shared memory, the tf32.cuh split, three
//    passes, a stage sum added in float32) on a tile that stays in shared
//    memory: what the kernel's inner loop can reach without its copies.
// Prints TFLOP/s of TF32 (or bf16) products, one line each.
#include <cstdint>
#include <cstdio>

#include <cuda_runtime.h>

#include "../csrc/tf32.cuh"

using namespace supnerf;

template <bool kBf16>
__global__ void __launch_bounds__(256, 1) chains(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x * 64 + i;
  for (int i = 0; i < 2; ++i) b[i] = 0x3f000000u + i;
  float d[16][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      if (kBf16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int c = 0; c < 16; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

constexpr int kRowsStage = 64, kLd = 136;

__global__ void __launch_bounds__(256, 1) wgrad_stage(float* out, int iters) {
  extern __shared__ float sm[];                      // 2 x kRowsStage x kLd
  for (int i = threadIdx.x; i < 2 * kRowsStage * kLd; i += 256) sm[i] = 1.0f + i * 1e-4f;
  __syncthreads();
  const float* As = sm;
  const float* Gs = sm + kRowsStage * kLd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wn = (warp & 1) * 64, wk = (warp >> 1) * 32;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4][4][4] = {};
  for (int it = 0; it < iters; ++it) {
    float seg[4][4][4];
#pragma unroll
    for (int rr = 0; rr < kRowsStage; rr += 8) {
      const float* g_lo = Gs + (rr + tig) * kLd + wn + gid;
      const float* g_hi = g_lo + 4 * kLd;
      const float* a_lo = As + (rr + tig) * kLd + wk + gid;
      const float* a_hi = a_lo + 4 * kLd;
      uint32_t ab[4][2], as[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        tf32_split(a_lo[8 * j], ab[j][0], as[j][0]);
        tf32_split(a_hi[8 * j], ab[j][1], as[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t gb[4], gs[4];
        tf32_split(g_lo[16 * i], gb[0], gs[0]);
        tf32_split(g_lo[16 * i + 8], gb[1], gs[1]);
        tf32_split(g_hi[16 * i], gb[2], gs[2]);
        tf32_split(g_hi[16 * i + 8], gb[3], gs[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_3xtf32(seg[i][j], gb, gs, ab[j], as[j], rr == 0 ? zero : seg[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += seg[i][j][e];
    __syncthreads();
  }
  float s = 0.f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      for (int e = 0; e < 4; ++e) s += acc[i][j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename Kernel>
static double tflops(Kernel kernel, int blocks, int iters, double flops_per_iter_block,
                     int smem = 0) {
  float* out;
  cudaMalloc(&out, (size_t)blocks * 256 * sizeof(float));
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<blocks, 256, smem>>>(out, 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  kernel<<<blocks, 256, smem>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaFree(out);
  return flops_per_iter_block * iters * blocks / (ms * 1e-3) / 1e12;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const double warps = 8, chains_per_warp = 16;
  printf("mma.sync m16n8k8 tf32, 16 chains a warp, 8 warps an SM: %.1f TFLOP/s\n",
         tflops(chains<false>, sms, 4096, 2.0 * 16 * 8 * 8 * chains_per_warp * warps));
  printf("mma.sync m16n8k16 bf16, 16 chains a warp, 8 warps an SM: %.1f TFLOP/s\n",
         tflops(chains<true>, sms, 4096, 2.0 * 16 * 8 * 16 * chains_per_warp * warps));
  printf("K4's 3xTF32 stage on a resident 64-row tile: %.1f TFLOP/s of TF32 products\n",
         tflops(wgrad_stage, sms, 1000, 2.0 * 128 * 128 * kRowsStage * 3,
                (int)(2 * kRowsStage * kLd * sizeof(float))));
  const cudaError_t err = cudaDeviceSynchronize();
  printf("status %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
