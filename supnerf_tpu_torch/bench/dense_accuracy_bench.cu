// Accuracy of the dense-layer arithmetics a decoder kernel can use, on one
// card, with no PyTorch:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o dense_accuracy_bench supnerf_tpu_torch/bench/dense_accuracy_bench.cu \
//        && ./dense_accuracy_bench
// One decoder-like layer, pre = x @ M for 65,536 rows: x ReLU outputs
// (max(N(0, 1), 0)), M (256, 256) uniform in +-1/16, from a fixed hash.
// Each arithmetic's result is held against a float64 evaluation: per output
// the error relative to its row's largest |pre| (the scale of the kink
// margin in chip_smoke.py, KINK_RTOL), and the outputs whose sign differs
// from float64's (a ReLU gate on the other side). Arithmetics:
//   fma        float32 FMAs in reduction order (the CUDA-core kernels);
//   3xtf32_k8  render_common.cuh:dense_mma (tf32.cuh's split, three
//              m16n8k8 TF32 mma.sync from zero per k-step of 8, the step
//              sum added in float32);
//   3xtf32_k4  the same with m16n8k4 (4 products a tensor-core sum);
//   6xbf16     each operand split into three bf16 pieces (8 significant
//              bits each), the six products down to 2^-16 of the largest
//              from zero per k-step of 16 on m16n8k16 bf16 mma.sync (each
//              product exact in 16 bits), the step sum added in float32.
// Prints one line per arithmetic.
#include <cstdint>
#include <cstdio>
#include <cmath>
#include <vector>
#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../csrc/tf32.cuh"

using namespace supnerf;

constexpr int kRowsAll = 65536, kK = 256, kN = 256;

__device__ __forceinline__ uint32_t hash(uint32_t x) {
  x ^= x >> 16; x *= 0x7feb352du; x ^= x >> 15; x *= 0x846ca68bu; x ^= x >> 16;
  return x;
}
__device__ __forceinline__ float uniform(uint32_t i, uint32_t salt) {
  return (hash(i * 2654435761u + salt) >> 8) * (1.0f / 16777216.0f);
}

__global__ void fill(float* x, float* M) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i < (size_t)kRowsAll * kK) {
    const float u1 = fmaxf(uniform(i, 1u), 1e-7f), u2 = uniform(i, 2u);
    x[i] = fmaxf(sqrtf(-2.f * logf(u1)) * cosf(6.2831853f * u2), 0.f);
  }
  if (i < (size_t)kK * kN) M[i] = (2.f * uniform(i, 3u) - 1.f) / 16.f;
}

__global__ void ref64(const float* x, const float* M, double* out) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= (size_t)kRowsAll * kN) return;
  const int r = i / kN, c = i % kN;
  double s = 0.0;
  for (int k = 0; k < kK; ++k) s = fma((double)x[(size_t)r * kK + k], (double)M[k * kN + c], s);
  out[i] = s;
}

__global__ void fma32(const float* x, const float* M, float* out) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= (size_t)kRowsAll * kN) return;
  const int r = i / kN, c = i % kN;
  float s = 0.f;
  for (int k = 0; k < kK; ++k) s = fmaf(x[(size_t)r * kK + k], M[k * kN + c], s);
  out[i] = s;
}

// one warp per 16 x 8 output tile
__global__ void tf32_k8(const float* x, const float* M, float* out) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int tile = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int r0 = (tile / (kN / 8)) * 16, c0 = (tile % (kN / 8)) * 8;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < kK; k0 += 8) {
    uint32_t ab[4], as[4], bb[2], bs[2];
    const float* lo = x + (size_t)(r0 + gid) * kK + k0 + tig;
    const float* hi = lo + 8 * kK;
    tf32_split(lo[0], ab[0], as[0]);
    tf32_split(hi[0], ab[1], as[1]);
    tf32_split(lo[4], ab[2], as[2]);
    tf32_split(hi[4], ab[3], as[3]);
    tf32_split(M[(k0 + tig) * kN + c0 + gid], bb[0], bs[0]);
    tf32_split(M[(k0 + tig + 4) * kN + c0 + gid], bb[1], bs[1]);
    float p[4];
    mma_3xtf32(p, ab, as, bb, bs, zero);
    for (int e = 0; e < 4; ++e) acc[e] += p[e];
  }
  for (int e = 0; e < 4; ++e)
    out[(size_t)(r0 + gid + (e >> 1) * 8) * kN + c0 + 2 * tig + (e & 1)] = acc[e];
}

__device__ __forceinline__ void mma_k4(float d[4], uint32_t a0, uint32_t a1, uint32_t b,
                                       const float c[4]) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%7,%8,%9,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

__global__ void tf32_k4(const float* x, const float* M, float* out) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int tile = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int r0 = (tile / (kN / 8)) * 16, c0 = (tile % (kN / 8)) * 8;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < kK; k0 += 4) {
    uint32_t ab0, as0, ab1, as1, bb, bs;
    tf32_split(x[(size_t)(r0 + gid) * kK + k0 + tig], ab0, as0);
    tf32_split(x[(size_t)(r0 + gid + 8) * kK + k0 + tig], ab1, as1);
    tf32_split(M[(k0 + tig) * kN + c0 + gid], bb, bs);
    float p[4];
    mma_k4(p, as0, as1, bb, zero);
    mma_k4(p, ab0, ab1, bs, p);
    mma_k4(p, ab0, ab1, bb, p);
    for (int e = 0; e < 4; ++e) acc[e] += p[e];
  }
  for (int e = 0; e < 4; ++e)
    out[(size_t)(r0 + gid + (e >> 1) * 8) * kN + c0 + 2 * tig + (e & 1)] = acc[e];
}

// x = h + m + l, three bf16 pieces rounded to nearest
__device__ __forceinline__ void bf16_split3(float x, float p[3]) {
  p[0] = __bfloat162float(__float2bfloat16_rn(x));
  const float r = x - p[0];
  p[1] = __bfloat162float(__float2bfloat16_rn(r));
  p[2] = __bfloat162float(__float2bfloat16_rn(r - p[1]));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2],
                                         const float c[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%11,%12,%13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

__global__ void bf16x6(const float* x, const float* M, float* out) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int tile = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int r0 = (tile / (kN / 8)) * 16, c0 = (tile % (kN / 8)) * 8;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < kK; k0 += 16) {
    // A: (row gid | gid + 8) x (cols 2 tig, 2 tig + 1 | + 8), B: k 2 tig, 2 tig + 1 | + 8
    float a[8][3], b[4][3];
    const int rr[4] = {gid, gid + 8, gid, gid + 8}, kk[4] = {0, 0, 8, 8};
    for (int q = 0; q < 4; ++q)
      for (int h = 0; h < 2; ++h)
        bf16_split3(x[(size_t)(r0 + rr[q]) * kK + k0 + 2 * tig + kk[q] + h], a[2 * q + h]);
    for (int q = 0; q < 2; ++q)
      for (int h = 0; h < 2; ++h)
        bf16_split3(M[(k0 + 2 * tig + 8 * q + h) * kN + c0 + gid], b[2 * q + h]);
    uint32_t A[3][4], Bf[3][2];
    for (int s = 0; s < 3; ++s) {
      for (int q = 0; q < 4; ++q) A[s][q] = pack(a[2 * q][s], a[2 * q + 1][s]);
      for (int q = 0; q < 2; ++q) Bf[s][q] = pack(b[2 * q][s], b[2 * q + 1][s]);
    }
    // smallest products first: l*h + m*m + h*l, then m*h + h*m, then h*h
    const int order[6][2] = {{2, 0}, {1, 1}, {0, 2}, {1, 0}, {0, 1}, {0, 0}};
    float p[4] = {0.f, 0.f, 0.f, 0.f};
    for (int o = 0; o < 6; ++o) mma_bf16(p, A[order[o][0]], Bf[order[o][1]], o ? p : zero);
    for (int e = 0; e < 4; ++e) acc[e] += p[e];
  }
  for (int e = 0; e < 4; ++e)
    out[(size_t)(r0 + gid + (e >> 1) * 8) * kN + c0 + 2 * tig + (e & 1)] = acc[e];
}

int main() {
  const size_t nx = (size_t)kRowsAll * kK, nout = (size_t)kRowsAll * kN;
  float *x, *M, *out;
  double* ref;
  cudaMalloc(&x, nx * 4);
  cudaMalloc(&M, kK * kN * 4);
  cudaMalloc(&out, nout * 4);
  cudaMalloc(&ref, nout * 8);
  fill<<<(nx + 255) / 256, 256>>>(x, M);
  ref64<<<(nout + 255) / 256, 256>>>(x, M, ref);
  std::vector<double> r(nout);
  std::vector<float> g(nout);
  cudaMemcpy(r.data(), ref, nout * 8, cudaMemcpyDeviceToHost);
  std::vector<double> scale(kRowsAll, 0.0);
  for (size_t i = 0; i < nout; ++i) scale[i / kN] = std::max(scale[i / kN], std::fabs(r[i]));
  const int tiles = (kRowsAll / 16) * (kN / 8);
  const char* names[4] = {"fma", "3xtf32_k8", "3xtf32_k4", "6xbf16"};
  for (int m = 0; m < 4; ++m) {
    if (m == 0) fma32<<<(nout + 255) / 256, 256>>>(x, M, out);
    if (m == 1) tf32_k8<<<tiles / 8, 256>>>(x, M, out);
    if (m == 2) tf32_k4<<<tiles / 8, 256>>>(x, M, out);
    if (m == 3) bf16x6<<<tiles / 8, 256>>>(x, M, out);
    cudaError_t err = cudaDeviceSynchronize();
    if (err != cudaSuccess) {
      printf("%s: CUDA error %d\n", names[m], (int)err);
      return 1;
    }
    cudaMemcpy(g.data(), out, nout * 4, cudaMemcpyDeviceToHost);
    double sum = 0.0, mx = 0.0;
    size_t flips = 0, over1 = 0, over3 = 0;
    for (size_t i = 0; i < nout; ++i) {
      const double e = std::fabs(g[i] - r[i]) / scale[i / kN];
      sum += e;
      mx = std::max(mx, e);
      over1 += e > 1e-7;
      over3 += e > 3e-8;
      flips += (g[i] > 0) != (r[i] > 0);
    }
    printf("%-10s mean %.3e  max %.3e  > 3e-8: %.4f  > 1e-7: %.5f  sign flips %zu of %zu\n",
           names[m], sum / nout, mx, (double)over3 / nout, (double)over1 / nout, flips, nout);
  }
  return 0;
}
