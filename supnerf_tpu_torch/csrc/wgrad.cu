// K4: the decoder weight gradients of the training backward, from K3's stash.
//
// Replaces, together with K3 (render_train_bwd.cu), the TPU kernel
// supnerf_tpu/ops/pallas_render.py:_render_train_bwd_kernel: there the 17
// weight/bias gradients are summed in VMEM-resident accumulators across a
// sequential grid (acc(..., first)); here they are a grouped, deterministic
// weight-gradient GEMM over the rows K3 stashed:
//   dW[n][col0 + k] (+)= sum_r A[r][k] G[r][n],   db[n] (+)= sum_r G[r][n]
// for every decoder layer at once (one "problem" per layer, at most
// kMaxProblems), written straight into torch.nn.Linear's (out, in) layout.
//
// Pass 1 (wgrad_kernel): each block owns a 64 x 64 tile of one problem's
// (K, N) product over one fixed slice of rows ("split"): 256 threads, each a
// 4 x 4 register tile, rows streamed through shared memory 16 at a time.
// Blocks with the first k-tile also sum G's columns for the bias. Each block
// writes its partial tile to a per-split buffer; no atomics.
// Pass 2 (wgrad_reduce_kernel): every output element sums its splits in
// split order and adds into (or overwrites) the Linear-layout gradient, so
// the result does not depend on scheduling: deterministic run to run.
//
// What bounds it on the H100: arithmetic. Per point the products are
// 2 x 0.44 M FLOP (the decoder's multiply-adds once more) against the 15.6 KB
// of stash read, ~60 FLOP per byte, above the float32 balance point of
// 67e12 / 3.35e12 = 20 FLOP/B. A simple float32 CUDA-core SGEMM: tensor
// cores (TF32 or bf16 operands, wgmma) and a persistent, pipelined version
// are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace supnerf {

constexpr int kTile = 64;          // output tile edge (k and n)
constexpr int kRowsStep = 16;      // rows per shared-memory stage
constexpr int kWgThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxProblems = 24;

// One layer's gradient. Field order must match
// supnerf_tpu_torch/ops/render.py:_WgradProblem. block0 / rblock0 are filled
// by the C entry.
struct WgradProblem {
  const float* A;      // (M, lda) layer inputs, K columns used
  const float* G;      // (M, ldg) pre-activation gradients, N columns used
  float* partial;      // (n_split, K + 1, N) scratch
  float* w_out;        // (N, ldw) Linear weight gradient, columns col0..col0+K-1
  float* b_out;        // (N) bias gradient or null
  int lda, ldg, M, K, N, ldw, col0, n_split, rows_per_split;
  int block0, rblock0;
};

struct WgradTable {
  WgradProblem p[kMaxProblems];
  int n;
};

static __device__ __forceinline__ int find_problem(const WgradTable& t, int block,
                                                   bool reduce) {
  int i = 0;
  while (i + 1 < t.n && block >= (reduce ? t.p[i + 1].rblock0 : t.p[i + 1].block0)) ++i;
  return i;
}

__global__ void __launch_bounds__(kWgThreads)
wgrad_kernel(const __grid_constant__ WgradTable tab) {
  __shared__ float As[kRowsStep][kTile];
  __shared__ float Gs[kRowsStep][kTile];
  const WgradProblem& P = tab.p[find_problem(tab, blockIdx.x, false)];
  const int tiles_k = (P.K + kTile - 1) / kTile, tiles_n = (P.N + kTile - 1) / kTile;
  const int local = blockIdx.x - P.block0;
  const int split = local / (tiles_k * tiles_n);
  const int kt = (local / tiles_n) % tiles_k, nt = local % tiles_n;
  const int k0 = kt * kTile, n0 = nt * kTile;
  const int r_begin = split * P.rows_per_split;
  const int r_end = min(P.M, r_begin + P.rows_per_split);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool do_bias = P.b_out != nullptr && kt == 0 && ty == 0;

  float acc[4][4];
  float bacc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bacc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int r0 = r_begin; r0 < r_end; r0 += kRowsStep) {
    for (int e = threadIdx.x; e < kRowsStep * kTile; e += kWgThreads) {
      const int rr = e / kTile, c = e % kTile;
      const int r = r0 + rr;
      const bool row_ok = r < r_end;
      As[rr][c] = (row_ok && k0 + c < P.K) ? P.A[(size_t)r * P.lda + k0 + c] : 0.f;
      Gs[rr][c] = (row_ok && n0 + c < P.N) ? P.G[(size_t)r * P.ldg + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsStep; ++rr) {
      float a[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[rr][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) g[j] = Gs[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
      if (do_bias) {
#pragma unroll
        for (int j = 0; j < 4; ++j) bacc[j] += g[j];
      }
    }
    __syncthreads();
  }
  float* out = P.partial + (size_t)split * (P.K + 1) * P.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (k < P.K && n < P.N) out[(size_t)k * P.N + n] = acc[i][j];
    }
  }
  if (do_bias) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < P.N) out[(size_t)P.K * P.N + n] = bacc[j];
    }
  }
}

__global__ void __launch_bounds__(kWgThreads)
wgrad_reduce_kernel(const __grid_constant__ WgradTable tab, int accumulate) {
  const WgradProblem& P = tab.p[find_problem(tab, blockIdx.x, true)];
  const int rows = P.b_out != nullptr ? P.K + 1 : P.K;
  const int e = (blockIdx.x - P.rblock0) * kWgThreads + threadIdx.x;
  if (e >= rows * P.N) return;
  const size_t stride = (size_t)(P.K + 1) * P.N;
  float s = 0.f;
  for (int sp = 0; sp < P.n_split; ++sp) s += P.partial[sp * stride + e];
  const int k = e / P.N, n = e - k * P.N;
  float* o = k < P.K ? P.w_out + (size_t)n * P.ldw + P.col0 + k : P.b_out + n;
  *o = accumulate ? *o + s : s;
}

}  // namespace supnerf

// Plain C entry, bound with ctypes: both passes on `stream` for n problems;
// returns cudaGetLastError() (0 on success, or cudaErrorInvalidValue for a
// table that does not fit); never synchronises or allocates.
extern "C" int supnerf_wgrad(const supnerf::WgradProblem* problems, int n, int accumulate,
                             void* stream) {
  using namespace supnerf;
  if (n < 1 || n > kMaxProblems) return (int)cudaErrorInvalidValue;
  WgradTable t;
  t.n = n;
  int blocks = 0, rblocks = 0;
  for (int i = 0; i < n; ++i) {
    WgradProblem p = problems[i];
    p.block0 = blocks;
    p.rblock0 = rblocks;
    blocks += ((p.K + kTile - 1) / kTile) * ((p.N + kTile - 1) / kTile) * p.n_split;
    rblocks += ((p.K + 1) * p.N + kWgThreads - 1) / kWgThreads;
    t.p[i] = p;
  }
  wgrad_kernel<<<blocks, kWgThreads, 0, (cudaStream_t)stream>>>(t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wgrad_reduce_kernel<<<rblocks, kWgThreads, 0, (cudaStream_t)stream>>>(t, accumulate);
  return (int)cudaGetLastError();
}
