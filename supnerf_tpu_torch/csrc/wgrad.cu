// K4: the decoder weight gradients of the training backward, from K3's or
// K7's stash.
//
// Replaces, together with K3 (render_train_bwd.cu), the TPU kernel
// supnerf_tpu/ops/pallas_render.py:_render_train_bwd_kernel, and together
// with K7 (field_train_bwd.cu) supnerf_tpu/ops/pallas_field.py:
// _field_train_bwd_kernel: there the 17 weight/bias gradients are summed in
// VMEM-resident accumulators across a sequential grid (acc(..., first));
// here they are a grouped, deterministic weight-gradient GEMM over the rows
// K3 or K7 stashed:
//   dW[n][col0 + k] (+)= sum_r A[r][k] G[r][n],   db[n] (+)= sum_r G[r][n]
// for every decoder layer at once (one "problem" per layer, at most
// kMaxProblems), written straight into torch.nn.Linear's (out, in) layout.
//
// What bounds it on the H100: at the training shape (8 x 1024 x 64 points,
// W 256) the products are 4.6e11 FLOP against 8.2 GB of stash. On the
// tensor cores at float32 accuracy (3xTF32, three TF32 products per
// product: tf32.cuh) that is 2.8 ms of operations against 2.4 ms of bytes,
// so the kernel must read each stash row from device memory about once and
// keep the tensor cores fed.
//
// Pass 1 (wgrad_kernel): each block owns a 128 (n) x 128 (k) tile of one
// problem's product over one fixed slice of rows (a "split"). 8 warps, each
// a 64 x 32 sub-tile of m16n8k8 TF32 mma.sync tiles, three passes each.
// Rows stream through a 3-stage ring of 64-row stages in shared memory,
// filled by 16-byte cp.async copies issued between the mma of the stage
// before (each thread's copy plan is fixed per block) (the stash's column blocks start on 16
// bytes: ops/render.stash_layout) with zero fill past the rows and columns
// of the problem, so the small problems (N 1 and 3, K 27 and 63) run the
// same code with masked tails; a warp skips the mma tiles that lie wholly
// outside the problem. The stage rows have a stride of 136 floats (8 mod
// 32), so every fragment load hits 32 distinct banks. The tensor core's
// float32 accumulation is not rounded to nearest, so each stage's products
// are summed in their own registers and then added to the block's sums with
// float32 adds. Blocks of the first k-tile also sum G's columns for the bias
// in float32, in a fixed order. A block's k-tiles and n-tiles of one split
// are adjacent in the grid, so the second read of a row slice is served by
// L2. Each block writes its partial tile to a per-split buffer; no atomics.
// Pass 2 (wgrad_reduce_kernel): every output element sums its splits in
// split order and adds into (or overwrites) the Linear-layout gradient, so
// the result does not depend on scheduling: the same bits run to run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tf32.cuh"

namespace supnerf {

constexpr int kTileN = 128;        // output rows (n) of a block
constexpr int kTileK = 128;        // output columns (k) of a block
constexpr int kStageRows = 64;     // stash rows per stage (ops/render.py:WGRAD_STAGE_ROWS)
constexpr int kStages = 3;         // stages in the ring
constexpr int kLd = 136;           // row stride of a stage's tiles, 8 mod 32
constexpr int kStageFloats = 2 * kStageRows * kLd;   // A tile, then G tile
constexpr int kWgThreads = 256;   // 8 warps, 2 (n) x 4 (k), 64 x 32 each
constexpr int kMaxProblems = 24;
constexpr size_t kWgradSmem = sizeof(float) * ((size_t)kStages * kStageFloats + kWgThreads);

// One layer's gradient. Field order must match
// supnerf_tpu_torch/ops/render.py:_WgradProblem. block0 / rblock0 are filled
// by the C entry.
struct WgradProblem {
  const float* A;      // (M, lda) layer inputs, K columns used; 16-byte rows
  const float* G;      // (M, ldg) pre-activation gradients, N columns used; 16-byte rows
  float* partial;      // (n_split, N, K + 1) scratch; column K holds the bias sums
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

// A thread's share of filling a stage: rows r0 + row0 + 4 i (i < 16) of
// one 16-byte column chunk of A's columns k0..k0+127 or G's n0..n0+127;
// rows at or past r_end and columns past K or N are zero. The chunk is fixed
// per thread (even warps copy A, odd warps G, one 512-byte row segment per
// warp and copy), so only the row advances.
struct CopyPlan {
  const float* src;   // the chunk in row r_begin + row0
  size_t ld;          // row stride of the source
  int dst;            // float offset of the chunk in a stage, row row0
  int row0, bytes;    // bytes: 16, fewer at the problem's last column, 0 past it
};

static __device__ __forceinline__ CopyPlan copy_plan(const WgradProblem& P, int r_begin, int k0,
                                                     int n0) {
  const int row0 = threadIdx.x >> 6, c = threadIdx.x & 63;
  const bool is_g = c >= 32;
  const int col = (c & 31) * 4, first = (is_g ? n0 : k0) + col, width = is_g ? P.N : P.K;
  CopyPlan cp;
  cp.ld = (size_t)(is_g ? P.ldg : P.lda);
  cp.row0 = row0;
  cp.bytes = first < width ? 4 * min(4, width - first) : 0;
  cp.src = (is_g ? P.G : P.A) + (cp.bytes ? (size_t)(r_begin + row0) * cp.ld + first : 0);
  cp.dst = (is_g ? kStageRows * kLd : 0) + row0 * kLd + col;
  return cp;
}

// copies i0 and i0 + 1 (of 16) of the stage of rows r0.. into `stage`
static __device__ __forceinline__ void copy_pair(const CopyPlan& cp, float* stage, int r0,
                                                 int r_begin, int r_end, int i0) {
#pragma unroll
  for (int i = i0; i < i0 + 2; ++i) {
    const int dr = r0 - r_begin + cp.row0 + 4 * i;        // row offset from the plan's row
    const bool ok = cp.bytes && r_begin + dr < r_end;
    cp_async<16>(stage + cp.dst + 4 * i * kLd,
                 ok ? cp.src + (size_t)(dr - cp.row0) * cp.ld : cp.src, ok ? cp.bytes : 0);
  }
}

// One stage's products of this warp's 64 (n) x 32 (k) sub-tile: per m16n8k8
// tile the stage's 64 rows summed on the tensor cores (3xTF32, 24 mma), then
// added to acc with float32 adds. kMasked skips the tiles outside the
// problem (m_on, k_on); without it every tile is computed, with no branch
// between the mma so that they can be scheduled freely. copy(i0) is called
// once per k-step (i0 = 0, 2, .., 14) to issue that share of the next stage's
// copies.
template <bool kMasked, typename Copy>
static __device__ __forceinline__ void stage_products(const float* As, const float* Gs, int wn,
                                                      int wk, const bool m_on[4],
                                                      const bool k_on[4], float acc[4][4][4],
                                                      Copy&& copy) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float seg[4][4][4];
#pragma unroll
  for (int rr = 0; rr < kStageRows; rr += 8) {
    // mma A operand: G^T (n x r); B operand: A (r x k)
    const float* g_lo = Gs + (rr + tig) * kLd + wn + gid;
    const float* g_hi = g_lo + 4 * kLd;
    const float* a_lo = As + (rr + tig) * kLd + wk + gid;
    const float* a_hi = a_lo + 4 * kLd;
    uint32_t ab_big[4][2], ab_small[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      tf32_split(a_lo[8 * j], ab_big[j][0], ab_small[j][0]);
      tf32_split(a_hi[8 * j], ab_big[j][1], ab_small[j][1]);
    }
    copy(rr / 4);      // a quarter of the next stage's copies, between the mma
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kMasked && !m_on[i]) continue;
      uint32_t ga_big[4], ga_small[4];
      tf32_split(g_lo[16 * i], ga_big[0], ga_small[0]);
      tf32_split(g_lo[16 * i + 8], ga_big[1], ga_small[1]);
      tf32_split(g_hi[16 * i], ga_big[2], ga_small[2]);
      tf32_split(g_hi[16 * i + 8], ga_big[3], ga_small[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (!kMasked || k_on[j])
          mma_3xtf32(seg[i][j], ga_big, ga_small, ab_big[j], ab_small[j],
                     rr == 0 ? zero : seg[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (!kMasked || (m_on[i] && k_on[j]))
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += seg[i][j][e];
}

__global__ void __launch_bounds__(kWgThreads, 1)
wgrad_kernel(const __grid_constant__ WgradTable tab) {
  extern __shared__ float smem[];
  float* bias_red = smem + kStages * kStageFloats;    // kWgThreads floats
  const WgradProblem& P = tab.p[find_problem(tab, blockIdx.x, false)];
  const int tiles_k = (P.K + kTileK - 1) / kTileK, tiles_n = (P.N + kTileN - 1) / kTileN;
  const int local = blockIdx.x - P.block0;
  const int split = local / (tiles_k * tiles_n);
  const int nt = (local / tiles_k) % tiles_n, kt = local % tiles_k;
  const int k0 = kt * kTileK, n0 = nt * kTileN;
  const int r_begin = split * P.rows_per_split;
  const int r_end = min(P.M, r_begin + P.rows_per_split);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wn = (warp & 1) * 64, wk = (warp >> 1) * 32;   // this warp's sub-tile
  const bool do_bias = P.b_out != nullptr && kt == 0;
  // mma tiles wholly outside the problem are skipped (warp-uniform); a tile
  // wholly inside takes the path without tests
  bool m_on[4], k_on[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_on[i] = n0 + wn + 16 * i < P.N;
    k_on[i] = k0 + wk + 8 * i < P.K;
  }
  const bool full = n0 + kTileN <= P.N && k0 + kTileK <= P.K;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float bsum = 0.f;

  const int n_steps = (r_end - r_begin + kStageRows - 1) / kStageRows;
  const CopyPlan plan = copy_plan(P, r_begin, k0, n0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps)
#pragma unroll
      for (int i0 = 0; i0 < 16; i0 += 2)
        copy_pair(plan, smem + s * kStageFloats, r_begin + s * kStageRows, r_begin, r_end, i0);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();        // stage `step` has arrived; stage step - 1's slot is free
    const int next = step + kStages - 1;
    float* next_slot = smem + (next % kStages) * kStageFloats;
    auto copy = [&](int i0) {
      if (next < n_steps)
        copy_pair(plan, next_slot, r_begin + next * kStageRows, r_begin, r_end, i0);
    };
    const float* As = smem + (step % kStages) * kStageFloats;
    const float* Gs = As + kStageRows * kLd;
    if (full) stage_products<false>(As, Gs, wn, wk, m_on, k_on, acc, copy);
    else stage_products<true>(As, Gs, wn, wk, m_on, k_on, acc, copy);
    cp_async_commit();
    if (do_bias) {     // thread t: column t % 128, rows 32 (t / 128) .. + 31
      const float* g = Gs + (threadIdx.x >> 7) * 32 * kLd + (threadIdx.x & 127);
#pragma unroll
      for (int r = 0; r < 32; ++r) bsum += g[r * kLd];
    }
  }
  cp_async_wait<0>();

  float* out = P.partial + (size_t)split * P.N * (P.K + 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + 16 * i + gid, k = k0 + wk + 8 * j + 2 * tig;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int nn = n + (e >> 1) * 8, kk = k + (e & 1);
        if (nn < P.N && kk < P.K) out[(size_t)nn * (P.K + 1) + kk] = acc[i][j][e];
      }
    }
  }
  if (do_bias) {
    bias_red[threadIdx.x] = bsum;
    __syncthreads();
    const int n = n0 + threadIdx.x;
    if (threadIdx.x < kTileN && n < P.N)
      out[(size_t)n * (P.K + 1) + P.K] = bias_red[threadIdx.x] + bias_red[threadIdx.x + kTileN];
  }
}

__global__ void __launch_bounds__(kWgThreads)
wgrad_reduce_kernel(const __grid_constant__ WgradTable tab, int accumulate) {
  const WgradProblem& P = tab.p[find_problem(tab, blockIdx.x, true)];
  const int cols = P.K + 1;
  const int e = (blockIdx.x - P.rblock0) * kWgThreads + threadIdx.x;
  if (e >= P.N * cols) return;
  const int n = e / cols, k = e - n * cols;
  if (k == P.K && P.b_out == nullptr) return;
  const size_t stride = (size_t)P.N * cols;
  float s = 0.f;
  for (int sp = 0; sp < P.n_split; ++sp) s += P.partial[sp * stride + e];
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
    blocks += ((p.K + kTileK - 1) / kTileK) * ((p.N + kTileN - 1) / kTileN) * p.n_split;
    rblocks += (p.N * (p.K + 1) + kWgThreads - 1) / kWgThreads;
    t.p[i] = p;
  }
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kWgradSmem);
  if (err != cudaSuccess) return (int)err;
  wgrad_kernel<<<blocks, kWgThreads, kWgradSmem, (cudaStream_t)stream>>>(t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wgrad_reduce_kernel<<<rblocks, kWgThreads, 0, (cudaStream_t)stream>>>(t, accumulate);
  return (int)cudaGetLastError();
}
