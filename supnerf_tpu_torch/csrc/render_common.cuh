// Shared device code of the two fused render kernels (render_fwd.cu,
// render_bwd.cu): the decoder weight table, the block-wide dense layer, the
// positional encoding and its chain rule.
//
// Block shape, common to both kernels: one block renders ONE ray of one
// object. Its S <= kRows samples are the rows of every activation matrix,
// which lives in shared memory (kRows x W floats, 64 KB at W = 256). 256
// threads = 8 warps; warp w owns rows 8w..8w+7 and lane l owns the columns
// l, l+32, l+64, ... of each layer's output, so every warp reads one
// activation value per row as a broadcast and 32 consecutive weights per
// column group as one coalesced 128-byte load.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace supnerf {

constexpr int kRows = 64;        // rows per block: the samples of one ray
constexpr int kThreads = 256;    // 8 warps x 8 rows
constexpr int kPeStride = 64;    // row stride of the point-encoding buffer
constexpr int kMaxDirPe = 64;    // direction encoding slots
constexpr float kEpsTrans = 1e-10f;
constexpr float kLastDelta = 1e10f;

// Pointers into the frozen decoder (all float32, row-major). The forward
// chain reads the (in, out) "kernel" layout; the transposed chain of the
// backward reads the (out, in) layout of torch.nn.Linear.weight, so both
// walk a contiguous row per reduction index. Field order must match
// supnerf_tpu_torch/ops/render.py:_DecoderPtrs.
struct DecoderWeights {
  const float* w_xyz;    // (d_xyz, W)
  const float* b_xyz;    // (W)
  const float* w_sh;     // (n_shape, W, W)
  const float* b_sh;     // (n_shape, W)
  const float* w_es;     // (W, W)
  const float* b_es;     // (W)
  const float* w_sg;     // (W)
  const float* b_sg;     // (1)
  const float* w_vd_a;   // (W, W)       viewdir layer, trunk rows
  const float* w_vd_b;   // (d_dir, W)   viewdir layer, direction-encoding rows
  const float* b_vd;     // (W)
  const float* w_tx;     // (n_tex, W, W)
  const float* b_tx;     // (n_tex, W)
  const float* w_r1;     // (W, W/2)
  const float* b_r1;     // (W/2)
  const float* w_r2;     // (W/2, 3)
  const float* b_r2;     // (3)
  const float* wt_xyz;   // (W, d_xyz)
  const float* wt_sh;    // (n_shape, W, W)
  const float* wt_es;    // (W, W)
  const float* wt_vd_a;  // (W, W)
  const float* wt_tx;    // (n_tex, W, W)
  const float* wt_r1;    // (W/2, W)
};

struct Dims {
  int B, R, S, W, n_shape, n_tex, l_xyz, l_dir;
};

static __device__ __forceinline__ int pe_width(int degree) { return 3 * (2 * degree + 1); }

// out[r][c] = act(sum_k in[r][k] * M[k][c] + bias[c]) for all kRows rows and
// c < N, with M row-major (K, N) in global memory (L2-resident: the whole
// decoder is 1.8 MB). NJ = ceil(N / 32) columns per lane. If mask is given,
// bit l of mask[r * NJ + j] records out[r][l + 32 j] > 0 — the ReLU pattern
// the backward needs, 2 KB per W = 256 layer instead of a 64 KB stash.
// Ends with __syncthreads(); the caller has synchronised `in`. Not inlined:
// each kernel calls it a dozen times, and inlining every call site of every
// width variant multiplies the compile time.
template <int NJ>
static __device__ __noinline__ void dense_t(const float* in, int in_stride, int K,
                        const float* __restrict__ M, int N, const float* bias,
                        float* out, int out_stride, bool relu, uint32_t* mask) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 8;
  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  const bool full = (N == 32 * NJ);
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = in[(r0 + i) * in_stride + k];
    float w[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      w[j] = (full || c < N) ? __ldg(M + (size_t)k * N + c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    const bool ok = full || c < N;
    const float b = (bias != nullptr && ok) ? bias[c] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = acc[i][j] + b;
      if (relu) v = fmaxf(v, 0.f);
      if (ok) out[(r0 + i) * out_stride + c] = v;
      if (mask != nullptr) {
        const uint32_t bits = __ballot_sync(0xffffffffu, ok && v > 0.f);
        if (lane == 0) mask[(r0 + i) * NJ + j] = bits;
      }
    }
  }
  __syncthreads();
}

// Runtime dispatch on the column count: N = W or W/2 with W in {64, 128,
// 256}, or the 63-wide point encoding (ops/render.py checks W).
static __device__ void dense(const float* in, int in_stride, int K, const float* M,
                             int N, const float* bias, float* out, int out_stride,
                             bool relu, uint32_t* mask) {
  const int nj = (N + 31) / 32;
  if (nj <= 1) dense_t<1>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask);
  else if (nj == 2) dense_t<2>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask);
  else if (nj <= 4) dense_t<4>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask);
  else dense_t<8>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask);
}

// buf[r][c] += vec[c] over all rows (the per-object latent of a shape or
// texture block, added before the block's matmul).
static __device__ void add_row_vector(float* buf, int stride, int N, const float* vec) {
  for (int e = threadIdx.x; e < kRows * N; e += kThreads) {
    const int r = e / N, c = e - r * N;
    buf[r * stride + c] += vec[c];
  }
  __syncthreads();
}

// buf[r][c] = 0 where the stashed ReLU output was not positive (the ReLU
// derivative applied to a cotangent in place).
static __device__ void apply_mask(float* buf, int stride, int N, const uint32_t* mask) {
  const int nj = (N + 31) / 32;
  for (int e = threadIdx.x; e < kRows * N; e += kThreads) {
    const int r = e / N, c = e - r * N;
    if (!((mask[r * nj + (c >> 5)] >> (c & 31)) & 1u)) buf[r * stride + c] = 0.f;
  }
  __syncthreads();
}

// Positional encoding [x, sin(2^i x), cos(2^i x)] in the frequency-major,
// coordinate-minor layout of models/nerf_mlp.positional_encoding:
// pe[3 + 3i + c] = sin(2^i x_c), pe[3 + 3L + 3i + c] = cos(2^i x_c).
// 2^i x is exact in float32; sincosf is the accurate (not the fast-math)
// routine, needed because the top frequency reaches hundreds of radians.
static __device__ __forceinline__ void encode_one(const float x[3], int degree, float* pe) {
  pe[0] = x[0]; pe[1] = x[1]; pe[2] = x[2];
  for (int i = 0; i < degree; ++i) {
    const float f = (float)(1 << i);
    for (int c = 0; c < 3; ++c) {
      float s, co;
      sincosf(x[c] * f, &s, &co);
      pe[3 + 3 * i + c] = s;
      pe[3 + 3 * degree + 3 * i + c] = co;
    }
  }
}

// Encodes the S points of one ray into pe (kRows x kPeStride); rows >= S are
// zero so that the padded rows of every layer stay finite.
static __device__ void encode_points(const float* xyz, int S, int degree, float* pe) {
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    float* row = pe + r * kPeStride;
    if (r < S) {
      const float x[3] = {xyz[3 * r], xyz[3 * r + 1], xyz[3 * r + 2]};
      encode_one(x, degree, row);
    } else {
      for (int k = 0; k < kPeStride; ++k) row[k] = 0.f;
    }
  }
}

// Chain rule of the encoding on the values it produced:
// dx_c = g[c] + sum_i 2^i (cos(2^i x_c) g_sin[i][c] - sin(2^i x_c) g_cos[i][c]).
static __device__ __forceinline__ void encode_backward_one(const float* pe, const float* g,
                                                    int degree, float dx[3]) {
  for (int c = 0; c < 3; ++c) {
    float d = g[c];
    for (int i = 0; i < degree; ++i) {
      const float s = pe[3 + 3 * i + c], co = pe[3 + 3 * degree + 3 * i + c];
      const float gs = g[3 + 3 * i + c], gc = g[3 + 3 * degree + 3 * i + c];
      d += (float)(1 << i) * (co * gs - s * gc);
    }
    dx[c] = d;
  }
}

static __device__ __forceinline__ float softplus(float x) {
  // log(1 + e^x) in the overflow-free form of jax.nn.softplus
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per-row dot products against one or three weight columns (the sigma head
// (W -> 1) and the rgb head (W/2 -> 3)): warp w takes rows 8w..8w+7, lanes
// stride the reduction. M is (K, ncols) row-major.
static __device__ void head(const float* in, int stride, int K, const float* __restrict__ M,
                     int ncols, const float* __restrict__ bias, float* out) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 8;
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + i;
    for (int c = 0; c < ncols; ++c) {
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s = fmaf(in[r * stride + k], __ldg(M + k * ncols + c), s);
      s = warp_sum(s);
      if (lane == 0) out[r * ncols + c] = s + __ldg(bias + c);
    }
  }
  __syncthreads();
}

// The per-ray direction term of the viewdir layer, dpe @ Wvd_b + b_vd: the
// direction is constant along a ray, so it is computed once per block and
// used as the bias of the viewdir layer (the Pallas kernel's per-ray dir-PE).
static __device__ void direction_term(const float* vd, int degree, const DecoderWeights& w,
                               int W, float* dpe, float* hdir) {
  if (threadIdx.x == 0) {
    const float x[3] = {vd[0], vd[1], vd[2]};
    encode_one(x, degree, dpe);
  }
  __syncthreads();
  const int d_dir = pe_width(degree);
  for (int n = threadIdx.x; n < W; n += kThreads) {
    float s = w.b_vd[n];
    for (int k = 0; k < d_dir; ++k) s = fmaf(dpe[k], __ldg(w.w_vd_b + k * W + n), s);
    hdir[n] = s;
  }
  __syncthreads();
}

}  // namespace supnerf
