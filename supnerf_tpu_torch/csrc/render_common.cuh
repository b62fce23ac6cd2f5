// Shared device code of the decoder kernels (render_fwd.cu, render_bwd.cu,
// render_train_bwd.cu, field_fwd.cu, field_bwd.cu, field_train_bwd.cu): the
// decoder weight table, the block-wide dense layer, the positional encoding
// and its chain rule, the compositing VJP, the data cotangents of the
// backward kernels, the training stash's layout and the per-point field
// backward kernel that K6 and K7 share.
//
// Block shape, common to all of them: one block holds kRows points of one
// object, the samples of ONE ray in the render kernels, 64 consecutive
// points in the per-point field kernels. They are the rows of every
// activation matrix,
// which lives in shared memory (kRows x W floats, 64 KB at W = 256). 256
// threads = 8 warps. In `dense` (float32 FMAs on the CUDA cores) warp w owns
// rows 8w..8w+7 and lane l owns the columns l, l+32, l+64, ... of each
// layer's output, so every warp reads one activation value per row as a
// broadcast and 32 consecutive weights per column group as one coalesced
// 128-byte load. `dense_mma` (K2's layers: 3xTF32 on the tensor cores) splits
// the output columns across the warps instead.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tf32.cuh"

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
// With accumulate, out's old values are added before the activation
// (out = act(in @ M + bias + out); `in` must not alias `out`): each thread
// reads only the elements it writes.
// Ends with __syncthreads(); the caller has synchronised `in`. Not inlined:
// each kernel calls it a dozen times, and inlining every call site of every
// width variant multiplies the compile time.
template <int NJ>
static __device__ __noinline__ void dense_t(const float* in, int in_stride, int K,
                        const float* __restrict__ M, int N, const float* bias,
                        float* out, int out_stride, bool relu, uint32_t* mask,
                        bool accumulate) {
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
      if (accumulate && ok) v += out[(r0 + i) * out_stride + c];
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
                             bool relu, uint32_t* mask, bool accumulate = false) {
  const int nj = (N + 31) / 32;
  if (nj <= 1) dense_t<1>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask, accumulate);
  else if (nj == 2) dense_t<2>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask, accumulate);
  else if (nj <= 4) dense_t<4>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask, accumulate);
  else dense_t<8>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask, accumulate);
}

// Row stride padding of activation buffers read by dense_mma: a stride of 4
// mod 32 floats puts the 32 A-fragment loads of a warp on 32 distinct banks.
constexpr int kMmaPad = 4;
// dense_mma's weight staging: per warp a ring of kBStages k-steps (8 rows
// of the warp's columns, kBLd floats a row: 8 mod 32, so the B-fragment
// loads hit 32 distinct banks); kMmaStageFloats for the whole block.
constexpr int kBStages = 6;
constexpr int kBLd = 40;
constexpr int kMmaStageFloats = kThreads / 32 * kBStages * 8 * kBLd;

// dense_t's contract (out = act(in @ M + bias [+ out]) on all kRows rows,
// the ReLU bit masks, ends with __syncthreads()) on the tensor cores at
// float32 accuracy (3xTF32, tf32.cuh). The output columns are split across
// the warps: warp w owns the NT 8-column tiles w*NT .. w*NT+NT-1 for all
// 64 rows (4 x NT m16n8k8 tiles), so each weight element enters the SM once
// per block. A fragments are read from `in` in shared memory (a row stride
// of 4 mod 32 avoids bank conflicts; kMmaPad). The warp's slice of the
// weights streams through its own ring of kBStages k-steps in shared
// memory (`stage`, kMmaStageFloats for the block, 16-byte aligned), filled
// by cp.async (16-byte copies where N is a multiple of 4, else 4-byte
// ones) kBStages - 1 k-steps ahead, zero past K and N. Each k-step's
// products are summed on the tensor cores from zero and added to the output
// sums with float32 adds (tf32.cuh: the tensor core's
// accumulation truncates). Reduction indices past K (the 63-wide point
// encoding, whose stride-64 column 63 is never written) are masked on the A
// side too. The ReLU masks, in dense_t's layout, come from the registers
// where a warp owns whole 32-column words (NT 4), else from the stored
// outputs after a sync.
template <int NT>
static __device__ __noinline__ void dense_mma_t(const float* in, int in_stride, int K,
                                                const float* __restrict__ M, int N,
                                                const float* bias, float* out, int out_stride,
                                                bool relu, uint32_t* mask, bool accumulate,
                                                float* stage) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_tiles = (N + 7) >> 3;
  const int t0 = warp * NT;
  // A warp either owns NT whole tiles or none: n_tiles is 4, 8, 16 or 32
  // (N = 32, 63 or 64, 128, 256) and NT = ceil(n_tiles / 8).
  if (t0 < n_tiles) {                                // warp-uniform
    float* ring = stage + warp * kBStages * 8 * kBLd;
    const int c0 = t0 * 8, n_steps = (K + 7) >> 3;
    const bool vec = (N & 3) == 0;                   // M's rows start on 16 bytes
    // rows 8 step .. 8 step + 7 of M's columns c0 .. c0 + 8 NT - 1 into a slot
    auto fetch = [&](int step) {
      float* dst = ring + (step % kBStages) * 8 * kBLd;
      const int k0 = step * 8;
      if (vec) {
        for (int q = lane; q < 16 * NT; q += 32) {
          const int row = q / (2 * NT), col = (q % (2 * NT)) * 4;
          const bool ok = k0 + row < K && c0 + col < N;
          cp_async<16>(dst + row * kBLd + col, ok ? M + (size_t)(k0 + row) * N + c0 + col : M,
                       ok ? 16 : 0);
        }
      } else {
        for (int q = lane; q < 64 * NT; q += 32) {
          const int row = q / (8 * NT), col = q % (8 * NT);
          const bool ok = k0 + row < K && c0 + col < N;
          cp_async<4>(dst + row * kBLd + col, ok ? M + (size_t)(k0 + row) * N + c0 + col : M,
                      ok ? 4 : 0);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < kBStages - 1; ++s) {
      if (s < n_steps) fetch(s);
      cp_async_commit();
    }
    float acc[4][NT][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int step = 0; step < n_steps; ++step) {
      __syncwarp();                                  // the slot refilled here was read last step
      if (step + kBStages - 1 < n_steps) fetch(step + kBStages - 1);
      cp_async_commit();
      cp_async_wait<kBStages - 1>();
      __syncwarp();
      const float* b = ring + (step % kBStages) * 8 * kBLd + tig * kBLd + gid;
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        tf32_split(b[8 * t], bb[t][0], bs[t][0]);
        tf32_split(b[4 * kBLd + 8 * t], bb[t][1], bs[t][1]);
      }
      const int k0 = step * 8;
      const bool lo = k0 + tig < K, hi = k0 + tig + 4 < K;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* r_lo = in + (16 * i + gid) * in_stride + k0 + tig;
        const float* r_hi = r_lo + 8 * in_stride;
        uint32_t ab[4], as[4];
        tf32_split(lo ? r_lo[0] : 0.f, ab[0], as[0]);
        tf32_split(lo ? r_hi[0] : 0.f, ab[1], as[1]);
        tf32_split(hi ? r_lo[4] : 0.f, ab[2], as[2]);
        tf32_split(hi ? r_hi[4] : 0.f, ab[3], as[3]);
#pragma unroll
        for (int t = 0; t < NT; ++t) {     // this k-step's 8 products, then a float32 add
          float p[4];
          mma_3xtf32(p, ab, as, bb[t], bs[t], zero);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][t][e] += p[e];
        }
      }
    }
    cp_async_wait<0>();
    // with NT 4 the warp's 32 columns are mask word `warp` of every row: bit
    // 8 t + 2 tig + (e & 1) of bits[i][e >> 1] for this thread's values
    uint32_t bits[4][2] = {};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = (t0 + t) * 8 + 2 * tig;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * i + gid + (e >> 1) * 8, cc = c + (e & 1);
          if (cc >= N) continue;
          float v = acc[i][t][e] + (bias != nullptr ? bias[cc] : 0.f);
          if (accumulate) v += out[r * out_stride + cc];
          if (relu) v = fmaxf(v, 0.f);
          out[r * out_stride + cc] = v;
          if (NT == 4 && v > 0.f) bits[i][e >> 1] |= 1u << (8 * t + 2 * tig + (e & 1));
        }
    }
    if (NT == 4 && mask != nullptr) {   // OR the words over the 4 lanes of a row
      const int nj = (N + 31) / 32;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t w = bits[i][h];
          w |= __shfl_xor_sync(0xffffffffu, w, 1);
          w |= __shfl_xor_sync(0xffffffffu, w, 2);
          if (tig == 0) mask[(16 * i + gid + 8 * h) * nj + warp] = w;
        }
    }
  }
  __syncthreads();
  if (NT != 4 && mask != nullptr) {     // narrower layers: from the stored outputs
    const int nj = (N + 31) / 32;
    for (int q = warp; q < kRows * nj; q += kThreads / 32) {
      const int r = q / nj, c = 32 * (q - r * nj) + lane;
      const uint32_t bits = __ballot_sync(0xffffffffu, c < N && out[r * out_stride + c] > 0.f);
      if (lane == 0) mask[q] = bits;
    }
    __syncthreads();
  }
}

// Runtime dispatch on the column count: N up to 256, 8-column tiles spread
// over the 8 warps. `stage`: kMmaStageFloats of shared memory, 16-byte
// aligned.
static __device__ void dense_mma(const float* in, int in_stride, int K, const float* M, int N,
                                 const float* bias, float* out, int out_stride, bool relu,
                                 uint32_t* mask, float* stage, bool accumulate = false) {
  const int nt = ((N + 7) / 8 + 7) / 8;
  if (nt <= 1)
    dense_mma_t<1>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask, accumulate, stage);
  else if (nt == 2)
    dense_mma_t<2>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask, accumulate, stage);
  else
    dense_mma_t<4>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask, accumulate, stage);
}

// buf[r][c] += vec[c] over all rows (the per-object latent of a shape or
// texture block, added before the block's matmul). kRowwise (K2): a warp
// per row and no integer division; the other kernels keep the flat loop.
template <bool kRowwise = false>
static __device__ void add_row_vector(float* buf, int stride, int N, const float* vec) {
  if constexpr (kRowwise) {
    for (int r = threadIdx.x >> 5; r < kRows; r += kThreads / 32)
      for (int c = threadIdx.x & 31; c < N; c += 32) buf[r * stride + c] += vec[c];
  } else {
    for (int e = threadIdx.x; e < kRows * N; e += kThreads) {
      const int r = e / N, c = e - r * N;
      buf[r * stride + c] += vec[c];
    }
  }
  __syncthreads();
}

// buf[r][c] = 0 where the stashed ReLU output was not positive (the ReLU
// derivative applied to a cotangent in place). kRowwise as add_row_vector.
template <bool kRowwise = false>
static __device__ void apply_mask(float* buf, int stride, int N, const uint32_t* mask) {
  const int nj = (N + 31) / 32;
  if constexpr (kRowwise) {
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < kRows; r += kThreads / 32)
      for (int j = 0; j < nj; ++j) {
        const int c = 32 * j + lane;
        if (c < N && !((mask[r * nj + j] >> lane) & 1u)) buf[r * stride + c] = 0.f;
      }
  } else {
    for (int e = threadIdx.x; e < kRows * N; e += kThreads) {
      const int r = e / N, c = e - r * N;
      if (!((mask[r * nj + (c >> 5)] >> (c & 31)) & 1u)) buf[r * stride + c] = 0.f;
    }
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

// Encodes S <= kRows consecutive points (the samples of one ray, or a
// field kernel's block of points or directions) into pe (kRows x
// kPeStride); rows >= S are zero so that the padded rows of every layer stay
// finite. The caller synchronises before reading pe.
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

static __device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Column sums over the S real rows: the cotangent of a latent that was added
// to every row of a block's input.
static __device__ void column_sums(const float* buf, int stride, int N, int S, float* out) {
  for (int c = threadIdx.x; c < N; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < S; ++r) s += buf[r * stride + c];
    out[c] = s;
  }
  __syncthreads();
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

// Compositing replay and its manual VJP for one ray, run by ONE thread (the
// algebra of pallas_render.py:_render_bwd_kernel's docstring in stable
// product form; the only division is by a transmittance factor >= 1e-10).
// From the ray's S density logits and colours and its z row, with the
// cotangents g_rgb[3], gd (depth) and ga (acc_trans) of its outputs: dsig,
// the density's cotangent before the softplus gate, and drgb per sample,
// zero on rows S..kRows-1; with dz not null also the ray's z cotangent row,
// dz_s = g_depth w_s + ddelta_{s-1} - ddelta_s (delta_s = z_{s+1} - z_s).
// scratch: 4 x kRows floats.
static __device__ void composite_vjp(const float* logit, const float* rgb, const float* zr,
                                     int S, int white_bkgd, const float* g_rgb, float gd,
                                     float ga, float* scratch, float* dsig, float* drgb,
                                     float* dz) {
  float* alpha = scratch;
  float* T = alpha + kRows;
  float* wt = T + kRows;
  float* gw = wt + kRows;
  const float gr0 = g_rgb[0], gr1 = g_rgb[1], gr2 = g_rgb[2];
  const float gwhite = white_bkgd ? (gr0 + gr1 + gr2) : 0.f;
  float Tc = 1.f;
  for (int s = 0; s < S; ++s) {
    const float delta = (s < S - 1) ? zr[s + 1] - zr[s] : kLastDelta;
    const float a = 1.f - expf(-fmaxf(softplus(logit[s]), 0.f) * delta);
    alpha[s] = a;
    T[s] = Tc;
    wt[s] = a * Tc;
    gw[s] = gr0 * rgb[3 * s] + gr1 * rgb[3 * s + 1] + gr2 * rgb[3 * s + 2]
            + gd * zr[s] - gwhite;
    Tc *= fmaxf(1.f - a, 0.f) + kEpsTrans;
  }
  const float acc = T[S - 1];
  float suffix = 0.f;          // sum_{i > s} gw_i w_i
  for (int s = S - 1; s >= 0; --s) {
    const float sg = softplus(logit[s]);
    const float delta = (s < S - 1) ? zr[s + 1] - zr[s] : kLastDelta;
    const float tt = fmaxf(1.f - alpha[s], 0.f) + kEpsTrans;
    const float not_last = (s < S - 1) ? 1.f : 0.f;
    const float g_t = (suffix + ga * acc * not_last) / tt;
    const float de = g_t - gw[s] * T[s];
    const float e_val = 1.f - alpha[s];
    dsig[s] = (sg > 0.f) ? de * (-delta) * e_val : 0.f;
    if (dz != nullptr) {
      const float dd = de * (-fmaxf(sg, 0.f)) * e_val * not_last;
      // sample s + 1, written one step earlier, receives its ddelta_s here
      dz[s] = gd * wt[s] - dd;
      if (s + 1 < S) dz[s + 1] += dd;
    }
    suffix += gw[s] * wt[s];
    drgb[3 * s] = wt[s] * gr0;
    drgb[3 * s + 1] = wt[s] * gr1;
    drgb[3 * s + 2] = wt[s] * gr2;
  }
  for (int s = S; s < kRows; ++s) {
    dsig[s] = 0.f;
    drgb[3 * s] = drgb[3 * s + 1] = drgb[3 * s + 2] = 0.f;
  }
}

// The view direction's cotangent of a ray, whose direction encoding dpe is
// shared by its samples: (sum over the samples of g_v) @ Wvd_b^T, one warp
// per encoding column, then the encoding's chain rule. gv_sum holds the
// column sums of g_v (W floats); ddpe is kMaxDirPe floats of scratch.
// Thread 0 writes dvd[0..2]. Ends with __syncthreads().
static __device__ void ray_direction_cotangent(const float* gv_sum, const float* dpe,
                                               const DecoderWeights& w, int W, int l_dir,
                                               float* ddpe, float* dvd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d_dir = pe_width(l_dir);
  for (int k = warp; k < d_dir; k += kThreads / 32) {
    float s = 0.f;
    for (int n = lane; n < W; n += 32) s = fmaf(gv_sum[n], __ldg(w.w_vd_b + k * W + n), s);
    s = warp_sum(s);
    if (lane == 0) ddpe[k] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float dv[3];
    encode_backward_one(dpe, ddpe, l_dir, dv);
    dvd[0] = dv[0];
    dvd[1] = dv[1];
    dvd[2] = dv[2];
  }
  __syncthreads();
}

// out[r][k] = sum_c g[r][c] * M[k][c] for the n real rows and k < K, with M
// (K, N) row-major: a product with M's transpose, one warp per (row, k)
// pair, lanes striding c. out has row stride kPeStride.
static __device__ void rows_times_transpose(const float* g, int N, int n,
                                            const float* __restrict__ M, int K, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < n * K; t += kThreads / 32) {
    const int r = t / K, k = t - r * K;
    float s = 0.f;
    for (int c = lane; c < N; c += 32) s = fmaf(g[r * N + c], __ldg(M + (size_t)k * N + c), s);
    s = warp_sum(s);
    if (lane == 0) out[r * kPeStride + k] = s;
  }
  __syncthreads();
}

// The view directions' cotangents of n points that each have their own
// direction encoding (rows of dpe, stride kPeStride): g_v @ Wvd_b^T per
// point into scratch (kRows x kPeStride floats), then the encoding's chain
// rule; dvd gets 3 floats per point. Ends with __syncthreads().
static __device__ void point_direction_cotangent(const float* g_v, const float* dpe,
                                                 const DecoderWeights& w, int W, int l_dir,
                                                 int n, float* scratch, float* dvd) {
  rows_times_transpose(g_v, W, n, w.w_vd_b, pe_width(l_dir), scratch);
  for (int r = threadIdx.x; r < n; r += kThreads) {
    float dv[3];
    encode_backward_one(dpe + r * kPeStride, scratch + r * kPeStride, l_dir, dv);
    float* o = dvd + r * 3;
    o[0] = dv[0]; o[1] = dv[1]; o[2] = dv[2];
  }
  __syncthreads();
}

// The encoding's chain rule on the point encodings pe for the n real rows,
// from the encodings' cotangents dpe (both kRows x kPeStride); dxyz gets 3
// floats per row.
static __device__ void encode_backward_rows(const float* pe, const float* dpe, int l_xyz, int n,
                                            float* dxyz) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    float dx[3];
    encode_backward_one(pe + r * kPeStride, dpe + r * kPeStride, l_xyz, dx);
    float* o = dxyz + r * 3;
    o[0] = dx[0]; o[1] = dx[1]; o[2] = dx[2];
  }
}

// The points' cotangents from the first layer's pre-activation gradient g
// (kRows x W, ReLU already applied): g @ Wxyz^T into scratch (kRows x
// kPeStride floats), then the encoding's chain rule on the point encodings
// pe; dxyz gets 3 floats for each of the n real rows.
static __device__ void point_cotangent(const float* g, const float* pe, const DecoderWeights& w,
                                       int W, int l_xyz, int n, float* scratch, float* dxyz) {
  dense(g, W, W, w.wt_xyz, pe_width(l_xyz), nullptr, scratch, kPeStride, false, nullptr);
  encode_backward_rows(pe, scratch, l_xyz, n, dxyz);
}

// ---- the training stash (render_train_bwd.cu K3, field_train_bwd.cu K7) ----

// Float offsets of the stash columns; field order must match
// supnerf_tpu_torch/ops/render.py:_StashLayout. Per point (row
// (obj * R + ray) * S + s of `pt` for K3, obj * M + point for K7): layer
// inputs a_* and pre-activation gradients g_*; a_sh, g_sh hold n_shape
// blocks of W, a_tx, g_tx n_tex. The viewdir layer's direction input is
// per ray in K3 (row obj * R + ray of `ray`: its encoding r_dpe and the
// ray's sum of g_v, r_gv) and per point in K7 (a_dpe; `ray` is unused).
struct StashLayout {
  float* pt;
  float* ray;
  int ld_pt, ld_ray;
  int a_xyz, a_sh, a_es, a_e, a_tx, a_r1, a_hh;
  int g_xyz, g_sh, g_e, g_sig, g_v, g_tx, g_hh, g_rgb;
  int r_dpe, r_gv, a_dpe;
};

// dst[r][c] = buf[r][c] for the n real rows and c < N (dst row stride ld).
static __device__ void store_rows(const float* buf, int stride, int N, int n, float* dst,
                                  int ld) {
  for (int e = threadIdx.x; e < n * N; e += kThreads) {
    const int r = e / N, c = e - r * N;
    dst[(size_t)r * ld + c] = buf[r * stride + c];
  }
  __syncthreads();
}

// ---- the per-point field backward (field_bwd.cu K6, field_train_bwd.cu K7) ----

// The backward of the per-point field, one block per kRows = 64 points of
// object blockIdx.y (grid (ceil(M / 64), B)). It recomputes the forward
// chain with every ReLU's sign pattern kept as bits (__ballot_sync, 2 KB
// per layer, on chip), then runs the transposed chain
// with the cotangents entering directly (dsigma through the softplus gate
// sigmoid(pre-activation), drgb through rgb_out). The direction encoding is
// per point, so the viewdir layer's direction cotangent is a (64 x W) @
// (W x 27) product, one warp reduction per row and encoding column,
// followed by the encoding's chain rule per point. Writes dxyz and dvd (3
// floats per point) and this block's partial column sums of dz_shape and
// dz_tex. With kStash (K7) it also writes each point's layer inputs a_*
// and pre-activation gradients g_* into its stash row; K6 instantiates it
// without, and ignores st. The last block's missing rows are zero-encoded
// and have zero cotangents; they are left out of the stash, the outputs
// and the column sums.
template <bool kStash>
__global__ void __launch_bounds__(kThreads, 1) field_point_bwd_kernel(
    const float* __restrict__ xyz, const float* __restrict__ vd, const float* __restrict__ zs,
    const float* __restrict__ zt, DecoderWeights w, Dims d,
    const float* __restrict__ g_sigma, const float* __restrict__ g_rgb, StashLayout st,
    float* __restrict__ dxyz, float* __restrict__ dvd, float* __restrict__ dzs_part,
    float* __restrict__ dzt_part) {
  const int blk = blockIdx.x, obj = blockIdx.y, nblk = gridDim.x;
  const int W = d.W, W2 = d.W / 2, M = d.R;          // d.R: points per object
  const int nj = W / 32;
  const size_t p0 = (size_t)obj * M + (size_t)blk * kRows;
  const int n = min(kRows, M - blk * kRows);          // this block's real rows
  const size_t part = (size_t)obj * nblk + blk;       // this block's partial-sum row
  const int n_masks = d.n_shape + d.n_tex + 3;
  float* pt = kStash ? st.pt + p0 * st.ld_pt : nullptr;  // this block's first stash row
  auto stash = [&](const float* buf, int stride, int N, int col) {
    if (kStash) store_rows(buf, stride, N, n, pt + col, st.ld_pt);
  };

  extern __shared__ float smem[];
  float* buf_a = smem;                         // kRows x W
  float* buf_b = buf_a + kRows * W;            // kRows x W
  float* pe = buf_b + kRows * W;               // kRows x kPeStride, point encodings
  float* dpe = pe + kRows * kPeStride;         // kRows x kPeStride, direction encodings
  float* colsum = dpe + kRows * kPeStride;     // W
  float* logit = colsum + W;                   // kRows
  float* dsig = logit + kRows;                 // kRows
  float* drgb = dsig + kRows;                  // kRows x 3
  uint32_t* masks = reinterpret_cast<uint32_t*>(drgb + kRows * 3);  // n_masks x kRows x nj
  // mask slots: 0 = encoding_xyz, 1..n_shape = shape blocks, then viewdir,
  // texture blocks, rgb_hidden
  auto mask_of = [&](int layer) { return masks + (size_t)layer * kRows * nj; };
  const int m_vd = d.n_shape + 1, m_tx0 = d.n_shape + 2, m_r1 = n_masks - 1;

  encode_points(xyz + p0 * 3, n, d.l_xyz, pe);
  encode_points(vd + p0 * 3, n, d.l_dir, dpe);
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const bool real = r < n;
    dsig[r] = real ? g_sigma[p0 + r] : 0.f;
    drgb[3 * r] = real ? g_rgb[(p0 + r) * 3] : 0.f;
    drgb[3 * r + 1] = real ? g_rgb[(p0 + r) * 3 + 1] : 0.f;
    drgb[3 * r + 2] = real ? g_rgb[(p0 + r) * 3 + 2] : 0.f;
  }
  __syncthreads();
  stash(pe, kPeStride, pe_width(d.l_xyz), st.a_xyz);
  stash(dpe, kPeStride, pe_width(d.l_dir), st.a_dpe);
  stash(drgb, 3, 3, st.g_rgb);

  // ---- forward recompute: ReLU patterns to shared memory, layer inputs to
  // the stash --------------------------------------------------------------
  dense(pe, kPeStride, pe_width(d.l_xyz), w.w_xyz, W, w.b_xyz, buf_a, W, true, mask_of(0));
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int j = 0; j < d.n_shape; ++j) {
    add_row_vector(cur, W, W, zs + ((size_t)obj * d.n_shape + j) * W);
    stash(cur, W, W, st.a_sh + j * W);
    dense(cur, W, W, w.w_sh + (size_t)j * W * W, W, w.b_sh + j * W, nxt, W, true,
          mask_of(1 + j));
    float* t = cur; cur = nxt; nxt = t;
  }
  stash(cur, W, W, st.a_es);
  dense(cur, W, W, w.w_es, W, w.b_es, nxt, W, false, nullptr);
  { float* t = cur; cur = nxt; nxt = t; }                       // cur = e
  stash(cur, W, W, st.a_e);
  head(cur, W, W, w.w_sg, 1, w.b_sg, logit);
  // viewdir layer: relu(e @ Wvd_a + dpe @ Wvd_b + b_vd), the direction term first
  dense(dpe, kPeStride, pe_width(d.l_dir), w.w_vd_b, W, w.b_vd, nxt, W, false, nullptr);
  dense(cur, W, W, w.w_vd_a, W, nullptr, nxt, W, true, mask_of(m_vd), true);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = 0; j < d.n_tex; ++j) {
    add_row_vector(cur, W, W, zt + ((size_t)obj * d.n_tex + j) * W);
    stash(cur, W, W, st.a_tx + j * W);
    dense(cur, W, W, w.w_tx + (size_t)j * W * W, W, w.b_tx + j * W, nxt, W, true,
          mask_of(m_tx0 + j));
    float* t = cur; cur = nxt; nxt = t;
  }
  stash(cur, W, W, st.a_r1);
  // rgb_hidden: its output is rgb_out's input; rgb_out itself is linear and
  // its cotangent is given
  dense(cur, W, W, w.w_r1, W2, w.b_r1, nxt, W2, true, mask_of(m_r1));
  stash(nxt, W2, W2, st.a_hh);
  if (kStash)
    for (int r = threadIdx.x; r < n; r += kThreads)
      pt[(size_t)r * st.ld_pt + st.g_sig] = dsig[r] * sigmoid(logit[r]);  // softplus' = sigmoid

  // ---- transposed decoder chain, pre-activation gradients to the stash ----
  // rgb_out: g_hh[r][c] = relu'(hh) * sum_k drgb[r][k] w_r2[c][k]
  for (int e = threadIdx.x; e < kRows * W2; e += kThreads) {
    const int r = e / W2, c = e - r * W2;
    buf_a[r * W2 + c] = drgb[3 * r] * w.w_r2[3 * c] + drgb[3 * r + 1] * w.w_r2[3 * c + 1]
                        + drgb[3 * r + 2] * w.w_r2[3 * c + 2];
  }
  __syncthreads();
  apply_mask(buf_a, W2, W2, mask_of(m_r1));
  stash(buf_a, W2, W2, st.g_hh);
  dense(buf_a, W2, W2, w.wt_r1, W, nullptr, buf_b, W, false, nullptr);
  cur = buf_b; nxt = buf_a;
  for (int j = d.n_tex - 1; j >= 0; --j) {
    apply_mask(cur, W, W, mask_of(m_tx0 + j));
    stash(cur, W, W, st.g_tx + j * W);
    dense(cur, W, W, w.wt_tx + (size_t)j * W * W, W, nullptr, nxt, W, false, nullptr);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, W, W, n, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads)
      dzt_part[(part * d.n_tex + j) * W + c] = colsum[c];
  }
  apply_mask(cur, W, W, mask_of(m_vd));            // cur = g_v
  stash(cur, W, W, st.g_v);
  // viewdir: the direction encoding's cotangent g_v @ Wvd_b^T per point (into
  // nxt, free until the trunk's transposed product below), then its chain rule
  point_direction_cotangent(cur, dpe, w, W, d.l_dir, n, nxt, dvd + p0 * 3);
  // encoding_shape output e feeds both the viewdir layer and the sigma head
  dense(cur, W, W, w.wt_vd_a, W, nullptr, nxt, W, false, nullptr);
  for (int e = threadIdx.x; e < kRows * W; e += kThreads) {
    const int r = e / W, c = e - r * W;
    const float g_sig = dsig[r] * sigmoid(logit[r]);
    nxt[r * W + c] = fmaf(g_sig, w.w_sg[c], nxt[r * W + c]);
  }
  __syncthreads();
  { float* t = cur; cur = nxt; nxt = t; }          // cur = g_e
  stash(cur, W, W, st.g_e);
  dense(cur, W, W, w.wt_es, W, nullptr, nxt, W, false, nullptr);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = d.n_shape - 1; j >= 0; --j) {
    apply_mask(cur, W, W, mask_of(1 + j));
    stash(cur, W, W, st.g_sh + j * W);
    dense(cur, W, W, w.wt_sh + (size_t)j * W * W, W, nullptr, nxt, W, false, nullptr);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, W, W, n, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads)
      dzs_part[(part * d.n_shape + j) * W + c] = colsum[c];
  }
  apply_mask(cur, W, W, mask_of(0));
  stash(cur, W, W, st.g_xyz);
  point_cotangent(cur, pe, w, W, d.l_xyz, n, nxt, dxyz + p0 * 3);
}

// Dynamic shared memory of field_point_bwd_kernel's block.
inline size_t field_point_bwd_smem_bytes(int W, int n_shape, int n_tex) {
  const size_t floats = (size_t)2 * kRows * W + 2 * kRows * kPeStride + W + kRows * 5;
  const size_t words = (size_t)(n_shape + n_tex + 3) * kRows * (W / 32);
  return sizeof(float) * floats + sizeof(uint32_t) * words;
}

}  // namespace supnerf
