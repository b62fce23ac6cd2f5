// Shared device code of the decoder kernels (render_fwd.cu, render_bwd.cu,
// render_train_bwd.cu, field_fwd.cu, field_bwd.cu, field_train_bwd.cu,
// field_gates.cu): the decoder weight table, the block-wide dense layer, the
// positional encoding and its chain rule, the compositing VJP, the data
// cotangents of the backward kernels, the training stash's layout and its
// copy, the per-point field's forward chain that K5, K6 and K7 share (with
// its float64 exact step), K5's body and the backward that K6 and K7
// share.
//
// Block shape, common to all of them: one block holds kRows points of one
// object, the samples of ONE ray in the render kernels, 64 consecutive
// points in the per-point field kernels. They are the rows of every
// activation matrix, which lives in shared memory (kRows x (W + kMmaPad)
// floats, 65 KB at W = 256). 256 threads = 8 warps. `dense_mma` (3xTF32
// on the tensor cores: every dense layer of every kernel) splits each
// layer's output columns across the warps.
//
// The bfloat16 mode (K3, K5, K6, K7 built with kBf16; K4's bfloat16 entry
// in wgrad.cu; K1's and K2's bfloat16 builds in render_bf16.cuh;
// ops/render.py's DecoderWeights.field_dtype "bfloat16"): the Pallas
// kernels at dtype=bfloat16. Here every dense layer runs on
// dense_mma_bf16 (bf16.cuh: bfloat16 operands, exact products, float32
// sums; the weights arrive rounded from the pack), the encodings rounded
// (encode_one_bf16: by the doubling recurrence, or exact, PeMode), the
// per-ray direction term rounded except in A11a (direction_term_bf16), the
// heads on rounded operands (head<true>); the backward recompute rounds its
// ReLU outputs (dense_mma_bf16's round_out, the Pallas kernels' stash) and
// the transposed chain its cotangents where they enter a product.
// Activations stay float32 in shared memory, rounded as the fragments are
// built, and each warp streams its float32 weight slice per block: what
// bounds these builds is that traffic and those conversions, not the
// tensor cores (K1's and K2's were 18-24x their bound so, and
// render_bf16.cuh redesigns them: bfloat16 weight tiles in a shared ring,
// two rays a block, wgmma). The mode has no kRefine step and no exact
// step: its gates and a plain version's part mostly where a float32
// sum that differs by a unit rounds to another bfloat16 value at the next
// layer's operand (about 2^-16 of the values), which moves a later
// pre-activation by ~2^-8 of one term, far outside any window a
// re-summation of the same operands could settle. chip_smoke.py holds the
// mode's gradients by their root mean square and by the count of points
// outside a bound, with a reason for each.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "cp_async.cuh"
#include "tf32.cuh"

namespace supnerf {

constexpr int kRows = 64;        // rows per block: the samples of one ray
constexpr int kThreads = 256;    // 8 warps x 8 rows
constexpr int kPeStride = 64;    // row stride of the point-encoding buffer
constexpr int kMaxDirPe = 64;    // direction encoding slots
constexpr float kEpsTrans = 1e-10f;
constexpr float kLastDelta = 1e10f;

// The bfloat16 render kernels' encodings (ops/render.py PE_MODES, in its
// order): kPeDoubling, the sines and cosines by the doubling recurrence and
// the direction term rounded (A1-A4); kPeExact, exact sines and cosines
// and an unrounded direction term (A11a); kPeTrain, exact sines and cosines
// and the direction term rounded (the training kernels A5 and A6).
enum PeMode { kPeDoubling = 0, kPeExact = 1, kPeTrain = 2 };

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
  const float* wt_vd_b;  // (W, d_dir)   viewdir layer, direction-encoding rows
};

struct Dims {
  int B, R, S, W, n_shape, n_tex, l_xyz, l_dir;
};

static __device__ __forceinline__ int pe_width(int degree) { return 3 * (2 * degree + 1); }

// Row stride padding of activation buffers read by dense_mma: a stride of 4
// mod 32 floats puts the 32 A-fragment loads of a warp on 32 distinct banks.
constexpr int kMmaPad = 4;
// row stride of an encoding buffer that dense_mma reads (K1's point
// encodings; K5-K7's point, then direction, encodings)
constexpr int kPeLd = kPeStride + kMmaPad;
// dense_mma's weight staging: per warp a ring of kBStages k-steps (8 rows
// of the warp's columns, kBLd floats a row: 8 mod 32, so the B-fragment
// loads hit 32 distinct banks); kMmaStageFloats for the whole block.
constexpr int kBStages = 6;
constexpr int kBLd = 40;
constexpr int kMmaStageFloats = kThreads / 32 * kBStages * 8 * kBLd;

// out[r][c] = act(sum_k in[r][k] * M[k][c] + bias[c]) for all kRows rows and
// c < N, with M row-major (K, N) in global memory (L2-resident: the whole
// decoder is 1.8 MB), on the tensor cores at float32 accuracy (3xTF32,
// tf32.cuh). If mask is given, bit l of mask[r * nj + j] (nj = ceil(N /
// 32)) records out[r][l + 32 j] > 0: the ReLU pattern the backward needs, 2
// KB per W = 256 layer instead of a 64 KB stash. Ends with __syncthreads();
// the caller has synchronised `in`. The output columns are split across
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
// side too. The ReLU masks come from the registers where a warp owns whole
// 32-column words (NT 4), else from the stored outputs after a sync. Not
// inlined: each kernel calls it a dozen times, and inlining every call site
// of every width variant multiplies the compile time.
// kDir (K5-K7: the viewdir layer with a direction encoding per point): a
// second operand pair, in2 (kRows x K2, row stride in2_stride) times M2
// (K2 x N, row-major), whose k-steps run after the first pair's through the
// same ring into the same sums, so out = act(in @ M + in2 @ M2 + bias) is
// one layer with its whole pre-activation in registers.
// kRefine (K1-K3, K5-K7; ReLU layers): a pre-activation within
// kRefineRtol of zero, relative to the largest |pre-activation| among the
// thread's 8 values of its row, is recomputed in float64 from the same
// float32 operands (dense_refine) before the ReLU and the mask bit. Its
// gate then is the exact one for the layer's inputs: a float32-accurate sum
// in any order leaves ~1e-7 of the row's scale in doubt (at most 5e-7 in
// bench/dense_accuracy_bench.cu), and a gate on the other side from
// float64's turns a whole gradient row of the point (chip_smoke.py's
// KINK_RTOL). The step is rarely taken: its test is a compare per value.
constexpr float kRefineRtol = 1.0f / 1048576.0f;   // 2^-20
// The rows that field_chain's exact step (K5-K7) recomputes in float64:
// those with a refined value within kExactRtol of the magnitude of its
// terms, |bias| + sum_k |in[k] M[k][c]|. A refined gate is exact for the
// layer's float32 inputs, which carry the rounding of every layer before:
// the refined gates that differed from the exact function's lay within
// 2.3e-8 of the row's largest |value| (7 points of 8 x 65,536 at W 256,
// chip_smoke.py), and the terms' magnitude is 2-3.6 times that largest
// value at a median unit (W 256, tests/test_torch_tf32_split.py), so the
// window is ~1.2e-7 of it or more.
constexpr double kExactRtol = 1.0 / 16777216.0;    // 2^-24

// dense_mma_t's kRefine step for one warp: each value a thread flagged (bit
// 16 t + 4 i + e of `flagged`: row 16 i + gid + 8 (e >> 1), column (t0 + t)
// * 8 + 2 tig + (e & 1), as the accumulators) is recomputed by the whole
// warp, lane l summing k = l, l + 32, ... (K <= 256; with kDir the second
// pair's K2 terms too) in float64, and stored as relu(value); then, with NT
// 4 and a mask, the warp's mask words are rebuilt from the stored outputs.
// With `rows`, the rows in which a recomputed value lies within kExactRtol
// of its terms' magnitude are ORed into *rows (bit r: row r; a word in
// shared memory).
template <int NT, bool kDir>
static __device__ __noinline__ void dense_refine(const float* in, int in_stride, int K,
                                                 const float* __restrict__ M, int N,
                                                 const float* bias, float* out, int out_stride,
                                                 uint32_t* mask, int t0, uint64_t flagged,
                                                 const float* in2, int in2_stride, int K2,
                                                 const float* __restrict__ M2,
                                                 unsigned long long* rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long exact = 0;
  uint32_t pending;
  while ((pending = __ballot_sync(0xffffffffu, flagged != 0)) != 0) {
    const int src = __ffs(pending) - 1;
    const int j = __shfl_sync(0xffffffffu, flagged ? __ffsll((long long)flagged) - 1 : 0, src);
    if (lane == src) flagged &= flagged - 1;
    const int t = j >> 4, i = (j >> 2) & 3, e = j & 3;
    const int r = 16 * i + (src >> 2) + 8 * (e >> 1);
    const int c = (t0 + t) * 8 + 2 * (src & 3) + (e & 1);
    double acc = 0.0, mag = 0.0;    // the sum and its terms' magnitude
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = lane + 32 * q;
      if (k < K) {
        const double a = in[r * in_stride + k], m = __ldg(M + (size_t)k * N + c);
        acc = fma(a, m, acc);
        mag = fma(fabs(a), fabs(m), mag);
      }
    }
    if constexpr (kDir) {
      for (int k = lane; k < K2; k += 32) {
        const double a = in2[r * in2_stride + k], m = __ldg(M2 + (size_t)k * N + c);
        acc = fma(a, m, acc);
        mag = fma(fabs(a), fabs(m), mag);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
      mag += __shfl_xor_sync(0xffffffffu, mag, o);
    }
    const double bc = bias != nullptr ? (double)bias[c] : 0.0;
    if (fabs(acc + bc) <= kExactRtol * (mag + fabs(bc))) exact |= 1ull << r;
    if (lane == 0) out[r * out_stride + c] = fmaxf((float)(acc + bc), 0.f);
  }
  if (rows != nullptr && lane == 0) atomicOr(rows, exact);
  __syncwarp();
  if (NT == 4 && mask != nullptr) {
    const int nj = (N + 31) / 32;
    for (int r = 0; r < kRows; ++r) {
      const uint32_t bits =
          __ballot_sync(0xffffffffu, out[r * out_stride + 32 * warp + lane] > 0.f);
      if (lane == 0) mask[r * nj + warp] = bits;
    }
  }
}

template <int NT, bool kRefine, bool kDir>
static __device__ __noinline__ void dense_mma_t(const float* in, int in_stride, int K,
                                                const float* __restrict__ M, int N,
                                                const float* bias, float* out, int out_stride,
                                                bool relu, uint32_t* mask, float* stage,
                                                const float* in2, int in2_stride,
                                                int K2, const float* __restrict__ M2,
                                                unsigned long long* rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_tiles = (N + 7) >> 3;
  const int t0 = warp * NT;
  // A warp either owns NT whole tiles or none: n_tiles is 4, 8, 16 or 32
  // (N = 32, 63 or 64, 128, 256) and NT = ceil(n_tiles / 8).
  if (t0 < n_tiles) {                                // warp-uniform
    float* ring = stage + warp * kBStages * 8 * kBLd;
    const int c0 = t0 * 8, n_first = (K + 7) >> 3;
    const int n_steps = n_first + (kDir ? (K2 + 7) >> 3 : 0);
    const bool vec = (N & 3) == 0;                   // M's rows start on 16 bytes
    // rows 8 step .. 8 step + 7 of M's (with kDir past the first pair's
    // steps: M2's) columns c0 .. c0 + 8 NT - 1 into a slot
    auto fetch = [&](int step) {
      float* dst = ring + (step % kBStages) * 8 * kBLd;
      const float* Ms = M;
      int Ks = K, k0 = step * 8;
      if (kDir && step >= n_first) {
        Ms = M2;
        Ks = K2;
        k0 = (step - n_first) * 8;
      }
      if (vec) {
        for (int q = lane; q < 16 * NT; q += 32) {
          const int row = q / (2 * NT), col = (q % (2 * NT)) * 4;
          const bool ok = k0 + row < Ks && c0 + col < N;
          cp_async<16>(dst + row * kBLd + col, ok ? Ms + (size_t)(k0 + row) * N + c0 + col : Ms,
                       ok ? 16 : 0);
        }
      } else {
        for (int q = lane; q < 64 * NT; q += 32) {
          const int row = q / (8 * NT), col = q % (8 * NT);
          const bool ok = k0 + row < Ks && c0 + col < N;
          cp_async<4>(dst + row * kBLd + col, ok ? Ms + (size_t)(k0 + row) * N + c0 + col : Ms,
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
      const float* a_in = in;
      int a_ld = in_stride, Ka = K, k0 = step * 8;
      if (kDir && step >= n_first) {
        a_in = in2;
        a_ld = in2_stride;
        Ka = K2;
        k0 = (step - n_first) * 8;
      }
      const bool lo = k0 + tig < Ka, hi = k0 + tig + 4 < Ka;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* r_lo = a_in + (16 * i + gid) * a_ld + k0 + tig;
        const float* r_hi = r_lo + 8 * a_ld;
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
    uint64_t flagged = 0;       // kRefine: the values to recompute
    if constexpr (kRefine) {
      // the pre-activations in place (the bias read once per column), then
      // those in doubt flagged against the largest of the thread's values of
      // their row (columns past N hold zeros)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cc = (t0 + t) * 8 + 2 * tig + h;
          const float b = (bias != nullptr && cc < N) ? bias[cc] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][t][h] += b;
            acc[i][t][2 + h] += b;
          }
        }
      if (relu) {
        float scale[4][2] = {};
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              scale[i][e >> 1] = fmaxf(scale[i][e >> 1], fabsf(acc[i][t][e]));
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if ((t0 + t) * 8 + 2 * tig + (e & 1) < N &&
                  fabsf(acc[i][t][e]) <= kRefineRtol * scale[i][e >> 1])
                flagged |= 1ull << (16 * t + 4 * i + e);
      }
    }
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
          float v;
          if constexpr (kRefine) v = acc[i][t][e];
          else v = acc[i][t][e] + (bias != nullptr ? bias[cc] : 0.f);
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
    if constexpr (kRefine) {
      if (__any_sync(0xffffffffu, flagged != 0))        // warp-uniform
        dense_refine<NT, kDir>(in, in_stride, K, M, N, bias, out, out_stride, mask, t0, flagged,
                               in2, in2_stride, K2, M2, rows);
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
// aligned. kRefine and kDir (with in2, in2_stride, K2, M2), and rows:
// dense_mma_t's; *rows is complete when dense_mma returns.
template <bool kRefine = false, bool kDir = false>
static __device__ void dense_mma(const float* in, int in_stride, int K, const float* M, int N,
                                 const float* bias, float* out, int out_stride, bool relu,
                                 uint32_t* mask, float* stage, const float* in2 = nullptr,
                                 int in2_stride = 0, int K2 = 0, const float* M2 = nullptr,
                                 unsigned long long* rows = nullptr) {
  const int nt = ((N + 7) / 8 + 7) / 8;
  if (nt <= 1)
    dense_mma_t<1, kRefine, kDir>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask,
                                  stage, in2, in2_stride, K2, M2, rows);
  else if (nt == 2)
    dense_mma_t<2, kRefine, kDir>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask,
                                  stage, in2, in2_stride, K2, M2, rows);
  else
    dense_mma_t<4, kRefine, kDir>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask,
                                  stage, in2, in2_stride, K2, M2, rows);
}

// dense_mma's bfloat16 mode (bf16.cuh; the common note at the top): out[r][c]
// = act(sum_k bf16(in[r][k]) M[k][c] (+ with kDir sum_k bf16(in2[r][k])
// M2[k][c]) + bias[c]), M and M2 holding bfloat16 values (the pack rounds
// them), each activation rounded to nearest even as its fragment is built.
// The same split of the output columns over the warps as dense_mma_t, and
// the same ring of kBStages slots of 8 weight rows per warp, taken two at a
// time: a k-step is 16 rows (one mma.sync m16n8k16), kBStages / 2 of them
// in flight; each k-step's products summed on the tensor cores from zero
// and added into the float32 sums. Reduction indices past K (K2) are
// masked on both sides. With round_out each stored value is rounded to
// bfloat16 after the bias and the ReLU (the backward recompute's stash);
// the ReLU masks come from the stored values. Ends with __syncthreads().
template <int NT, bool kDir>
static __device__ __noinline__ void dense_mma_bf16_t(const float* in, int in_stride, int K,
                                                     const float* __restrict__ M, int N,
                                                     const float* bias, float* out,
                                                     int out_stride, bool relu, uint32_t* mask,
                                                     float* stage, const float* in2,
                                                     int in2_stride, int K2,
                                                     const float* __restrict__ M2,
                                                     bool round_out) {
  constexpr int kSteps = kBStages / 2;               // 16-row k-steps the ring holds
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_tiles = (N + 7) >> 3;
  const int t0 = warp * NT;
  if (t0 < n_tiles) {                                // warp-uniform
    float* ring = stage + warp * kBStages * 8 * kBLd;
    const int c0 = t0 * 8, n_first = (K + 15) >> 4;
    const int n_steps = n_first + (kDir ? (K2 + 15) >> 4 : 0);
    const bool vec = (N & 3) == 0;                   // M's rows start on 16 bytes
    // rows 16 step .. 16 step + 15 of M's (with kDir past the first pair's
    // steps: M2's) columns c0 .. c0 + 8 NT - 1 into a 16-row slot
    auto fetch = [&](int step) {
      float* dst = ring + (step % kSteps) * 16 * kBLd;
      const float* Ms = M;
      int Ks = K, k0 = step * 16;
      if (kDir && step >= n_first) {
        Ms = M2;
        Ks = K2;
        k0 = (step - n_first) * 16;
      }
      if (vec) {
        for (int q = lane; q < 32 * NT; q += 32) {
          const int row = q / (2 * NT), col = (q % (2 * NT)) * 4;
          const bool ok = k0 + row < Ks && c0 + col < N;
          cp_async<16>(dst + row * kBLd + col, ok ? Ms + (size_t)(k0 + row) * N + c0 + col : Ms,
                       ok ? 16 : 0);
        }
      } else {
        for (int q = lane; q < 128 * NT; q += 32) {
          const int row = q / (8 * NT), col = q % (8 * NT);
          const bool ok = k0 + row < Ks && c0 + col < N;
          cp_async<4>(dst + row * kBLd + col, ok ? Ms + (size_t)(k0 + row) * N + c0 + col : Ms,
                      ok ? 4 : 0);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < kSteps - 1; ++s) {
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
      if (step + kSteps - 1 < n_steps) fetch(step + kSteps - 1);
      cp_async_commit();
      cp_async_wait<kSteps - 1>();
      __syncwarp();
      const float* b = ring + (step % kSteps) * 16 * kBLd + 2 * tig * kBLd + gid;
      uint32_t bq[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        bq[t][0] = bf16_pair(b[8 * t], b[kBLd + 8 * t]);
        bq[t][1] = bf16_pair(b[8 * kBLd + 8 * t], b[9 * kBLd + 8 * t]);
      }
      const float* a_in = in;
      int a_ld = in_stride, Ka = K, k0 = step * 16;
      if (kDir && step >= n_first) {
        a_in = in2;
        a_ld = in2_stride;
        Ka = K2;
        k0 = (step - n_first) * 16;
      }
      const int ka = k0 + 2 * tig;
      const bool ok0 = ka < Ka, ok1 = ka + 1 < Ka, ok8 = ka + 8 < Ka, ok9 = ka + 9 < Ka;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* r_lo = a_in + (16 * i + gid) * a_ld + ka;
        const float* r_hi = r_lo + 8 * a_ld;
        uint32_t a[4];
        a[0] = bf16_pair(ok0 ? r_lo[0] : 0.f, ok1 ? r_lo[1] : 0.f);
        a[1] = bf16_pair(ok0 ? r_hi[0] : 0.f, ok1 ? r_hi[1] : 0.f);
        a[2] = bf16_pair(ok8 ? r_lo[8] : 0.f, ok9 ? r_lo[9] : 0.f);
        a[3] = bf16_pair(ok8 ? r_hi[8] : 0.f, ok9 ? r_hi[9] : 0.f);
#pragma unroll
        for (int t = 0; t < NT; ++t) {     // this k-step's 16 products, then a float32 add
          float p[4];
          mma_bf16(p, a, bq[t], zero);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][t][e] += p[e];
        }
      }
    }
    cp_async_wait<0>();
    // with NT 4 the warp's 32 columns are mask word `warp` of every row, as
    // in dense_mma_t
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
          if (relu) v = fmaxf(v, 0.f);
          if (round_out) v = bf16_round(v);
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

// One dense layer in either mode: dense_mma<kRefine, kDir> (float32 on
// 3xTF32; rows: its exact-step word) or, with kBf16, dense_mma_bf16_t at
// the column count's tile width (round_out: its stash rounding; kRefine
// and rows unused).
template <bool kBf16, bool kRefine = false, bool kDir = false>
static __device__ __forceinline__ void dense_layer(
    const float* in, int in_stride, int K, const float* M, int N, const float* bias, float* out,
    int out_stride, bool relu, uint32_t* mask, float* stage, const float* in2 = nullptr,
    int in2_stride = 0, int K2 = 0, const float* M2 = nullptr,
    unsigned long long* rows = nullptr, bool round_out = false) {
  if constexpr (kBf16) {
    const int nt = ((N + 7) / 8 + 7) / 8;
    if (nt <= 1)
      dense_mma_bf16_t<1, kDir>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask,
                                stage, in2, in2_stride, K2, M2, round_out);
    else if (nt == 2)
      dense_mma_bf16_t<2, kDir>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask,
                                stage, in2, in2_stride, K2, M2, round_out);
    else
      dense_mma_bf16_t<4, kDir>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask,
                                stage, in2, in2_stride, K2, M2, round_out);
  } else {
    dense_mma<kRefine, kDir>(in, in_stride, K, M, N, bias, out, out_stride, relu, mask, stage,
                             in2, in2_stride, K2, M2, rows);
  }
}

// buf[r][c] += vec[c] over all rows (the per-object latent of a shape or
// texture block, added before the block's matmul): a warp per row, no
// integer division.
static __device__ void add_row_vector(float* buf, int stride, int N, const float* vec) {
  for (int r = threadIdx.x >> 5; r < kRows; r += kThreads / 32)
    for (int c = threadIdx.x & 31; c < N; c += 32) buf[r * stride + c] += vec[c];
  __syncthreads();
}

// buf[r][c] = 0 where the stashed ReLU output was not positive (the ReLU
// derivative applied to a cotangent in place), a warp per row.
static __device__ void apply_mask(float* buf, int stride, int N, const uint32_t* mask) {
  const int nj = (N + 31) / 32;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kRows; r += kThreads / 32)
    for (int j = 0; j < nj; ++j) {
      const int c = 32 * j + lane;
      if (c < N && !((mask[r * nj + j] >> lane) & 1u)) buf[r * stride + c] = 0.f;
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
// field kernel's block of points or directions) into pe (kRows x kStride,
// kStride >= kPeStride); rows >= S are zero so that the padded rows of every
// layer stay finite. The caller synchronises before reading pe.
template <int kStride = kPeStride>
static __device__ void encode_points(const float* xyz, int S, int degree, float* pe) {
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    float* row = pe + r * kStride;
    if (r < S) {
      const float x[3] = {xyz[3 * r], xyz[3 * r + 1], xyz[3 * r + 2]};
      encode_one(x, degree, row);
    } else {
      for (int k = 0; k < kStride; ++k) row[k] = 0.f;
    }
  }
}

// One step of the doubling recurrence: (sin 2y, cos 2y) = (2 s c, 1 - 2 s^2)
// from (s, c) = (sin y, cos y), each product and the difference rounded
// apart, as torch's and XLA's elementwise ops compute
// positional_encoding_doubling (no fused multiply-add).
static __device__ __forceinline__ void doubling_step(float& s, float& c) {
  const float s2 = 2.f * s;                          // exact
  const float sn = __fmul_rn(s2, c);
  c = __fsub_rn(1.f, __fmul_rn(s2, s));
  s = sn;
}

// The encoding the bfloat16 kernels read (ops/render.py encode_bf16; the
// layout of encode_one): every value rounded to bfloat16, the sines and
// cosines by the doubling recurrence from sin(x) and cos(x)
// (pallas_field.py:_pe_for_dtype), or with exact those of 2^i x (the Pallas
// kernels that encode in place, A11a and A11b).
static __device__ __forceinline__ void encode_one_bf16(const float x[3], int degree, bool exact,
                                                       float* pe) {
  for (int c = 0; c < 3; ++c) {
    pe[c] = bf16_round(x[c]);
    float s, co;
    sincosf(x[c], &s, &co);
    for (int i = 0; i < degree; ++i) {
      if (exact) sincosf(x[c] * (float)(1 << i), &s, &co);
      pe[3 + 3 * i + c] = bf16_round(s);
      pe[3 + 3 * degree + 3 * i + c] = bf16_round(co);
      doubling_step(s, co);
    }
  }
}

// encode_points with encode_one_bf16.
template <int kStride = kPeStride>
static __device__ void encode_points_bf16(const float* xyz, int S, int degree, bool exact,
                                          float* pe) {
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    float* row = pe + r * kStride;
    if (r < S) {
      const float x[3] = {xyz[3 * r], xyz[3 * r + 1], xyz[3 * r + 2]};
      encode_one_bf16(x, degree, exact, row);
    } else {
      for (int k = 0; k < kStride; ++k) row[k] = 0.f;
    }
  }
}

// One term of the encoding's chain rule in the bfloat16 mode (ops/render.py
// encode_bwd_bf16): cos g_sin - sin g_cos, its two products and their
// difference rounded apart, rounded to bfloat16 (the ladder matmul's
// operand).
static __device__ __forceinline__ float encode_term_bf16(float s, float co, float gs, float gc) {
  return bf16_round(__fsub_rn(__fmul_rn(co, gs), __fmul_rn(s, gc)));
}

// encode_backward_one in the bfloat16 mode, on the rounded encoding pe the
// forward read: dx_c = g[c] + sum_i 2^i encode_term_bf16(...).
static __device__ __forceinline__ void encode_backward_one_bf16(const float* pe, const float* g,
                                                                int degree, float dx[3]) {
  for (int c = 0; c < 3; ++c) {
    float t = 0.f;
    for (int i = 0; i < degree; ++i)
      t += (float)(1 << i) * encode_term_bf16(pe[3 + 3 * i + c], pe[3 + 3 * degree + 3 * i + c],
                                              g[3 + 3 * i + c], g[3 + 3 * degree + 3 * i + c]);
    dx[c] = g[c] + t;
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
// to every row of a block's input. kRound: each value rounded to bfloat16
// before the float32 sum (the Pallas training kernel's seg_reduce of g_v).
template <bool kRound = false>
static __device__ void column_sums(const float* buf, int stride, int N, int S, float* out) {
  for (int c = threadIdx.x; c < N; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < S; ++r) s += kRound ? bf16_round(buf[r * stride + c]) : buf[r * stride + c];
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
// stride the reduction. M is (K, ncols) row-major. kBf16: each input value
// rounded to bfloat16 (M holds bfloat16 values), the products exact.
template <bool kBf16 = false>
static __device__ void head(const float* in, int stride, int K, const float* __restrict__ M,
                     int ncols, const float* __restrict__ bias, float* out) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 8;
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + i;
    for (int c = 0; c < ncols; ++c) {
      float s = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float a = kBf16 ? bf16_round(in[r * stride + k]) : in[r * stride + k];
        s = fmaf(a, __ldg(M + k * ncols + c), s);
      }
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

// direction_term in the bfloat16 mode with the encodings pe_mode (PeMode):
// dpe the rounded encoding (encode_one_bf16, exact sines and cosines but
// for kPeDoubling), the term dpe @ Wvd_b (exact products, float32 sums)
// rounded to bfloat16 before b_vd is added (the Pallas kernels round the
// per-ray term before they expand it to the samples), not rounded with
// kPeExact (A11a sums it with the layer's other products).
static __device__ void direction_term_bf16(const float* vd, int degree, int pe_mode,
                                           const DecoderWeights& w, int W, float* dpe,
                                           float* hdir) {
  if (threadIdx.x == 0) {
    const float x[3] = {vd[0], vd[1], vd[2]};
    encode_one_bf16(x, degree, pe_mode != kPeDoubling, dpe);
  }
  __syncthreads();
  const int d_dir = pe_width(degree);
  for (int n = threadIdx.x; n < W; n += kThreads) {
    float s = 0.f;
    for (int k = 0; k < d_dir; ++k) s = fmaf(dpe[k], __ldg(w.w_vd_b + k * W + n), s);
    hdir[n] = (pe_mode == kPeExact ? s : bf16_round(s)) + w.b_vd[n];
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
// scratch: 4 x kRows floats. kBf16: the rgb cotangent rounded to bfloat16
// where it meets the colours and the weights (the Pallas kernel's
// seg_expand), not in the white background's term.
template <bool kBf16 = false>
static __device__ void composite_vjp(const float* logit, const float* rgb, const float* zr,
                                     int S, int white_bkgd, const float* g_rgb, float gd,
                                     float ga, float* scratch, float* dsig, float* drgb,
                                     float* dz) {
  float* alpha = scratch;
  float* T = alpha + kRows;
  float* wt = T + kRows;
  float* gw = wt + kRows;
  const float gr0 = kBf16 ? bf16_round(g_rgb[0]) : g_rgb[0];
  const float gr1 = kBf16 ? bf16_round(g_rgb[1]) : g_rgb[1];
  const float gr2 = kBf16 ? bf16_round(g_rgb[2]) : g_rgb[2];
  const float gwhite = white_bkgd ? (g_rgb[0] + g_rgb[1] + g_rgb[2]) : 0.f;
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

// The encoding's chain rule on the point encodings pe for the n real rows,
// from the encodings' cotangents dpe (both kRows x kPeStride); dxyz gets 3
// floats per row.
template <bool kBf16 = false>
static __device__ void encode_backward_rows(const float* pe, const float* dpe, int l_xyz, int n,
                                            float* dxyz) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    float dx[3];
    if constexpr (kBf16) encode_backward_one_bf16(pe + r * kPeStride, dpe + r * kPeStride, l_xyz, dx);
    else encode_backward_one(pe + r * kPeStride, dpe + r * kPeStride, l_xyz, dx);
    float* o = dxyz + r * 3;
    o[0] = dx[0]; o[1] = dx[1]; o[2] = dx[2];
  }
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

// dst[r][c] = buf[r][c] for the n real rows and c < N (buf rows `stride`
// floats apart, dst rows `ld` apart; both, buf and dst start on 16 bytes
// where N >= 4): a warp per row, the row's whole quads as 16-byte streaming
// stores (the stash is read once, by K4, and is far larger than L2), the
// last N mod 4 columns one float at a time. No barrier: the caller's next
// __syncthreads() comes before anything rewrites buf. kRound: each value
// stored rounded to bfloat16 (K3's bfloat16 mode: the A side of its stash,
// the operands the Pallas kernel's mm_xg casts).
template <bool kRound = false>
static __device__ __forceinline__ void stash_rows(const float* buf, int stride, int N, int n,
                                                  float* dst, int ld) {
  const int lane = threadIdx.x & 31;
  const int nq = N >> 2;
  for (int r = threadIdx.x >> 5; r < n; r += kThreads / 32) {
    const float* src = buf + r * stride;
    float* out = dst + (size_t)r * ld;
    for (int q = lane; q < nq; q += 32) {
      float4 v = reinterpret_cast<const float4*>(src)[q];
      if (kRound) {
        v.x = bf16_round(v.x);
        v.y = bf16_round(v.y);
        v.z = bf16_round(v.z);
        v.w = bf16_round(v.w);
      }
      __stcs(reinterpret_cast<float4*>(out) + q, v);
    }
    for (int c = 4 * nq + lane; c < N; c += 32) __stcs(out + c, kRound ? bf16_round(src[c]) : src[c]);
  }
}

// ---- the per-point field on the tensor cores (field_fwd.cu K5, field_bwd.cu
// K6, field_train_bwd.cu K7) ----

// Mask slots of the per-point field's ReLU layers: 0 = encoding_xyz,
// 1..n_shape = shape blocks, then viewdir, texture blocks, rgb_hidden.
static __device__ __forceinline__ int field_slots(const Dims& d) { return d.n_shape + d.n_tex + 3; }

// One point's input x of `degree` frequencies, entry k of its encoding in
// float64 (positional_encoding's layout, sines and cosines of the exact
// 2^i x).
static __device__ __forceinline__ double encode64(const float* x, int degree, int k) {
  if (k < 3) return (double)x[k];
  const int m = (k - 3) % (3 * degree), i = m / 3;
  const double y = (double)x[m - 3 * i] * (double)(1 << i);
  return k < 3 + 3 * degree ? sin(y) : cos(y);
}

// One float64 layer of one point by the whole block (a barrier before and
// after): out[c] = act(bias[c] + sum_{k < K} in[k] M[k][c] (+ sum_{k < K2}
// in2[k] M2[k][c] where in2 is given)) (+ add[c] where add is given: the
// next block's latent) for the N units c (a multiple of 32, at most 256),
// act relu or none. in, in2, out: the point's float64 rows in shared
// memory; part: 4 x 256 doubles of scratch; M, M2 row-major with rows on 16
// bytes. Thread t sums columns 4 (t % 64) .. + 3 over k = t / 64 + 4 i,
// reading M a float4 at a time in batches of 16 loads (the weights come
// from L2, so the loads' latency is the cost), and the four partial sums
// of a column are added in shared memory.
static __device__ void dense64(const double* in, int K, const float* __restrict__ M,
                               const double* in2, int K2, const float* __restrict__ M2, int N,
                               const float* bias, bool relu, const float* add, double* out,
                               double* part) {
  constexpr int kBatch = 16;
  const int g = threadIdx.x & 63, sl = threadIdx.x >> 6;
  __syncthreads();                                            // in, in2 written
  if (4 * g < N) {
    double p[4] = {0.0, 0.0, 0.0, 0.0};
    auto sum = [&](const double* x, int Kx, const float* __restrict__ Mx) {
      for (int k0 = sl; k0 < Kx; k0 += 4 * kBatch) {
        float4 m[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int k = k0 + 4 * u;
          m[u] = k < Kx ? __ldg(reinterpret_cast<const float4*>(Mx + (size_t)k * N) + g)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int k = k0 + 4 * u;
          const double a = k < Kx ? x[k] : 0.0;
          p[0] = fma(a, (double)m[u].x, p[0]);
          p[1] = fma(a, (double)m[u].y, p[1]);
          p[2] = fma(a, (double)m[u].z, p[2]);
          p[3] = fma(a, (double)m[u].w, p[3]);
        }
      }
    };
    sum(in, K, M);
    if (in2 != nullptr) sum(in2, K2, M2);
#pragma unroll
    for (int i = 0; i < 4; ++i) part[sl * 256 + 4 * g + i] = p[i];
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < N) {
    double v = (double)bias[c] + part[c] + part[256 + c] + part[512 + c] + part[768 + c];
    if (relu) v = fmax(v, 0.0);
    out[c] = v + (add != nullptr ? (double)add[c] : 0.0);
  }
  __syncthreads();
}

// field_chain's exact step for mask slot `slot`, by the whole block: for
// each row r of `rows` (bit r; real rows), the chain recomputed in float64
// from the row's raw point and direction (xyz, vd: the block's first; zs,
// zt the object's latents) up to that slot's layer, the encodings from
// float64 sines and cosines, and the layer's output row in `out` (stride
// `ld`) replaced by relu of the float64 pre-activations rounded to float32,
// its mask words (mask, if given) by their signs. scratch: 1056 + 2 W
// doubles of shared memory. Not inlined: it runs in few blocks, and its
// registers stay out of the kernels' (their w and d are __grid_constant__,
// so the references need no copy).
static __device__ __noinline__ void field_exact64(int slot, unsigned long long rows,
                                                  const float* xyz, const float* vd,
                                                  const float* zs, const float* zt,
                                                  const DecoderWeights& w, const Dims& d,
                                                  float* out, int ld, uint32_t* mask,
                                                  double* scratch) {
  const int W = d.W, d_xyz = pe_width(d.l_xyz), d_dir = pe_width(d.l_dir);
  const int s_vd = d.n_shape + 1, s_r1 = d.n_shape + d.n_tex + 2;
  const int N = slot == s_r1 ? W / 2 : W;
  double* part = scratch;                                     // 4 x 256
  double* a = part + 4 * 256;                                 // W
  double* b = a + W;                                          // W
  double* dpe = b + W;                                        // 32 (d_dir <= 27)
  for (; rows != 0; rows &= rows - 1) {
    const int r = __ffsll((long long)rows) - 1;               // block-uniform
    const int t = threadIdx.x;
    if (t < d_xyz) a[t] = encode64(xyz + 3 * r, d.l_xyz, t);
    if (t >= 128 && t - 128 < d_dir) dpe[t - 128] = encode64(vd + 3 * r, d.l_dir, t - 128);
    double* x = a;
    double* y = b;
    // one layer x -> y; each ReLU layer's output but the last gets the next
    // block's latent, that block's input
    auto layer = [&](int K, const float* Mw, const double* x2, int K2, const float* M2w, int Nl,
                     const float* bias, bool relu, const float* add, bool last) {
      dense64(x, K, Mw, x2, K2, M2w, Nl, bias, relu, last ? nullptr : add, y, part);
      double* tmp = x; x = y; y = tmp;
    };
    layer(d_xyz, w.w_xyz, nullptr, 0, nullptr, W, w.b_xyz, true, d.n_shape > 0 ? zs : nullptr,
          slot == 0);
    for (int j = 0; j < d.n_shape && 1 + j <= slot; ++j)
      layer(W, w.w_sh + (size_t)j * W * W, nullptr, 0, nullptr, W, w.b_sh + j * W, true,
            j + 1 < d.n_shape ? zs + (j + 1) * W : nullptr, slot == 1 + j);
    if (slot >= s_vd) {
      layer(W, w.w_es, nullptr, 0, nullptr, W, w.b_es, false, nullptr, false);    // e
      layer(W, w.w_vd_a, dpe, d_dir, w.w_vd_b, W, w.b_vd, true, d.n_tex > 0 ? zt : nullptr,
            slot == s_vd);
      for (int j = 0; j < d.n_tex && s_vd + 1 + j <= slot; ++j)
        layer(W, w.w_tx + (size_t)j * W * W, nullptr, 0, nullptr, W, w.b_tx + j * W, true,
              j + 1 < d.n_tex ? zt + (j + 1) * W : nullptr, slot == s_vd + 1 + j);
      if (slot == s_r1)
        layer(W, w.w_r1, nullptr, 0, nullptr, W / 2, w.b_r1, true, nullptr, true);
    }
    const int c = threadIdx.x;
    if (c < N) {                                              // whole warps: N % 32 == 0
      const float v = (float)x[c];
      out[r * ld + c] = v;
      const uint32_t bits = __ballot_sync(0xffffffffu, v > 0.f);
      if (mask != nullptr && (c & 31) == 0) mask[r * (N / 32) + (c >> 5)] = bits;
    }
    __syncthreads();                                          // x read before the next row
  }
}

// The per-point field's forward chain for one block of kRows points of one
// object, n of them real (xyz, vd: their raw coordinates; the other rows
// are zero-encoded): K1's nine dense layers on dense_mma, every ReLU layer
// with its kRefine step, and the viewdir layer with the points' own
// direction encodings as its second operand pair (kDir), so that the
// refined pre-activation relu(e @ Wvd_a + dpe @ Wvd_b + b_vd) covers the
// direction term too. K5 runs it for sigma and rgb, K6 and K7
// (field_backward) to keep every ReLU's pattern as bits for their
// transposed chain: one code path, so they differentiate at the gates K5
// took.
// The exact step: a refined gate is exact for its layer's float32 inputs,
// but those carry the float32 rounding of every layer before (~1e-8 of the
// row's scale), so at a unit nearer zero than that it can be the other side
// from the exact function's (the float64 plain version's). So after each
// ReLU layer, each real row with a refined value nearer zero than
// kExactRtol of its terms' magnitude (dense_mma's rows word, exact[slot])
// has that layer's output row replaced by the float64 chain's
// (field_exact64), before any later layer reads it: the values K5 goes on
// with and the masks K6 and K7 differentiate are those of the exact
// function's gates. Few rows take it.
// masks: field_slots(d) slots of kRows x W/32 words (K5: nullptr, or where
// the caller asks for its gates), exact: field_slots(d) words, both shared
// memory; enc (kRows x kPeLd) holds the point encodings for the first
// layer, then the direction encodings; zs, zt are the object's latents.
// Writes the sigma head's pre-activation into logit (kRows) and returns the
// buffer (buf_a or buf_b, row stride W + kMmaPad) that holds rgb_hidden's
// output. Ends with __syncthreads().
// kStash (K7): each layer input's real rows also go into the stash rows
// from pt on (st's a_* columns and a_dpe; stash_rows), each copy where the
// chain's next barrier comes before its buffer is rewritten: the point
// encodings before the first layer, the direction encodings once the
// encoding_shape layer's barrier has passed. The last copy, of the returned
// buffer, has no barrier after it: the caller must not rewrite that buffer
// before its next __syncthreads().
// kBf16 (K5, K6, K7 in the bfloat16 mode): the encodings rounded
// (encode_points_bf16; exact_pe: the exact sines and cosines of A11b and of
// the training field, A9 and A10), every layer on dense_mma_bf16, the sigma
// head on rounded operands, no exact step; round_stash (K6's and K7's
// recompute) rounds each ReLU output to bfloat16 (the Pallas backward
// kernels' stash), so the next layer adds its latent to the rounded value.
// With kStash (K7) the A side of the stash is bfloat16-exact, as
// pallas_field.py:_field_train_bwd_kernel's weight products (mm_xg) cast
// it: the rounded encodings and ReLU outputs as they are, e and each
// latent-added layer input rounded as stash_rows<true> stores them.
template <bool kStash = false, bool kBf16 = false>
static __device__ __forceinline__ float* field_chain(const float* xyz, const float* vd, int n, const float* zs,
                                     const float* zt, const DecoderWeights& w, const Dims& d,
                                     float* stage, float* buf_a, float* buf_b, float* enc,
                                     float* logit, uint32_t* masks, unsigned long long* exact,
                                     const StashLayout& st = {}, float* pt = nullptr,
                                     bool exact_pe = false, bool round_stash = false) {
  const int W = d.W, Ws = W + kMmaPad;
  const unsigned long long real = n < 64 ? (1ull << n) - 1 : ~0ull;
  auto mask_of = [&](int slot) {
    return masks != nullptr ? masks + (size_t)slot * kRows * (W / 32) : nullptr;
  };
  auto stash = [&](const float* buf, int stride, int N, int col) {
    if constexpr (kStash) stash_rows(buf, stride, N, n, pt + col, st.ld_pt);
  };
  // a value the bfloat16 mode has not rounded yet: e, a latent-added input
  auto stash_rounded = [&](const float* buf, int N, int col) {
    if constexpr (kStash) stash_rows<kBf16>(buf, Ws, N, n, pt + col, st.ld_pt);
  };
  // after a ReLU layer (its output in out; free: the buffer its input was
  // in), the exact step for the real rows its refine step noted
  auto settle = [&](int slot, float* out, float* free) {
    if constexpr (!kBf16) {
      const unsigned long long rows = exact[slot] & real;    // block-uniform
      if (rows != 0)
        field_exact64(slot, rows, xyz, vd, zs, zt, w, d, out, Ws, mask_of(slot),
                      reinterpret_cast<double*>(free));
    }
  };
  auto encode = [&](const float* x, int degree) {
    if constexpr (kBf16) encode_points_bf16<kPeLd>(x, n, degree, exact_pe, enc);
    else encode_points<kPeLd>(x, n, degree, enc);
  };
  if ((int)threadIdx.x < field_slots(d)) exact[threadIdx.x] = 0;
  encode(xyz, d.l_xyz);
  __syncthreads();
  stash(enc, kPeLd, pe_width(d.l_xyz), st.a_xyz);
  dense_layer<kBf16, true>(enc, kPeLd, pe_width(d.l_xyz), w.w_xyz, W, w.b_xyz, buf_a, Ws, true,
                           mask_of(0), stage, nullptr, 0, 0, nullptr, exact, round_stash);
  settle(0, buf_a, buf_b);
  // the point encodings are read: the direction encodings take their place,
  // read by the viewdir layer after the barriers of the layers between
  encode(vd, d.l_dir);
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int j = 0; j < d.n_shape; ++j) {
    add_row_vector(cur, Ws, W, zs + (size_t)j * W);
    stash_rounded(cur, W, st.a_sh + j * W);
    dense_layer<kBf16, true>(cur, Ws, W, w.w_sh + (size_t)j * W * W, W, w.b_sh + j * W, nxt, Ws,
                             true, mask_of(1 + j), stage, nullptr, 0, 0, nullptr, exact + 1 + j,
                             round_stash);
    settle(1 + j, nxt, cur);
    float* t = cur; cur = nxt; nxt = t;
  }
  stash(cur, Ws, W, st.a_es);
  dense_layer<kBf16>(cur, Ws, W, w.w_es, W, w.b_es, nxt, Ws, false, nullptr, stage);
  { float* t = cur; cur = nxt; nxt = t; }                       // cur = e
  stash_rounded(cur, W, st.a_e);
  stash(enc, kPeLd, pe_width(d.l_dir), st.a_dpe);
  head<kBf16>(cur, Ws, W, w.w_sg, 1, w.b_sg, logit);
  const int s_vd = d.n_shape + 1;
  dense_layer<kBf16, true, true>(cur, Ws, W, w.w_vd_a, W, w.b_vd, nxt, Ws, true, mask_of(s_vd),
                                 stage, enc, kPeLd, pe_width(d.l_dir), w.w_vd_b, exact + s_vd,
                                 round_stash);
  settle(s_vd, nxt, cur);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = 0; j < d.n_tex; ++j) {
    add_row_vector(cur, Ws, W, zt + (size_t)j * W);
    stash_rounded(cur, W, st.a_tx + j * W);
    dense_layer<kBf16, true>(cur, Ws, W, w.w_tx + (size_t)j * W * W, W, w.b_tx + j * W, nxt, Ws,
                             true, mask_of(s_vd + 1 + j), stage, nullptr, 0, 0, nullptr,
                             exact + s_vd + 1 + j, round_stash);
    settle(s_vd + 1 + j, nxt, cur);
    float* t = cur; cur = nxt; nxt = t;
  }
  const int s_r1 = field_slots(d) - 1;
  stash(cur, Ws, W, st.a_r1);
  dense_layer<kBf16, true>(cur, Ws, W, w.w_r1, W / 2, w.b_r1, nxt, Ws, true, mask_of(s_r1), stage,
                           nullptr, 0, 0, nullptr, exact + s_r1, round_stash);
  settle(s_r1, nxt, cur);
  stash(nxt, Ws, W / 2, st.a_hh);
  return nxt;
}

// The block's ReLU masks (field_chain's slots) into gates, field_slots(d) x
// W/32 words a point from the block's first point on, for its n real rows:
// the kernels' gates, asked for by a check (ops/field.py's `gates`). The
// rgb_hidden slot fills the first W/64 words of its W/32. No barrier.
static __device__ void store_gates(const uint32_t* masks, int n, const Dims& d, uint32_t* gates) {
  const int nj = d.W / 32, slots = field_slots(d);
  for (int e = threadIdx.x; e < n * slots * nj; e += kThreads) {
    const int q = e % nj, s = (e / nj) % slots, r = e / (nj * slots);
    const int nw = s == slots - 1 ? nj / 2 : nj;
    if (q < nw) gates[e] = masks[(size_t)s * kRows * nj + r * nw + q];
  }
}

// The encoding's chain rule for n points from their raw coordinates x (3
// floats a point) and the cotangents g of their encodings at `degree`
// frequencies (rows ld floats apart): dx_c = g[c] + sum_i 2^i (cos(2^i x_c)
// g_sin[i][c] - sin(2^i x_c) g_cos[i][c]), the sines and cosines recomputed
// as encode_one computes them (the same values), a thread per (point,
// coordinate); dx gets 3 floats per point. No barrier.
static __device__ void encode_backward_points(const float* x, const float* g, int ld,
                                              int degree, int n, float* dx) {
  for (int e = threadIdx.x; e < 3 * n; e += kThreads) {
    const int r = e / 3, c = e - 3 * r;
    const float* gr = g + r * ld;
    float v = gr[c];
    for (int i = 0; i < degree; ++i) {
      float s, co;
      sincosf(x[e] * (float)(1 << i), &s, &co);
      v += (float)(1 << i) * (co * gr[3 + 3 * i + c] - s * gr[3 + 3 * degree + 3 * i + c]);
    }
    dx[e] = v;
  }
}

// encode_backward_points in the bfloat16 mode: the sines and cosines those
// of encode_one_bf16's doubling recurrence, rounded (the encodings K6's
// forward read), each term encode_term_bf16, dx_c = g[c] + sum_i 2^i term.
static __device__ void encode_backward_points_bf16(const float* x, const float* g, int ld,
                                                   int degree, int n, float* dx) {
  for (int e = threadIdx.x; e < 3 * n; e += kThreads) {
    const int r = e / 3, c = e - 3 * r;
    const float* gr = g + r * ld;
    float s, co, t = 0.f;
    sincosf(x[e], &s, &co);
    for (int i = 0; i < degree; ++i) {
      t += (float)(1 << i) * encode_term_bf16(bf16_round(s), bf16_round(co), gr[3 + 3 * i + c],
                                              gr[3 + 3 * degree + 3 * i + c]);
      doubling_step(s, co);
    }
    dx[e] = gr[c] + t;
  }
}

// Dynamic shared memory of field_forward's block: the weight rings, two
// activation buffers, the encodings, the heads' outputs and the exact
// step's words, then, with the gates (kGates), the ReLU masks (~208 KB at W
// 256 without them).
static inline size_t field_forward_smem_bytes(int W, int n_shape, int n_tex, bool gates) {
  const size_t slots = (size_t)n_shape + n_tex + 3;
  return sizeof(float) * ((size_t)kMmaStageFloats + 2 * kRows * (W + kMmaPad) + kRows * kPeLd
                          + kRows * 4)
         + sizeof(unsigned long long) * slots
         + (gates ? sizeof(uint32_t) * slots * kRows * (W / 32) : 0);
}

// The per-point field's forward (K5) for one block of kRows points of one
// object, n of them real: field_chain, then the rgb head and the softplus
// of the sigma head. xyz, vd (3 floats a point), out_sigma (1) and out_rgb
// (3) start at the block's first point; zs, zt are the object's latents.
// smem: field_forward_smem_bytes. kGates (field_gates.cu): the ReLU masks
// kept too and written into gates from the block's first point
// (store_gates). kBf16: the bfloat16 mode (field_chain's; exact_pe: A11b's
// encodings), the rgb head on rounded operands.
template <bool kGates, bool kBf16 = false>
static __device__ __forceinline__ void field_forward(
    const float* xyz, const float* vd, int n, const float* zs, const float* zt,
    const DecoderWeights& w, const Dims& d, float* smem, float* out_sigma, float* out_rgb,
    uint32_t* gates, bool exact_pe = false) {
  const int W = d.W, Ws = W + kMmaPad;       // Ws: activation row stride
  float* stage = smem;                       // kMmaStageFloats, dense_mma's weight slices
  float* buf_a = stage + kMmaStageFloats;    // kRows x Ws
  float* buf_b = buf_a + kRows * Ws;         // kRows x Ws
  float* enc = buf_b + kRows * Ws;           // kRows x kPeLd, point then direction encodings
  float* sig = enc + kRows * kPeLd;          // kRows
  float* rgb = sig + kRows;                  // kRows x 3
  auto* exact = reinterpret_cast<unsigned long long*>(rgb + kRows * 3);  // field_slots(d)
  uint32_t* masks = kGates ? reinterpret_cast<uint32_t*>(exact + field_slots(d)) : nullptr;

  const float* hh = field_chain<false, kBf16>(xyz, vd, n, zs, zt, w, d, stage, buf_a, buf_b,
                                              enc, sig, masks, exact, StashLayout{}, nullptr,
                                              exact_pe);
  if constexpr (kGates) store_gates(masks, n, d, gates);
  head<kBf16>(hh, Ws, W / 2, w.w_r2, 3, w.b_r2, rgb);
  for (int r = threadIdx.x; r < n; r += kThreads) {
    out_sigma[r] = softplus(sig[r]);
    out_rgb[3 * r] = rgb[3 * r];
    out_rgb[3 * r + 1] = rgb[3 * r + 1];
    out_rgb[3 * r + 2] = rgb[3 * r + 2];
  }
}

// Dynamic shared memory of field_backward's block: the weight rings, two
// activation buffers, the encodings, the column sums, the sigma head's
// logits, the cotangents, n_shape + n_tex + 3 ReLU masks and as many exact
// step words (228,664 B at W 256 with 3 shape blocks and 1 texture block).
static inline size_t field_backward_smem_bytes(int W, int n_shape, int n_tex) {
  const size_t slots = (size_t)n_shape + n_tex + 3;
  const size_t floats = (size_t)kMmaStageFloats + 2 * kRows * (W + kMmaPad) + kRows * kPeLd
                        + W + kRows * 5;
  return sizeof(float) * floats + sizeof(uint32_t) * slots * kRows * (W / 32)
         + sizeof(unsigned long long) * slots;
}

// The per-point field's backward for one block of kRows points of one
// object, n of them real, with a frozen decoder (K6) or with the stash from
// which K4 forms the decoder's weight gradients (kStash, K7). xyz, vd,
// g_sigma (1 float a point), g_rgb (3) and dxyz, dvd (3) start at the
// block's first point; zs, zt are the object's latents; dzs_part (n_shape x
// W) and dzt_part (n_tex x W) are the block's partial-sum rows; with
// kGates (field_gates.cu), gates gets the block's ReLU masks from its first
// point (store_gates). smem:
// field_backward_smem_bytes.
// field_chain recomputes K5's forward, its exact step included, with every
// ReLU's pattern kept as bits; then K2's transposed chain runs on dense_mma
// (rgb_hidden, the texture blocks, the viewdir layer's direction-encoding
// rows through the transposed copy wt_vd_b and its trunk rows,
// encoding_shape with the sigma head's gradient added, the shape blocks,
// the first layer's 63 encoding columns), the cotangents entering directly
// (dsigma through the softplus gate sigmoid(logit), drgb through rgb_out),
// the ReLU masks applied and the latents' column sums taken over the n
// real rows. The direction encodings' cotangent goes into enc, free once
// the forward is done, and both encodings' chain rules recompute their
// sines from the raw points (encode_backward_points). kStash only adds
// copies: field_chain's layer inputs, g_sig and g_rgb, and each
// pre-activation gradient g_* where the transposed chain forms it, into the
// n real rows from pt on (st's columns), each copy of a buffer that nothing
// rewrites before the chain's next __syncthreads(); so K6 and K7 give the
// same bits.
// kBf16 (the bfloat16 mode: K6, pallas_field.py:_field_bwd_kernel, and K7,
// _field_train_bwd_kernel, at dtype=bfloat16): field_chain's recompute with
// its ReLU outputs rounded (round_stash), every transposed layer on
// dense_mma_bf16 (its cotangent rounded as its fragments are built), the
// rgb and sigma cotangents rounded where they enter a product, the
// encodings' cotangents unrounded float32. K6 (exact_pe false) reads the
// doubling encodings and takes both chain rules as the Pallas kernel does
// in place (encode_backward_points_bf16). K7 (exact_pe true) reads the
// exact encodings, which field_train_pallas computes in XLA outside the
// kernel, and takes XLA's autodiff of them: the float32 chain rule
// (encode_backward_points) on the unrounded cotangents.
template <bool kStash, bool kGates, bool kBf16 = false>
static __device__ __forceinline__ void field_backward(
    const float* xyz, const float* vd, int n, const float* zs, const float* zt,
    const DecoderWeights& w, const Dims& d, const float* g_sigma, const float* g_rgb,
    float* smem, float* dxyz, float* dvd, float* dzs_part, float* dzt_part,
    const StashLayout& st, float* pt, uint32_t* gates, bool exact_pe = false) {
  const int W = d.W, W2 = d.W / 2, Ws = W + kMmaPad;   // Ws: activation row stride
  const int nj = W / 32;
  const int n_masks = field_slots(d);
  float* stage = smem;                         // kMmaStageFloats, dense_mma's weight slices
  float* buf_a = stage + kMmaStageFloats;      // kRows x Ws
  float* buf_b = buf_a + kRows * Ws;           // kRows x Ws
  float* enc = buf_b + kRows * Ws;             // kRows x kPeLd (later: scratch)
  float* colsum = enc + kRows * kPeLd;         // W
  float* logit = colsum + W;                   // kRows
  float* dsig = logit + kRows;                 // kRows
  float* drgb = dsig + kRows;                  // kRows x 3
  uint32_t* masks = reinterpret_cast<uint32_t*>(drgb + kRows * 3);  // n_masks x kRows x nj
  auto* exact = reinterpret_cast<unsigned long long*>(masks + (size_t)n_masks * kRows * nj);
  // mask slots as field_chain fills them: 0 = encoding_xyz, 1..n_shape =
  // shape blocks, then viewdir, texture blocks, rgb_hidden
  auto mask_of = [&](int layer) { return masks + (size_t)layer * kRows * nj; };
  const int m_vd = d.n_shape + 1, m_tx0 = d.n_shape + 2, m_r1 = n_masks - 1;
  auto stash = [&](const float* buf, int N, int col) {
    if constexpr (kStash) stash_rows(buf, Ws, N, n, pt + col, st.ld_pt);
  };

  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const bool real = r < n;
    dsig[r] = real ? g_sigma[r] : 0.f;
    drgb[3 * r] = real ? g_rgb[3 * r] : 0.f;
    drgb[3 * r + 1] = real ? g_rgb[3 * r + 1] : 0.f;
    drgb[3 * r + 2] = real ? g_rgb[3 * r + 2] : 0.f;
  }
  // ---- forward recompute, ReLU patterns to shared memory (syncs) ---------
  // nxt: rgb_hidden's output, read by the a_hh copy until the next barrier
  float* nxt = field_chain<kStash, kBf16>(xyz, vd, n, zs, zt, w, d, stage, buf_a, buf_b, enc,
                                          logit, masks, exact, st, pt, exact_pe, kBf16);
  float* cur = nxt == buf_a ? buf_b : buf_a;
  if constexpr (kGates) store_gates(masks, n, d, gates);
  if constexpr (kStash) {
    stash_rows(drgb, 3, 3, n, pt + st.g_rgb, st.ld_pt);
    for (int r = threadIdx.x; r < n; r += kThreads)
      pt[(size_t)r * st.ld_pt + st.g_sig] = dsig[r] * sigmoid(logit[r]);  // softplus' = sigmoid
  }

  // ---- transposed decoder chain ------------------------------------------
  // rgb_out: g_hh[r][c] = relu'(hh) * sum_k drgb[r][k] w_r2[c][k]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto rd = [](float x) { return kBf16 ? bf16_round(x) : x; };
  for (int r = warp; r < kRows; r += kThreads / 32)
    for (int c = lane; c < W2; c += 32)
      cur[r * Ws + c] = rd(drgb[3 * r]) * w.w_r2[3 * c] + rd(drgb[3 * r + 1]) * w.w_r2[3 * c + 1]
                        + rd(drgb[3 * r + 2]) * w.w_r2[3 * c + 2];
  __syncthreads();
  apply_mask(cur, Ws, W2, mask_of(m_r1));
  stash(cur, W2, st.g_hh);
  dense_layer<kBf16>(cur, Ws, W2, w.wt_r1, W, nullptr, nxt, Ws, false, nullptr, stage);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = d.n_tex - 1; j >= 0; --j) {
    apply_mask(cur, Ws, W, mask_of(m_tx0 + j));
    stash(cur, W, st.g_tx + j * W);
    dense_layer<kBf16>(cur, Ws, W, w.wt_tx + (size_t)j * W * W, W, nullptr, nxt, Ws, false,
                       nullptr, stage);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, Ws, W, n, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads) dzt_part[j * W + c] = colsum[c];
  }
  apply_mask(cur, Ws, W, mask_of(m_vd));           // cur = g_v
  stash(cur, W, st.g_v);
  // viewdir: the direction encodings' cotangent g_v @ Wvd_b^T per point
  // (into enc, free since the forward, kPeStride a row), then its chain rule
  dense_layer<kBf16>(cur, Ws, W, w.wt_vd_b, pe_width(d.l_dir), nullptr, enc, kPeStride, false,
                     nullptr, stage);
  if (kBf16 && !exact_pe) encode_backward_points_bf16(vd, enc, kPeStride, d.l_dir, n, dvd);
  else encode_backward_points(vd, enc, kPeStride, d.l_dir, n, dvd);
  // encoding_shape output e feeds both the viewdir layer and the sigma head
  dense_layer<kBf16>(cur, Ws, W, w.wt_vd_a, W, nullptr, nxt, Ws, false, nullptr, stage);
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const float g_sig = rd(dsig[r] * sigmoid(logit[r]));     // softplus' = sigmoid
    for (int c = lane; c < W; c += 32) nxt[r * Ws + c] = fmaf(g_sig, w.w_sg[c], nxt[r * Ws + c]);
  }
  __syncthreads();
  { float* t = cur; cur = nxt; nxt = t; }         // cur = g_e
  stash(cur, W, st.g_e);
  dense_layer<kBf16>(cur, Ws, W, w.wt_es, W, nullptr, nxt, Ws, false, nullptr, stage);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = d.n_shape - 1; j >= 0; --j) {
    apply_mask(cur, Ws, W, mask_of(1 + j));
    stash(cur, W, st.g_sh + j * W);
    dense_layer<kBf16>(cur, Ws, W, w.wt_sh + (size_t)j * W * W, W, nullptr, nxt, Ws, false,
                       nullptr, stage);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, Ws, W, n, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads) dzs_part[j * W + c] = colsum[c];
  }
  apply_mask(cur, Ws, W, mask_of(0));
  stash(cur, W, st.g_xyz);
  // the points' cotangents: g @ Wxyz^T (into nxt, kPeStride a row), then the
  // encoding's chain rule
  dense_layer<kBf16>(cur, Ws, W, w.wt_xyz, pe_width(d.l_xyz), nullptr, nxt, kPeStride, false,
                     nullptr, stage);
  if (kBf16 && !exact_pe) encode_backward_points_bf16(xyz, nxt, kPeStride, d.l_xyz, n, dxyz);
  else encode_backward_points(xyz, nxt, kPeStride, d.l_xyz, n, dxyz);
}

}  // namespace supnerf
