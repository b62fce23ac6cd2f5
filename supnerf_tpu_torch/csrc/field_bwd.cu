// K6: backward of the per-point field (K5) for a frozen decoder.
//
// Replaces the TPU kernel supnerf_tpu/ops/pallas_field.py:_field_bwd_kernel
// (pallas_call in _bwd_pallas_call, the backward of field_apply_pallas's
// custom_vjp). Inputs: the points and directions K5 saw, the per-object
// latents, and the cotangents of K5's outputs, dsigma (B, M, 1) and drgb
// (B, M, 3). Outputs: dxyz and dviewdir (B, M, 3) per point, and per-block
// partial sums of dz_shape (B, nblk, n_shape, W) and dz_tex (B, nblk, n_tex,
// W), which the wrapper sums over blocks in a fixed order (the second pass
// of the cross-block reduction, as the TPU version sums its per-tile
// partials in XLA; deterministic, no atomics).
//
// Per block of kRows = 64 points of one object (grid (ceil(M / 64), B)), as
// K2 (render_bwd.cu) does per ray: recompute the chain with every ReLU's
// sign pattern kept as bits, then run the transposed chain. What differs
// from K2: no compositing, so the cotangents enter directly (dsigma through
// the softplus gate sigmoid(logit), drgb through rgb_out), and the
// direction encoding is per point. The decoder weights get no gradient
// (TTO freezes the network).
//
// What bounds it on the H100: arithmetic, as K2. The forward recompute is
// about 0.90 MFLOP per point (K5's count), the transposed chain another
// 0.89 MFLOP (render_bwd.cu's count) plus 2 x 27 x 256 for the per-point
// direction cotangent: about 1.8 MFLOP per point against 40 bytes of
// points and cotangents read and 24 bytes written. So the design is K2's,
// and its body is render_common.cuh:field_backward, which K7
// (field_train_bwd.cu) runs too, with its stash:
// - the forward recompute is K5's chain (render_common.cuh:field_chain:
//   every dense layer on dense_mma, every ReLU layer with its kRefine step,
//   the viewdir layer with the direction encodings as a second operand
//   pair, and its exact step: a row with a refined value nearer zero
//   than kExactRtol of its terms' magnitude gets that layer's output row
//   from the float64 chain, the exact function's gates), so the gates
//   differentiated here are the ones K5's forward took;
// - the transposed chain runs on dense_mma too (rgb_hidden, the texture
//   blocks, the viewdir layer's trunk and direction-encoding rows,
//   encoding_shape, the shape blocks and the first layer's 63 encoding
//   columns), the ReLU masks applied and the latents' column sums taken
//   per row. The direction rows' product g_v @ Wvd_b^T (64 x 256 x 27,
//   ~1.5 % of the products, on 4 of the 8 warps) reads Wvd_b's transposed
//   copy wt_vd_b; one warp reduction per point and encoding column on the
//   CUDA cores, a chain of dependent loads, was slower.
// Shared memory: K2's layout with the point encodings at kPeLd, 228,664 B
// at W 256 with 3 shape blocks and 1 texture block, the weight rings and 7
// ReLU masks included, one block of 8 warps per SM; the exact step's
// float64 rows use the activation buffer its layer has read. The direction
// encodings would not fit beside it, so they replace the point encodings
// in the same buffer once the first layer has read them, and both
// encodings' chain rules recompute their sines and cosines from the raw
// points and directions (encode_backward_points).
//
// The bfloat16 mode (field_bwd_bf16_kernel: field_backward with kBf16): the
// Pallas kernel at dtype=bfloat16 (pallas_field.py:_field_bwd_kernel;
// render_common.cuh's note), its recompute with the ReLU outputs rounded.
#include "render_common.cuh"

namespace supnerf {

__global__ void __launch_bounds__(kThreads, 1)
field_bwd_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                 const float* __restrict__ zs, const float* __restrict__ zt,
                 const __grid_constant__ DecoderWeights w, const __grid_constant__ Dims d,
                 const float* __restrict__ g_sigma, const float* __restrict__ g_rgb,
                 float* __restrict__ dxyz, float* __restrict__ dvd,
                 float* __restrict__ dzs_part, float* __restrict__ dzt_part) {
  const int blk = blockIdx.x, obj = blockIdx.y, nblk = gridDim.x;
  const int W = d.W, M = d.R;                         // d.R: points per object
  const size_t p0 = (size_t)obj * M + (size_t)blk * kRows;
  const int n = min(kRows, M - blk * kRows);          // this block's real rows
  const size_t part = (size_t)obj * nblk + blk;       // this block's partial-sum row
  extern __shared__ float smem[];
  field_backward<false, false>(xyz + p0 * 3, vd + p0 * 3, n, zs + (size_t)obj * d.n_shape * W,
                               zt + (size_t)obj * d.n_tex * W, w, d, g_sigma + p0,
                               g_rgb + p0 * 3, smem, dxyz + p0 * 3, dvd + p0 * 3,
                               dzs_part + part * d.n_shape * W, dzt_part + part * d.n_tex * W,
                               StashLayout{}, nullptr, nullptr);
}

__global__ void __launch_bounds__(kThreads, 1)
field_bwd_bf16_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                      const float* __restrict__ zs, const float* __restrict__ zt,
                      const __grid_constant__ DecoderWeights w, const __grid_constant__ Dims d,
                      const float* __restrict__ g_sigma, const float* __restrict__ g_rgb,
                      float* __restrict__ dxyz, float* __restrict__ dvd,
                      float* __restrict__ dzs_part, float* __restrict__ dzt_part) {
  const int blk = blockIdx.x, obj = blockIdx.y, nblk = gridDim.x;
  const int W = d.W, M = d.R;                         // d.R: points per object
  const size_t p0 = (size_t)obj * M + (size_t)blk * kRows;
  const int n = min(kRows, M - blk * kRows);          // this block's real rows
  const size_t part = (size_t)obj * nblk + blk;       // this block's partial-sum row
  extern __shared__ float smem[];
  field_backward<false, false, true>(
      xyz + p0 * 3, vd + p0 * 3, n, zs + (size_t)obj * d.n_shape * W,
      zt + (size_t)obj * d.n_tex * W, w, d, g_sigma + p0, g_rgb + p0 * 3, smem, dxyz + p0 * 3,
      dvd + p0 * 3, dzs_part + part * d.n_shape * W, dzt_part + part * d.n_tex * W,
      StashLayout{}, nullptr, nullptr);
}

}  // namespace supnerf

// Plain C entry, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises or allocates.
extern "C" int supnerf_field_bwd(const float* xyz, const float* vd, const float* zs,
                                 const float* zt, const supnerf::DecoderWeights* w, int B,
                                 int M, int W, int n_shape, int n_tex, int l_xyz, int l_dir,
                                 const float* g_sigma, const float* g_rgb, float* dxyz,
                                 float* dvd, float* dzs_part, float* dzt_part, void* stream) {
  using namespace supnerf;
  const Dims d{B, M, kRows, W, n_shape, n_tex, l_xyz, l_dir};
  const size_t smem = field_backward_smem_bytes(W, n_shape, n_tex);
  cudaError_t err = cudaFuncSetAttribute(
      field_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  field_bwd_kernel<<<dim3((M + kRows - 1) / kRows, B), kThreads, smem,
                     (cudaStream_t)stream>>>(
      xyz, vd, zs, zt, *w, d, g_sigma, g_rgb, dxyz, dvd, dzs_part, dzt_part);
  return (int)cudaGetLastError();
}

// The bfloat16 mode's entry: supnerf_field_bwd's arguments.
extern "C" int supnerf_field_bwd_bf16(const float* xyz, const float* vd, const float* zs,
                                      const float* zt, const supnerf::DecoderWeights* w, int B,
                                      int M, int W, int n_shape, int n_tex, int l_xyz,
                                      int l_dir, const float* g_sigma, const float* g_rgb,
                                      float* dxyz, float* dvd, float* dzs_part,
                                      float* dzt_part, void* stream) {
  using namespace supnerf;
  const Dims d{B, M, kRows, W, n_shape, n_tex, l_xyz, l_dir};
  const size_t smem = field_backward_smem_bytes(W, n_shape, n_tex);
  cudaError_t err = cudaFuncSetAttribute(
      field_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  field_bwd_bf16_kernel<<<dim3((M + kRows - 1) / kRows, B), kThreads, smem,
                          (cudaStream_t)stream>>>(xyz, vd, zs, zt, *w, d, g_sigma, g_rgb, dxyz,
                                                  dvd, dzs_part, dzt_part);
  return (int)cudaGetLastError();
}
