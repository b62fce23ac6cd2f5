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
// partials in XLA; deterministic, no atomics). The decoder weights get no
// gradient (TTO freezes the network).
//
// Per block of kRows = 64 points of one object (grid (ceil(M / 64), B)), as
// K2 does per ray: recompute the chain with every ReLU's sign pattern kept
// as bits, then run the transposed chain. The kernel,
// field_point_bwd_kernel in render_common.cuh, is shared with K7
// (field_train_bwd.cu), which also writes the training stash; K6
// instantiates it without. What differs from K2: no compositing, so the
// cotangents enter directly, and the direction encoding is per point.
//
// What bounds it on the H100: arithmetic, as K2. The forward recompute is
// about 0.90 MFLOP per point (K5's count), the transposed chain another
// 0.89 MFLOP (render_bwd.cu's count) plus 2 x 27 x 256 for the per-point
// direction cotangent: about 1.8 MFLOP per point against 40 bytes of
// points and cotangents read and 24 bytes written. The design is K2's:
// float32 CUDA-core FMAs with the block's activations in shared memory;
// tensor cores are later work.
#include "render_common.cuh"

// Plain C entry, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises or allocates.
extern "C" int supnerf_field_bwd(const float* xyz, const float* vd, const float* zs,
                                 const float* zt, const supnerf::DecoderWeights* w, int B,
                                 int M, int W, int n_shape, int n_tex, int l_xyz, int l_dir,
                                 const float* g_sigma, const float* g_rgb, float* dxyz,
                                 float* dvd, float* dzs_part, float* dzt_part, void* stream) {
  using namespace supnerf;
  const Dims d{B, M, kRows, W, n_shape, n_tex, l_xyz, l_dir};
  const size_t smem = field_point_bwd_smem_bytes(W, n_shape, n_tex);
  cudaError_t err = cudaFuncSetAttribute(
      field_point_bwd_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  field_point_bwd_kernel<false><<<dim3((M + kRows - 1) / kRows, B), kThreads, smem,
                                  (cudaStream_t)stream>>>(
      xyz, vd, zs, zt, *w, d, g_sigma, g_rgb, StashLayout{}, dxyz, dvd, dzs_part, dzt_part);
  return (int)cudaGetLastError();
}
