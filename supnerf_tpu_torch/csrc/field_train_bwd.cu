// K7: training backward of the per-point field (K5), first half: everything
// but the cross-block reduction of the decoder weight gradients.
//
// Replaces, together with K4 (wgrad.cu), the TPU kernel
// supnerf_tpu/ops/pallas_field.py:_field_train_bwd_kernel (pallas_call in
// _train_bwd_call, the backward of field_train_pallas's custom_vjp). Inputs:
// the points and directions K5 saw, the per-object latents, and the
// cotangents of K5's outputs, dsigma (B, M, 1) and drgb (B, M, 3). Outputs:
// dxyz and dviewdir (B, M, 3) per point; per-block partial sums of dz_shape
// (B, nblk, n_shape, W) and dz_tex (B, nblk, n_tex, W), which the wrapper
// sums over blocks in a fixed order; and the stash rows from which K4 forms
// all 17 weight and bias gradients.
//
// Per block of kRows = 64 points of one object (grid (ceil(M / 64), B)) it
// does K6's work (field_bwd.cu) through the same kernel,
// field_point_bwd_kernel in render_common.cuh: the forward recompute with every ReLU's sign pattern
// kept as bits, the transposed chain, the per-point direction cotangent and
// the encoding's chain rule for dxyz and dviewdir. As K3 does
// (render_train_bwd.cu) it also writes each point's layer inputs a_* and
// pre-activation gradients g_* into one stash row (StashLayout); where K3
// writes the viewdir layer's direction input once per ray, every point here
// has its own, so its 27-wide direction encoding goes into the point's row
// (a_dpe) and K4's direction-weight problem is A = a_dpe, G = g_v over
// points. The Pallas kernel sums the weight gradients in 17 VMEM-resident
// accumulators across a sequential grid; a CUDA grid has no order, and a
// resume must repeat a loss bit for bit, so no atomics: K4 reduces the
// stash deterministically. The last block's missing rows are left out of
// the stash, the outputs and the column sums.
//
// What bounds it on the H100: arithmetic, as K6. The forward recompute is
// about 0.90 MFLOP per point (K5's count without the rgb head), the
// transposed chain another 0.89 MFLOP plus 2 x 27 x 256 for the per-point
// direction cotangent, against 40 bytes of points and cotangents read, 24
// bytes of dxyz and dviewdir written and a 15.7 KB stash row (W 256, 3 shape
// blocks, 1 texture block) written to device memory: at 3.35 TB/s the stash
// costs ~4.7 us per 1000 points against ~27 us of float32 FMAs at the
// 67 TFLOP/s peak. The design is K6's: float32 CUDA-core FMAs with the
// block's activations in shared memory; tensor cores are later work.
#include "render_common.cuh"

// Plain C entry, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises or allocates.
extern "C" int supnerf_field_train_bwd(const float* xyz, const float* vd, const float* zs,
                                       const float* zt, const supnerf::DecoderWeights* w,
                                       int B, int M, int W, int n_shape, int n_tex, int l_xyz,
                                       int l_dir, const float* g_sigma, const float* g_rgb,
                                       const supnerf::StashLayout* stash, float* dxyz,
                                       float* dvd, float* dzs_part, float* dzt_part,
                                       void* stream) {
  using namespace supnerf;
  const Dims d{B, M, kRows, W, n_shape, n_tex, l_xyz, l_dir};
  const size_t smem = field_point_bwd_smem_bytes(W, n_shape, n_tex);
  cudaError_t err = cudaFuncSetAttribute(
      field_point_bwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  field_point_bwd_kernel<true><<<dim3((M + kRows - 1) / kRows, B), kThreads, smem,
                                 (cudaStream_t)stream>>>(
      xyz, vd, zs, zt, *w, d, g_sigma, g_rgb, *stash, dxyz, dvd, dzs_part, dzt_part);
  return (int)cudaGetLastError();
}
