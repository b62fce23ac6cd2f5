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
// The Pallas kernel sums the weight gradients in 17 VMEM-resident
// accumulators across a sequential grid; a CUDA grid has no order, and a
// resume must repeat a loss bit for bit, so no atomics: as K3
// (render_train_bwd.cu) does, this kernel writes each point's layer inputs
// a_* and pre-activation gradients g_* into one stash row (StashLayout), and
// K4 reduces the stash deterministically. Where K3 writes the viewdir
// layer's direction input once per ray, every point here has its own, so
// its 27-wide direction encoding goes into the point's row (a_dpe) and K4's
// direction-weight problem is A = a_dpe, G = g_v over points.
//
// What bounds it on the H100: arithmetic. Per point it does K6's work
// (field_bwd.cu): the forward recompute, about 0.90 MFLOP (K5's count
// without the rgb head), and the transposed chain, another 0.89 MFLOP plus
// 2 x 27 x 256 for the per-point direction cotangent; 5.7 ms for the
// training field's 8 x 65,536 points on the tensor cores at float32
// accuracy (3xTF32), 14.1 ms at the float32 FMA peak. Against that it reads
// 40 bytes of points and cotangents and writes 24 bytes of dxyz and
// dviewdir and a 15.8 KB stash row (W 256, 3 shape blocks, 1 texture
// block) per point: 8.3 GB for those points, 2.5 ms at 3.35 TB/s.
//
// The design: K6's kernel body with the stash added, one device function
// for both (render_common.cuh:field_backward, kStash here). Its forward
// recompute is K5's chain (field_chain: every dense layer on dense_mma,
// every ReLU layer with its kRefine step, the direction term as the
// viewdir layer's second operand pair, and its exact step for the rows
// with a refined value nearest zero), so the gates this kernel
// differentiates, and stashes as zero columns of g_*, are K5's and K6's,
// and its dxyz,
// dviewdir, dz_shape and dz_tex are K6's bits. The stash copies
// (stash_rows, shared with K3: a warp per row, 16-byte streaming stores)
// read the W + kMmaPad-strided buffers between barriers;
// the point encodings before the first layer, the direction encodings
// before the transposed chain reuses their buffer. They need no shared
// memory of their own: the block's is K6's (228,664 B at W 256), one block
// of 8 warps per SM. The last block's missing rows are left out of the
// stash, the outputs and the column sums.
//
// The bfloat16 mode (field_train_bwd_bf16_kernel: field_backward with kBf16
// and exact_pe): the Pallas kernel at dtype=bfloat16. Its recompute is
// K6's bfloat16 arithmetic on the exact encodings that field_train_pallas
// computes outside the kernel, the ReLU outputs rounded (its bfloat16
// stash), every transposed layer's cotangent rounded where it enters a
// product; dz_shape and dz_tex the float32 sums of the unrounded products.
// The stash keeps the float32 layout: its A side bfloat16-exact (the
// operands the Pallas kernel's mm_xg casts: the rounded encodings and ReLU
// outputs, e and each latent-added input rounded as they are stored), its
// G side float32 and unrounded, since every bias gradient sums the float32
// cotangent; K4's bfloat16 entry rounds G where it enters a product. The
// Pallas kernel returns the encodings' cotangents, and XLA differentiates
// the float32 encoding: so dxyz and dviewdir take the float32 chain rule
// (encode_backward_points) on the unrounded cotangents, not K6's bfloat16
// one. It needs no other shared memory than the float32 build. What bounds
// it in the mode: the stash's bytes, 8.3 GB for 8 x 65,536 points, 2.5 ms at
// 3.35 TB/s, against about 1.8 MFLOP a point on the bfloat16 tensor cores,
// 0.96 ms at 989 TFLOP/s.
#include "render_common.cuh"

namespace supnerf {

// One block of kRows points of one object (grid (ceil(M / 64), B)), either
// mode: field_backward with the stash.
template <bool kBf16>
static __device__ __forceinline__ void field_train_bwd_block(
    const float* __restrict__ xyz, const float* __restrict__ vd, const float* __restrict__ zs,
    const float* __restrict__ zt, const DecoderWeights& w, const Dims& d,
    const float* __restrict__ g_sigma, const float* __restrict__ g_rgb, const StashLayout& st,
    float* __restrict__ dxyz, float* __restrict__ dvd, float* __restrict__ dzs_part,
    float* __restrict__ dzt_part) {
  const int blk = blockIdx.x, obj = blockIdx.y, nblk = gridDim.x;
  const int W = d.W, M = d.R;                         // d.R: points per object
  const size_t p0 = (size_t)obj * M + (size_t)blk * kRows;
  const int n = min(kRows, M - blk * kRows);          // this block's real rows
  const size_t part = (size_t)obj * nblk + blk;       // this block's partial-sum row
  extern __shared__ float smem[];
  if constexpr (kBf16)
    field_backward<true, false, true>(
        xyz + p0 * 3, vd + p0 * 3, n, zs + (size_t)obj * d.n_shape * W,
        zt + (size_t)obj * d.n_tex * W, w, d, g_sigma + p0, g_rgb + p0 * 3, smem, dxyz + p0 * 3,
        dvd + p0 * 3, dzs_part + part * d.n_shape * W, dzt_part + part * d.n_tex * W, st,
        st.pt + p0 * st.ld_pt, nullptr, true);
  else
    field_backward<true, false>(xyz + p0 * 3, vd + p0 * 3, n, zs + (size_t)obj * d.n_shape * W,
                                zt + (size_t)obj * d.n_tex * W, w, d, g_sigma + p0,
                                g_rgb + p0 * 3, smem, dxyz + p0 * 3, dvd + p0 * 3,
                                dzs_part + part * d.n_shape * W, dzt_part + part * d.n_tex * W,
                                st, st.pt + p0 * st.ld_pt, nullptr);
}

__global__ void __launch_bounds__(kThreads, 1) field_train_bwd_kernel(
    const float* __restrict__ xyz, const float* __restrict__ vd, const float* __restrict__ zs,
    const float* __restrict__ zt, const __grid_constant__ DecoderWeights w,
    const __grid_constant__ Dims d,
    const float* __restrict__ g_sigma, const float* __restrict__ g_rgb, StashLayout st,
    float* __restrict__ dxyz, float* __restrict__ dvd, float* __restrict__ dzs_part,
    float* __restrict__ dzt_part) {
  field_train_bwd_block<false>(xyz, vd, zs, zt, w, d, g_sigma, g_rgb, st, dxyz, dvd, dzs_part,
                               dzt_part);
}

__global__ void __launch_bounds__(kThreads, 1) field_train_bwd_bf16_kernel(
    const float* __restrict__ xyz, const float* __restrict__ vd, const float* __restrict__ zs,
    const float* __restrict__ zt, const __grid_constant__ DecoderWeights w,
    const __grid_constant__ Dims d,
    const float* __restrict__ g_sigma, const float* __restrict__ g_rgb, StashLayout st,
    float* __restrict__ dxyz, float* __restrict__ dvd, float* __restrict__ dzs_part,
    float* __restrict__ dzt_part) {
  field_train_bwd_block<true>(xyz, vd, zs, zt, w, d, g_sigma, g_rgb, st, dxyz, dvd, dzs_part,
                              dzt_part);
}

// Launches `kernel` (either build) on `stream`.
template <typename Kernel>
static int launch_field_train_bwd(Kernel kernel, const float* xyz, const float* vd,
                                  const float* zs, const float* zt, const DecoderWeights* w,
                                  const Dims& d, const float* g_sigma, const float* g_rgb,
                                  const StashLayout* stash, float* dxyz, float* dvd,
                                  float* dzs_part, float* dzt_part, void* stream) {
  const size_t smem = field_backward_smem_bytes(d.W, d.n_shape, d.n_tex);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((d.R + kRows - 1) / kRows, d.B), kThreads, smem, (cudaStream_t)stream>>>(
      xyz, vd, zs, zt, *w, d, g_sigma, g_rgb, *stash, dxyz, dvd, dzs_part, dzt_part);
  return (int)cudaGetLastError();
}

}  // namespace supnerf

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
  return launch_field_train_bwd(field_train_bwd_kernel, xyz, vd, zs, zt, w,
                                Dims{B, M, kRows, W, n_shape, n_tex, l_xyz, l_dir}, g_sigma,
                                g_rgb, stash, dxyz, dvd, dzs_part, dzt_part, stream);
}

// The bfloat16 mode's entry: supnerf_field_train_bwd's arguments.
extern "C" int supnerf_field_train_bwd_bf16(const float* xyz, const float* vd, const float* zs,
                                            const float* zt, const supnerf::DecoderWeights* w,
                                            int B, int M, int W, int n_shape, int n_tex,
                                            int l_xyz, int l_dir, const float* g_sigma,
                                            const float* g_rgb,
                                            const supnerf::StashLayout* stash, float* dxyz,
                                            float* dvd, float* dzs_part, float* dzt_part,
                                            void* stream) {
  using namespace supnerf;
  return launch_field_train_bwd(field_train_bwd_bf16_kernel, xyz, vd, zs, zt, w,
                                Dims{B, M, kRows, W, n_shape, n_tex, l_xyz, l_dir}, g_sigma,
                                g_rgb, stash, dxyz, dvd, dzs_part, dzt_part, stream);
}
