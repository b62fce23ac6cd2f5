// K5: per-point forward of the conditioned field, with no compositing.
//
// Replaces the TPU kernels supnerf_tpu/ops/pallas_field.py:_field_kernel
// (pallas_call in _fwd_pallas_call: field_forward_pallas with pe_in_kernel
// False, and the primal of field_apply_pallas) and
// pallas_field.py:_field_kernel_raw (pallas_call in _fwd_pallas_call_raw:
// field_forward_pallas with pe_in_kernel True). The two differ only in where
// the positional encodings are computed; this kernel always encodes in the
// kernel from the raw points and directions, as K1 does, so it is the port
// of both.
// Same function: for every point of every object, the CodeNeRF decoder on
// the point's 63-wide encoding (encoding_xyz, shape blocks each adding
// z_shape[j], encoding_shape, softplus sigma head, the viewdir layer on the
// trunk and the point's own 27-wide direction encoding, texture blocks
// adding z_tex[j], rgb_hidden, rgb_out) -> sigma (B, M, 1), rgb (B, M, 3).
// The points are the TTO regularisers' (the symmetry loss's loss render and
// its mirror, the object-size loss's box-plane samples), so each point has
// its own direction, and M need not be a multiple of a block.
//
// Design: K1's (render_fwd.cu), one block per kRows = 64 consecutive
// points of one object (grid (ceil(M / 64), B)), their activations in
// shared memory across all nine layers at a row stride of W + kMmaPad, the
// last block's missing rows zero-encoded and never written. The chain is
// render_common.cuh:field_chain, which K6 (field_bwd.cu) and K7
// (field_train_bwd.cu) run too, so they differentiate at the gates this
// kernel took, its exact step included.
//
// What bounds it on the H100: arithmetic. Per point the decoder takes
// 442,752 multiply-adds (render_fwd.cu's count at W 256, 3 shape blocks, 1
// texture block) plus 27 x 256 = 6,912 for the per-point direction term,
// about 0.90 MFLOP, against 24 bytes of point and direction read and 16
// bytes written: tens of thousands of FLOP per byte. So, as in K1, every
// dense layer runs on dense_mma (3xTF32 mma.sync, the output columns split
// across the warps, each warp's slice of the weights streamed through its
// own cp.async ring, every k-step's tensor-core sum added in float32), and
// every ReLU layer takes its kRefine step (a pre-activation within 2^-20 of
// its row's scale from zero recomputed in float64, and a row with such a
// value nearer zero than kExactRtol of its terms' magnitude through
// field_chain's exact step: that layer's row from the float64 chain, so the
// gates are the exact function's). Unlike K1 the
// direction term of the viewdir layer is per point: the layer takes the
// points' direction encodings as dense_mma's second operand pair (kDir),
// whose k-steps run after the trunk's into the same sums, so the whole
// pre-activation, direction term included, is in registers when the gate is
// taken and inside the float64 recompute. The point encodings, then the
// direction encodings, sit in one buffer at kPeLd floats a row. Shared
// memory (~208 KB at W 256, the weight rings included) allows one block of
// 8 warps per SM; the sigma and rgb heads stay on the CUDA cores. The body
// is render_common.cuh:field_forward, which field_gates.cu also builds with
// the ReLU gates written out, for a check.
//
// The bfloat16 mode (field_fwd_bf16_kernel: field_forward with kBf16): the
// Pallas kernel at dtype=bfloat16 (render_common.cuh's note), the
// encodings by the doubling recurrence (A7's XLA-side encodings) or with
// exact_pe the exact ones (A11b), every dense layer on dense_mma_bf16.
#include "render_common.cuh"

namespace supnerf {

__global__ void __launch_bounds__(kThreads, 1)
field_fwd_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                 const float* __restrict__ zs, const float* __restrict__ zt,
                 const __grid_constant__ DecoderWeights w, const __grid_constant__ Dims d,
                 float* __restrict__ out_sigma, float* __restrict__ out_rgb) {
  const int blk = blockIdx.x, obj = blockIdx.y;
  const int W = d.W, M = d.R;                        // d.R: points per object
  const size_t p0 = (size_t)obj * M + (size_t)blk * kRows;
  const int n = min(kRows, M - blk * kRows);          // this block's real rows
  extern __shared__ float smem[];
  field_forward<false>(xyz + p0 * 3, vd + p0 * 3, n, zs + (size_t)obj * d.n_shape * W,
                       zt + (size_t)obj * d.n_tex * W, w, d, smem, out_sigma + p0,
                       out_rgb + p0 * 3, nullptr);
}

__global__ void __launch_bounds__(kThreads, 1)
field_fwd_bf16_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                      const float* __restrict__ zs, const float* __restrict__ zt,
                      const __grid_constant__ DecoderWeights w, const __grid_constant__ Dims d,
                      int exact_pe, float* __restrict__ out_sigma, float* __restrict__ out_rgb) {
  const int blk = blockIdx.x, obj = blockIdx.y;
  const int W = d.W, M = d.R;                        // d.R: points per object
  const size_t p0 = (size_t)obj * M + (size_t)blk * kRows;
  const int n = min(kRows, M - blk * kRows);          // this block's real rows
  extern __shared__ float smem[];
  field_forward<false, true>(xyz + p0 * 3, vd + p0 * 3, n, zs + (size_t)obj * d.n_shape * W,
                             zt + (size_t)obj * d.n_tex * W, w, d, smem, out_sigma + p0,
                             out_rgb + p0 * 3, nullptr, exact_pe != 0);
}

}  // namespace supnerf

// Plain C entry, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises or allocates.
extern "C" int supnerf_field_fwd(const float* xyz, const float* vd, const float* zs,
                                 const float* zt, const supnerf::DecoderWeights* w, int B,
                                 int M, int W, int n_shape, int n_tex, int l_xyz, int l_dir,
                                 float* out_sigma, float* out_rgb, void* stream) {
  using namespace supnerf;
  const Dims d{B, M, kRows, W, n_shape, n_tex, l_xyz, l_dir};
  const size_t smem = field_forward_smem_bytes(W, n_shape, n_tex, false);
  cudaError_t err = cudaFuncSetAttribute(
      field_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  field_fwd_kernel<<<dim3((M + kRows - 1) / kRows, B), kThreads, smem, (cudaStream_t)stream>>>(
      xyz, vd, zs, zt, *w, d, out_sigma, out_rgb);
  return (int)cudaGetLastError();
}

// The bfloat16 mode's entry: supnerf_field_fwd's arguments, exact_pe after the outputs.
extern "C" int supnerf_field_fwd_bf16(const float* xyz, const float* vd, const float* zs,
                                      const float* zt, const supnerf::DecoderWeights* w, int B,
                                      int M, int W, int n_shape, int n_tex, int l_xyz,
                                      int l_dir, float* out_sigma, float* out_rgb, int exact_pe,
                                      void* stream) {
  using namespace supnerf;
  const Dims d{B, M, kRows, W, n_shape, n_tex, l_xyz, l_dir};
  const size_t smem = field_forward_smem_bytes(W, n_shape, n_tex, false);
  cudaError_t err = cudaFuncSetAttribute(
      field_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  field_fwd_bf16_kernel<<<dim3((M + kRows - 1) / kRows, B), kThreads, smem,
                          (cudaStream_t)stream>>>(xyz, vd, zs, zt, *w, d, exact_pe, out_sigma,
                                                  out_rgb);
  return (int)cudaGetLastError();
}
