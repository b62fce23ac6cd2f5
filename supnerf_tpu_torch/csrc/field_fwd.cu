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
// Design: K1's, one block per kRows = 64 consecutive points of one object
// (grid (ceil(M / 64), B)), their activations in shared memory across all
// nine layers, the last block's missing rows zero-encoded and never
// written. Unlike K1, the direction term of the viewdir layer is per point:
// a (64 x 27) @ (27 x W) dense layer on the direction encodings, into which
// the trunk's (64 x W) @ (W x W) product is accumulated before the ReLU.
//
// What bounds it on the H100: arithmetic. Per point the decoder takes
// 442,752 multiply-adds (render_fwd.cu's count at W 256, 3 shape blocks, 1
// texture block) plus 27 x 256 = 6,912 for the per-point direction term,
// about 0.90 MFLOP, against 24 bytes of point and direction read and 16
// bytes written: tens of thousands of FLOP per byte. As in K1 the layers
// run as float32 FMAs on the CUDA cores (67 TFLOP/s peak) with the weights
// read through L1/L2; tensor cores are later work.
#include "render_common.cuh"

namespace supnerf {

__global__ void __launch_bounds__(kThreads, 1)
field_fwd_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                 const float* __restrict__ zs, const float* __restrict__ zt,
                 DecoderWeights w, Dims d, float* __restrict__ out_sigma,
                 float* __restrict__ out_rgb) {
  const int blk = blockIdx.x, obj = blockIdx.y;
  const int W = d.W, W2 = d.W / 2, M = d.R;          // d.R: points per object
  const size_t p0 = (size_t)obj * M + (size_t)blk * kRows;
  const int n = min(kRows, M - blk * kRows);          // this block's real rows

  extern __shared__ float smem[];
  float* buf_a = smem;                       // kRows x W
  float* buf_b = buf_a + kRows * W;          // kRows x W
  float* pe = buf_b + kRows * W;             // kRows x kPeStride, point encodings
  float* dpe = pe + kRows * kPeStride;       // kRows x kPeStride, direction encodings
  float* sig = dpe + kRows * kPeStride;      // kRows
  float* rgb = sig + kRows;                  // kRows x 3

  encode_points(xyz + p0 * 3, n, d.l_xyz, pe);
  encode_points(vd + p0 * 3, n, d.l_dir, dpe);
  __syncthreads();

  dense(pe, kPeStride, pe_width(d.l_xyz), w.w_xyz, W, w.b_xyz, buf_a, W, true, nullptr);
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int j = 0; j < d.n_shape; ++j) {
    add_row_vector(cur, W, W, zs + ((size_t)obj * d.n_shape + j) * W);
    dense(cur, W, W, w.w_sh + (size_t)j * W * W, W, w.b_sh + j * W, nxt, W, true, nullptr);
    float* t = cur; cur = nxt; nxt = t;
  }
  dense(cur, W, W, w.w_es, W, w.b_es, nxt, W, false, nullptr);
  { float* t = cur; cur = nxt; nxt = t; }
  head(cur, W, W, w.w_sg, 1, w.b_sg, sig);
  // viewdir layer: relu(e @ Wvd_a + dpe @ Wvd_b + b_vd), the direction term first
  dense(dpe, kPeStride, pe_width(d.l_dir), w.w_vd_b, W, w.b_vd, nxt, W, false, nullptr);
  dense(cur, W, W, w.w_vd_a, W, nullptr, nxt, W, true, nullptr, true);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = 0; j < d.n_tex; ++j) {
    add_row_vector(cur, W, W, zt + ((size_t)obj * d.n_tex + j) * W);
    dense(cur, W, W, w.w_tx + (size_t)j * W * W, W, w.b_tx + j * W, nxt, W, true, nullptr);
    float* t = cur; cur = nxt; nxt = t;
  }
  dense(cur, W, W, w.w_r1, W2, w.b_r1, nxt, W2, true, nullptr);
  head(nxt, W2, W2, w.w_r2, 3, w.b_r2, rgb);

  for (int r = threadIdx.x; r < n; r += kThreads) {
    out_sigma[p0 + r] = softplus(sig[r]);
    out_rgb[(p0 + r) * 3] = rgb[3 * r];
    out_rgb[(p0 + r) * 3 + 1] = rgb[3 * r + 1];
    out_rgb[(p0 + r) * 3 + 2] = rgb[3 * r + 2];
  }
}

size_t field_fwd_smem_bytes(int W) {
  return sizeof(float) * ((size_t)2 * kRows * W + 2 * kRows * kPeStride + kRows * 4);
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
  const size_t smem = field_fwd_smem_bytes(W);
  cudaError_t err = cudaFuncSetAttribute(
      field_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  field_fwd_kernel<<<dim3((M + kRows - 1) / kRows, B), kThreads, smem, (cudaStream_t)stream>>>(
      xyz, vd, zs, zt, *w, d, out_sigma, out_rgb);
  return (int)cudaGetLastError();
}
