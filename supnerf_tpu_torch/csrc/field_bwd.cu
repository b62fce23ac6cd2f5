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
// points and cotangents read and 24 bytes written. So the design is K2's:
// - the forward recompute is K5's chain (render_common.cuh:field_chain:
//   every dense layer on dense_mma, every ReLU layer with its kRefine step,
//   the viewdir layer with the direction encodings as a second operand
//   pair), so the gates differentiated here are the ones K5's forward took;
// - the transposed chain runs on dense_mma too (rgb_hidden, the texture
//   blocks, the viewdir layer's trunk and direction-encoding rows,
//   encoding_shape, the shape blocks and the first layer's 63 encoding
//   columns), the ReLU masks applied and the latents' column sums taken
//   per row. The direction rows' product g_v @ Wvd_b^T (64 x 256 x 27,
//   ~1.5 % of the products, on 4 of the 8 warps) reads Wvd_b's transposed
//   copy wt_vd_b; one warp reduction per point and encoding column on the
//   CUDA cores, a chain of dependent loads, was slower.
// Shared memory: K2's layout with the point encodings at kPeLd, ~223 KB at
// W 256 with 3 shape blocks and 1 texture block, the weight rings and 7
// ReLU masks included, one block of 8 warps per SM. The direction
// encodings would not fit beside it, so they replace the point encodings
// in the same buffer once the first layer has read them, and both
// encodings' chain rules recompute their sines and cosines from the raw
// points and directions (encode_backward_points).
#include "render_common.cuh"

namespace supnerf {

__global__ void __launch_bounds__(kThreads, 1)
field_bwd_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                 const float* __restrict__ zs, const float* __restrict__ zt, DecoderWeights w,
                 Dims d, const float* __restrict__ g_sigma, const float* __restrict__ g_rgb,
                 float* __restrict__ dxyz, float* __restrict__ dvd,
                 float* __restrict__ dzs_part, float* __restrict__ dzt_part) {
  const int blk = blockIdx.x, obj = blockIdx.y, nblk = gridDim.x;
  const int W = d.W, W2 = d.W / 2, M = d.R;          // d.R: points per object
  const int nj = W / 32;
  const size_t p0 = (size_t)obj * M + (size_t)blk * kRows;
  const int n = min(kRows, M - blk * kRows);          // this block's real rows
  const size_t part = (size_t)obj * nblk + blk;       // this block's partial-sum row
  const int n_masks = d.n_shape + d.n_tex + 3;

  extern __shared__ float smem[];
  const int Ws = W + kMmaPad;                  // activation row stride
  float* stage = smem;                         // kMmaStageFloats, dense_mma's weight slices
  float* buf_a = stage + kMmaStageFloats;      // kRows x Ws
  float* buf_b = buf_a + kRows * Ws;           // kRows x Ws
  float* enc = buf_b + kRows * Ws;             // kRows x kPeLd (later: scratch)
  float* colsum = enc + kRows * kPeLd;         // W
  float* logit = colsum + W;                   // kRows
  float* dsig = logit + kRows;                 // kRows
  float* drgb = dsig + kRows;                  // kRows x 3
  uint32_t* masks = reinterpret_cast<uint32_t*>(drgb + kRows * 3);  // n_masks x kRows x nj
  // mask slots as field_chain fills them: 0 = encoding_xyz, 1..n_shape =
  // shape blocks, then viewdir, texture blocks, rgb_hidden
  auto mask_of = [&](int layer) { return masks + (size_t)layer * kRows * nj; };
  const int m_vd = d.n_shape + 1, m_tx0 = d.n_shape + 2, m_r1 = n_masks - 1;

  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const bool real = r < n;
    dsig[r] = real ? g_sigma[p0 + r] : 0.f;
    drgb[3 * r] = real ? g_rgb[(p0 + r) * 3] : 0.f;
    drgb[3 * r + 1] = real ? g_rgb[(p0 + r) * 3 + 1] : 0.f;
    drgb[3 * r + 2] = real ? g_rgb[(p0 + r) * 3 + 2] : 0.f;
  }
  // ---- forward recompute, ReLU patterns to shared memory (syncs) ---------
  field_chain(xyz + p0 * 3, vd + p0 * 3, n, zs + (size_t)obj * d.n_shape * W,
              zt + (size_t)obj * d.n_tex * W, w, d, stage, buf_a, buf_b, enc, logit, masks);

  // ---- transposed decoder chain ------------------------------------------
  // rgb_out: g_hh[r][c] = relu'(hh) * sum_k drgb[r][k] w_r2[c][k]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kRows; r += kThreads / 32)
    for (int c = lane; c < W2; c += 32)
      buf_a[r * Ws + c] = drgb[3 * r] * w.w_r2[3 * c] + drgb[3 * r + 1] * w.w_r2[3 * c + 1]
                          + drgb[3 * r + 2] * w.w_r2[3 * c + 2];
  __syncthreads();
  apply_mask<true>(buf_a, Ws, W2, mask_of(m_r1));
  dense_mma(buf_a, Ws, W2, w.wt_r1, W, nullptr, buf_b, Ws, false, nullptr, stage);
  float* cur = buf_b;
  float* nxt = buf_a;
  for (int j = d.n_tex - 1; j >= 0; --j) {
    apply_mask<true>(cur, Ws, W, mask_of(m_tx0 + j));
    dense_mma(cur, Ws, W, w.wt_tx + (size_t)j * W * W, W, nullptr, nxt, Ws, false, nullptr,
              stage);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, Ws, W, n, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads)
      dzt_part[(part * d.n_tex + j) * W + c] = colsum[c];
  }
  apply_mask<true>(cur, Ws, W, mask_of(m_vd));           // cur = g_v
  // viewdir: the direction encodings' cotangent g_v @ Wvd_b^T per point
  // (into enc, free since the forward, kPeStride a row), then its chain rule
  dense_mma(cur, Ws, W, w.wt_vd_b, pe_width(d.l_dir), nullptr, enc, kPeStride, false, nullptr,
            stage);
  encode_backward_points(vd + p0 * 3, enc, kPeStride, d.l_dir, n, dvd + p0 * 3);
  // encoding_shape output e feeds both the viewdir layer and the sigma head
  dense_mma(cur, Ws, W, w.wt_vd_a, W, nullptr, nxt, Ws, false, nullptr, stage);
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const float g_sig = dsig[r] * sigmoid(logit[r]);     // softplus' = sigmoid
    for (int c = lane; c < W; c += 32) nxt[r * Ws + c] = fmaf(g_sig, w.w_sg[c], nxt[r * Ws + c]);
  }
  __syncthreads();
  { float* t = cur; cur = nxt; nxt = t; }                 // cur = g_e
  dense_mma(cur, Ws, W, w.wt_es, W, nullptr, nxt, Ws, false, nullptr, stage);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = d.n_shape - 1; j >= 0; --j) {
    apply_mask<true>(cur, Ws, W, mask_of(1 + j));
    dense_mma(cur, Ws, W, w.wt_sh + (size_t)j * W * W, W, nullptr, nxt, Ws, false, nullptr,
              stage);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, Ws, W, n, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads)
      dzs_part[(part * d.n_shape + j) * W + c] = colsum[c];
  }
  apply_mask<true>(cur, Ws, W, mask_of(0));
  // the points' cotangents: g @ Wxyz^T (into nxt, kPeStride a row), then the
  // encoding's chain rule
  dense_mma(cur, Ws, W, w.wt_xyz, pe_width(d.l_xyz), nullptr, nxt, kPeStride, false, nullptr,
            stage);
  encode_backward_points(xyz + p0 * 3, nxt, kPeStride, d.l_xyz, n, dxyz + p0 * 3);
}

size_t field_bwd_smem_bytes(int W, int n_shape, int n_tex) {
  const size_t floats = (size_t)kMmaStageFloats + 2 * kRows * (W + kMmaPad) + kRows * kPeLd
                        + W + kRows * 5;
  const size_t words = (size_t)(n_shape + n_tex + 3) * kRows * (W / 32);
  return sizeof(float) * floats + sizeof(uint32_t) * words;
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
  const size_t smem = field_bwd_smem_bytes(W, n_shape, n_tex);
  cudaError_t err = cudaFuncSetAttribute(
      field_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  field_bwd_kernel<<<dim3((M + kRows - 1) / kRows, B), kThreads, smem,
                     (cudaStream_t)stream>>>(
      xyz, vd, zs, zt, *w, d, g_sigma, g_rgb, dxyz, dvd, dzs_part, dzt_part);
  return (int)cudaGetLastError();
}
