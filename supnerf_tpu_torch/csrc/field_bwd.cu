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
// as bits (__ballot_sync, 2 KB per layer, on chip), then run the transposed
// chain. What differs from K2: no compositing, so the cotangents enter
// directly (dsigma through the softplus gate sigmoid(pre-activation), drgb
// through rgb_out); the direction encoding is per point, so the viewdir
// layer's direction cotangent is a (64 x W) @ (W x 27) product, one warp
// reduction per row and encoding column, followed by the encoding's chain
// rule per point; the last block's missing rows have zero cotangents and
// are left out of the column sums and the outputs.
//
// What bounds it on the H100: arithmetic, as K2. The forward recompute is
// about 0.90 MFLOP per point (K5's count), the transposed chain another
// 0.89 MFLOP (render_bwd.cu's count) plus 2 x 27 x 256 for the per-point
// direction cotangent: about 1.8 MFLOP per point against 40 bytes of
// points and cotangents read and 24 bytes written. The design is K2's:
// float32 CUDA-core FMAs with the block's activations in shared memory;
// tensor cores are later work.
#include "render_common.cuh"

namespace supnerf {

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

__global__ void __launch_bounds__(kThreads, 1)
field_bwd_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                 const float* __restrict__ zs, const float* __restrict__ zt,
                 DecoderWeights w, Dims d, const float* __restrict__ g_sigma,
                 const float* __restrict__ g_rgb, float* __restrict__ dxyz,
                 float* __restrict__ dvd, float* __restrict__ dzs_part,
                 float* __restrict__ dzt_part) {
  const int blk = blockIdx.x, obj = blockIdx.y, nblk = gridDim.x;
  const int W = d.W, W2 = d.W / 2, M = d.R;          // d.R: points per object
  const int nj = W / 32;
  const size_t p0 = (size_t)obj * M + (size_t)blk * kRows;
  const int n = min(kRows, M - blk * kRows);          // this block's real rows
  const size_t part = (size_t)obj * nblk + blk;       // this block's partial-sum row
  const int n_masks = d.n_shape + d.n_tex + 3;

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
  // stash slots: 0 = encoding_xyz, 1..n_shape = shape blocks, then viewdir,
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

  // ---- forward recompute, stashing ReLU patterns -------------------------
  dense(pe, kPeStride, pe_width(d.l_xyz), w.w_xyz, W, w.b_xyz, buf_a, W, true, mask_of(0));
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int j = 0; j < d.n_shape; ++j) {
    add_row_vector(cur, W, W, zs + ((size_t)obj * d.n_shape + j) * W);
    dense(cur, W, W, w.w_sh + (size_t)j * W * W, W, w.b_sh + j * W, nxt, W, true,
          mask_of(1 + j));
    float* t = cur; cur = nxt; nxt = t;
  }
  dense(cur, W, W, w.w_es, W, w.b_es, nxt, W, false, nullptr);
  { float* t = cur; cur = nxt; nxt = t; }
  head(cur, W, W, w.w_sg, 1, w.b_sg, logit);
  dense(dpe, kPeStride, pe_width(d.l_dir), w.w_vd_b, W, w.b_vd, nxt, W, false, nullptr);
  dense(cur, W, W, w.w_vd_a, W, nullptr, nxt, W, true, mask_of(m_vd), true);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = 0; j < d.n_tex; ++j) {
    add_row_vector(cur, W, W, zt + ((size_t)obj * d.n_tex + j) * W);
    dense(cur, W, W, w.w_tx + (size_t)j * W * W, W, w.b_tx + j * W, nxt, W, true,
          mask_of(m_tx0 + j));
    float* t = cur; cur = nxt; nxt = t;
  }
  // rgb_hidden: only its ReLU pattern is needed (rgb_out is linear)
  dense(cur, W, W, w.w_r1, W2, w.b_r1, nxt, W2, true, mask_of(m_r1));

  // ---- transposed decoder chain ------------------------------------------
  // rgb_out: g_hh[r][c] = relu'(hh) * sum_k drgb[r][k] w_r2[c][k]
  for (int e = threadIdx.x; e < kRows * W2; e += kThreads) {
    const int r = e / W2, c = e - r * W2;
    buf_a[r * W2 + c] = drgb[3 * r] * w.w_r2[3 * c] + drgb[3 * r + 1] * w.w_r2[3 * c + 1]
                        + drgb[3 * r + 2] * w.w_r2[3 * c + 2];
  }
  __syncthreads();
  apply_mask(buf_a, W2, W2, mask_of(m_r1));
  dense(buf_a, W2, W2, w.wt_r1, W, nullptr, buf_b, W, false, nullptr);
  cur = buf_b; nxt = buf_a;
  for (int j = d.n_tex - 1; j >= 0; --j) {
    apply_mask(cur, W, W, mask_of(m_tx0 + j));
    dense(cur, W, W, w.wt_tx + (size_t)j * W * W, W, nullptr, nxt, W, false, nullptr);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, W, W, n, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads)
      dzt_part[(part * d.n_tex + j) * W + c] = colsum[c];
  }
  apply_mask(cur, W, W, mask_of(m_vd));            // cur = g_v
  // viewdir: the direction encoding's cotangent g_v @ Wvd_b^T per point (into
  // nxt, free until the trunk's transposed product below), then its chain rule
  const int d_dir = pe_width(d.l_dir);
  rows_times_transpose(cur, W, n, w.w_vd_b, d_dir, nxt);
  for (int r = threadIdx.x; r < n; r += kThreads) {
    float dv[3];
    encode_backward_one(dpe + r * kPeStride, nxt + r * kPeStride, d.l_dir, dv);
    float* o = dvd + (p0 + r) * 3;
    o[0] = dv[0]; o[1] = dv[1]; o[2] = dv[2];
  }
  __syncthreads();
  // encoding_shape output e feeds both the viewdir layer and the sigma head
  dense(cur, W, W, w.wt_vd_a, W, nullptr, nxt, W, false, nullptr);
  for (int e = threadIdx.x; e < kRows * W; e += kThreads) {
    const int r = e / W, c = e - r * W;
    const float g_sig = dsig[r] * sigmoid(logit[r]);     // softplus' = sigmoid
    nxt[r * W + c] = fmaf(g_sig, w.w_sg[c], nxt[r * W + c]);
  }
  __syncthreads();
  { float* t = cur; cur = nxt; nxt = t; }
  dense(cur, W, W, w.wt_es, W, nullptr, nxt, W, false, nullptr);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = d.n_shape - 1; j >= 0; --j) {
    apply_mask(cur, W, W, mask_of(1 + j));
    dense(cur, W, W, w.wt_sh + (size_t)j * W * W, W, nullptr, nxt, W, false, nullptr);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, W, W, n, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads)
      dzs_part[(part * d.n_shape + j) * W + c] = colsum[c];
  }
  apply_mask(cur, W, W, mask_of(0));
  const int d_xyz = pe_width(d.l_xyz);
  dense(cur, W, W, w.wt_xyz, d_xyz, nullptr, nxt, kPeStride, false, nullptr);
  for (int r = threadIdx.x; r < n; r += kThreads) {
    float dx[3];
    encode_backward_one(pe + r * kPeStride, nxt + r * kPeStride, d.l_xyz, dx);
    float* o = dxyz + (p0 + r) * 3;
    o[0] = dx[0]; o[1] = dx[1]; o[2] = dx[2];
  }
}

size_t field_bwd_smem_bytes(int W, int n_shape, int n_tex) {
  const size_t floats = (size_t)2 * kRows * W + 2 * kRows * kPeStride + W + kRows * 5;
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
  field_bwd_kernel<<<dim3((M + kRows - 1) / kRows, B), kThreads, smem, (cudaStream_t)stream>>>(
      xyz, vd, zs, zt, *w, d, g_sigma, g_rgb, dxyz, dvd, dzs_part, dzt_part);
  return (int)cudaGetLastError();
}
