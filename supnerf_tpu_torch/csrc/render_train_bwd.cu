// K3: training backward of the fused render, first half: everything but the
// cross-ray reduction of the decoder weight gradients.
//
// Replaces, together with K4 (wgrad.cu), the TPU kernel
// supnerf_tpu/ops/pallas_render.py:_render_train_bwd_kernel in its
// data_grads=False mode (pallas_call in _render_train_bwd_call, wrapped by
// _make_render_train_core for field_composite_train_pallas, the NeRF branch
// of every training step). Per ray it does K2's work (render_bwd.cu): the
// forward recompute with the ReLU sign patterns stashed as bits, the manual
// compositing VJP, the transposed decoder chain and the per-ray partial sums
// of dz_shape / dz_tex, which the wrapper sums over rays. The data
// cotangents (points, view directions, z) are not computed: training
// batches are data, and the chain stops at the first layer's
// pre-activation gradient.
//
// What is new against K2 is the decoder's weight gradients, dW_l = A_l^T G_l
// and db_l = sum G_l over every sample of the batch, with A_l the layer's
// input rows and G_l its pre-activation gradient rows. The Pallas kernel sums
// them in 17 VMEM-resident accumulators across a sequential grid. A CUDA grid
// has no order, and the accumulators (2.4 MB at W 256) do not fit one SM, so
// the work is split in two: this kernel writes each ray's A_l and G_l rows
// (the "stash", one row of StashLayout::ld_pt floats per sample, about 15.6 KB
// at W 256; one row of ld_ray floats per ray for the viewdir layer's
// direction-encoding part, whose input is per ray), and K4 forms the products
// with a deterministic split-and-sum over rows. The wrapper launches both per
// chunk of objects so that the stash stays within a fixed budget.
//
// What bounds it on the H100: arithmetic, as K2 (0.89 MFLOP per point of
// forward recompute, 0.87 of transposed chain: the first layer's transpose is
// skipped), plus 15.6 KB per point of stash written to device memory, which
// at 3.35 TB/s costs ~5 us per 1000 points against ~26 us of float32 FMAs at
// the 67 TFLOP/s peak. Same design as K1/K2: a block per ray, the ray's
// 64 x W activations in shared memory across all layers.
#include "render_common.cuh"

namespace supnerf {

// Float offsets of the stash columns; field order must match
// supnerf_tpu_torch/ops/render.py:_StashLayout. Per point (row
// (obj * R + ray) * S + s of `pt`): layer inputs a_* and pre-activation
// gradients g_*; a_sh, g_sh hold n_shape blocks of W, a_tx, g_tx n_tex.
struct StashLayout {
  float* pt;
  float* ray;
  int ld_pt, ld_ray;
  int a_xyz, a_sh, a_es, a_e, a_tx, a_r1, a_hh;
  int g_xyz, g_sh, g_e, g_sig, g_v, g_tx, g_hh, g_rgb;
  int r_dpe, r_gv;
};

static __device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// dst[r][c] = buf[r][c] for the S real rows and c < N (dst row stride ld).
static __device__ void store_rows(const float* buf, int stride, int N, int S, float* dst,
                                  int ld) {
  for (int e = threadIdx.x; e < S * N; e += kThreads) {
    const int r = e / N, c = e - r * N;
    dst[(size_t)r * ld + c] = buf[r * stride + c];
  }
  __syncthreads();
}

static __device__ void column_sums(const float* buf, int stride, int N, int S, float* out) {
  for (int c = threadIdx.x; c < N; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < S; ++r) s += buf[r * stride + c];
    out[c] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
render_train_bwd_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                        const float* __restrict__ z, const float* __restrict__ zs,
                        const float* __restrict__ zt, DecoderWeights w, Dims d,
                        int white_bkgd, const float* __restrict__ g_rgb,
                        const float* __restrict__ g_depth, const float* __restrict__ g_acc,
                        StashLayout st, float* __restrict__ dzs_part,
                        float* __restrict__ dzt_part) {
  const int ray = blockIdx.x, obj = blockIdx.y;
  const int W = d.W, W2 = d.W / 2, S = d.S;
  const int nj = W / 32;
  const size_t ray_idx = (size_t)obj * d.R + ray;
  const int n_masks = d.n_shape + d.n_tex + 3;
  float* pt = st.pt + ray_idx * S * st.ld_pt;      // this ray's first stash row
  float* rrow = st.ray + ray_idx * st.ld_ray;

  extern __shared__ float smem[];
  float* buf_a = smem;                         // kRows x W
  float* buf_b = buf_a + kRows * W;            // kRows x W
  float* pe = buf_b + kRows * W;               // kRows x kPeStride
  float* hdir = pe + kRows * kPeStride;        // W (later: column sums)
  float* dpe = hdir + W;                       // kMaxDirPe
  float* logit = dpe + kMaxDirPe;              // kRows
  float* rgb = logit + kRows;                  // kRows x 3
  float* dsig = rgb + kRows * 3;               // kRows
  float* drgb = dsig + kRows;                  // kRows x 3
  uint32_t* masks = reinterpret_cast<uint32_t*>(drgb + kRows * 3);  // n_masks x kRows x nj
  auto mask_of = [&](int layer) { return masks + (size_t)layer * kRows * nj; };
  const int m_vd = d.n_shape + 1, m_tx0 = d.n_shape + 2, m_r1 = n_masks - 1;

  // ---- forward recompute: ReLU patterns to shared memory, layer inputs to
  // the stash --------------------------------------------------------------
  encode_points(xyz + ray_idx * S * 3, S, d.l_xyz, pe);
  direction_term(vd + ray_idx * 3, d.l_dir, w, W, dpe, hdir);    // syncs
  const int d_xyz = pe_width(d.l_xyz), d_dir = pe_width(d.l_dir);
  store_rows(pe, kPeStride, d_xyz, S, pt + st.a_xyz, st.ld_pt);
  for (int k = threadIdx.x; k < d_dir; k += kThreads) rrow[st.r_dpe + k] = dpe[k];

  dense(pe, kPeStride, d_xyz, w.w_xyz, W, w.b_xyz, buf_a, W, true, mask_of(0));
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int j = 0; j < d.n_shape; ++j) {
    add_row_vector(cur, W, W, zs + ((size_t)obj * d.n_shape + j) * W);
    store_rows(cur, W, W, S, pt + st.a_sh + j * W, st.ld_pt);
    dense(cur, W, W, w.w_sh + (size_t)j * W * W, W, w.b_sh + j * W, nxt, W, true,
          mask_of(1 + j));
    float* t = cur; cur = nxt; nxt = t;
  }
  store_rows(cur, W, W, S, pt + st.a_es, st.ld_pt);
  dense(cur, W, W, w.w_es, W, w.b_es, nxt, W, false, nullptr);
  { float* t = cur; cur = nxt; nxt = t; }                       // cur = e
  store_rows(cur, W, W, S, pt + st.a_e, st.ld_pt);
  head(cur, W, W, w.w_sg, 1, w.b_sg, logit);
  dense(cur, W, W, w.w_vd_a, W, hdir, nxt, W, true, mask_of(m_vd));
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = 0; j < d.n_tex; ++j) {
    add_row_vector(cur, W, W, zt + ((size_t)obj * d.n_tex + j) * W);
    store_rows(cur, W, W, S, pt + st.a_tx + j * W, st.ld_pt);
    dense(cur, W, W, w.w_tx + (size_t)j * W * W, W, w.b_tx + j * W, nxt, W, true,
          mask_of(m_tx0 + j));
    float* t = cur; cur = nxt; nxt = t;
  }
  store_rows(cur, W, W, S, pt + st.a_r1, st.ld_pt);
  dense(cur, W, W, w.w_r1, W2, w.b_r1, nxt, W2, true, mask_of(m_r1));
  store_rows(nxt, W2, W2, S, pt + st.a_hh, st.ld_pt);
  head(nxt, W2, W2, w.w_r2, 3, w.b_r2, rgb);

  // ---- compositing forward replay + manual VJP (one thread per ray; the
  // algebra of render_bwd.cu without the dz terms) -------------------------
  if (threadIdx.x == 0) {
    const float* zr = z + (size_t)obj * S;
    float* alpha = buf_a;
    float* T = alpha + kRows;
    float* wt = T + kRows;
    float* gw = wt + kRows;
    const float gr0 = g_rgb[ray_idx * 3], gr1 = g_rgb[ray_idx * 3 + 1],
                gr2 = g_rgb[ray_idx * 3 + 2];
    const float gd = g_depth[ray_idx], ga = g_acc[ray_idx];
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
      dsig[s] = (sg > 0.f) ? de * (-delta) * (1.f - alpha[s]) : 0.f;
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
  __syncthreads();
  store_rows(drgb, 3, 3, S, pt + st.g_rgb, st.ld_pt);
  for (int r = threadIdx.x; r < S; r += kThreads)
    pt[(size_t)r * st.ld_pt + st.g_sig] = dsig[r] * sigmoid(logit[r]);

  // ---- transposed decoder chain, pre-activation gradients to the stash ----
  for (int e = threadIdx.x; e < kRows * W2; e += kThreads) {
    const int r = e / W2, c = e - r * W2;
    buf_a[r * W2 + c] = drgb[3 * r] * w.w_r2[3 * c] + drgb[3 * r + 1] * w.w_r2[3 * c + 1]
                        + drgb[3 * r + 2] * w.w_r2[3 * c + 2];
  }
  __syncthreads();
  apply_mask(buf_a, W2, W2, mask_of(m_r1));
  store_rows(buf_a, W2, W2, S, pt + st.g_hh, st.ld_pt);
  dense(buf_a, W2, W2, w.wt_r1, W, nullptr, buf_b, W, false, nullptr);
  cur = buf_b; nxt = buf_a;
  float* colsum = hdir;   // the direction term is no longer needed
  for (int j = d.n_tex - 1; j >= 0; --j) {
    apply_mask(cur, W, W, mask_of(m_tx0 + j));
    store_rows(cur, W, W, S, pt + st.g_tx + j * W, st.ld_pt);
    dense(cur, W, W, w.wt_tx + (size_t)j * W * W, W, nullptr, nxt, W, false, nullptr);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, W, W, S, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads)
      dzt_part[(ray_idx * d.n_tex + j) * W + c] = colsum[c];
  }
  apply_mask(cur, W, W, mask_of(m_vd));            // cur = g_v
  store_rows(cur, W, W, S, pt + st.g_v, st.ld_pt);
  // the direction encoding is per ray: the viewdir layer's direction rows
  // get dpe^T (sum over the ray's samples of g_v), formed by K4 over rays
  column_sums(cur, W, W, S, colsum);
  for (int c = threadIdx.x; c < W; c += kThreads) rrow[st.r_gv + c] = colsum[c];
  // encoding_shape output e feeds both the viewdir layer and the sigma head
  dense(cur, W, W, w.wt_vd_a, W, nullptr, nxt, W, false, nullptr);
  for (int e = threadIdx.x; e < kRows * W; e += kThreads) {
    const int r = e / W, c = e - r * W;
    const float g_sig = (r < S) ? dsig[r] * sigmoid(logit[r]) : 0.f;
    nxt[r * W + c] = fmaf(g_sig, w.w_sg[c], nxt[r * W + c]);
  }
  __syncthreads();
  { float* t = cur; cur = nxt; nxt = t; }          // cur = g_e
  store_rows(cur, W, W, S, pt + st.g_e, st.ld_pt);
  dense(cur, W, W, w.wt_es, W, nullptr, nxt, W, false, nullptr);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = d.n_shape - 1; j >= 0; --j) {
    apply_mask(cur, W, W, mask_of(1 + j));
    store_rows(cur, W, W, S, pt + st.g_sh + j * W, st.ld_pt);
    dense(cur, W, W, w.wt_sh + (size_t)j * W * W, W, nullptr, nxt, W, false, nullptr);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, W, W, S, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads)
      dzs_part[(ray_idx * d.n_shape + j) * W + c] = colsum[c];
  }
  apply_mask(cur, W, W, mask_of(0));
  store_rows(cur, W, W, S, pt + st.g_xyz, st.ld_pt);
}

size_t render_train_bwd_smem_bytes(int W, int n_shape, int n_tex) {
  const size_t floats = (size_t)2 * kRows * W + kRows * kPeStride + W + kMaxDirPe
                        + kRows * 8;
  const size_t words = (size_t)(n_shape + n_tex + 3) * kRows * (W / 32);
  return sizeof(float) * floats + sizeof(uint32_t) * words;
}

}  // namespace supnerf

// Plain C entry, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises or allocates.
extern "C" int supnerf_render_train_bwd(const float* xyz, const float* vd, const float* z,
                                        const float* zs, const float* zt,
                                        const supnerf::DecoderWeights* w, int B, int R,
                                        int S, int W, int n_shape, int n_tex, int l_xyz,
                                        int l_dir, int white_bkgd, const float* g_rgb,
                                        const float* g_depth, const float* g_acc,
                                        const supnerf::StashLayout* stash, float* dzs_part,
                                        float* dzt_part, void* stream) {
  using namespace supnerf;
  const Dims d{B, R, S, W, n_shape, n_tex, l_xyz, l_dir};
  const size_t smem = render_train_bwd_smem_bytes(W, n_shape, n_tex);
  cudaError_t err = cudaFuncSetAttribute(
      render_train_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  render_train_bwd_kernel<<<dim3(R, B), kThreads, smem, (cudaStream_t)stream>>>(
      xyz, vd, z, zs, zt, *w, d, white_bkgd, g_rgb, g_depth, g_acc, *stash, dzs_part,
      dzt_part);
  return (int)cudaGetLastError();
}
