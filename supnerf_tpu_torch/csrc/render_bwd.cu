// K2: backward of the fused render (K1) for a frozen decoder.
//
// Replaces the TPU kernel supnerf_tpu/ops/pallas_render.py:_render_bwd_kernel
// in its shared-z mode (pallas_call in _render_bwd_call, wrapped by
// _make_render_core for field_composite_apply) and in its per-ray-z mode
// (_make_render_aabb_core, field_composite_aabb_apply). In the per-ray mode
// each ray reads its own z row in both compositing passes, and the hit
// column masks the density after the softplus as in K1. The masked density
// enters both the density and the delta terms of the VJP, so a missed ray
// sends zero into the transposed chain: zero dxyz, dviewdir and dz, and no
// share of dz_shape or dz_tex. Its block writes those zeros and returns.
// The dz rows are per ray already, and the wrapper returns them as they
// are. Per ray it recomputes the
// field and the compositing, applies the manual compositing VJP in stable
// product form (the algebra of the _render_bwd_kernel docstring; no
// reverse differentiation through log/exp, the only division is by a
// transmittance factor >= 1e-10), then runs the transposed decoder chain.
// Outputs: dxyz (B,R,S,3) through the positional-encoding chain rule on the
// recomputed sin/cos values; dviewdir (B,R,3) per ray; per-ray partial sums
// of dz_shape (B,R,n_shape,W), dz_tex (B,R,n_tex,W) and dz (B,R,S), which the
// wrapper sums over rays (the second pass of the cross-block reduction, as
// the TPU version sums its per-tile partials in XLA; deterministic, no
// atomics). The decoder weights get no gradient (TTO freezes the network).
//
// The stash: the transposed chain needs every ReLU's sign pattern, about
// 7 layers x 64 x 256 values per ray, which would not fit in shared memory
// as floats. The forward recompute stores each pattern as bits instead
// (__ballot_sync, 2 KB per layer), so the whole stash stays on chip and
// nothing is recomputed twice or spilled to a scratch tensor.
//
// What bounds it on the H100: arithmetic. The forward recompute is 0.89
// MFLOP per point and the transposed chain another 0.89 (it skips only the
// tiny sigma and rgb heads), about 1.8 MFLOP per point or 116 GFLOP for one
// object's 1024 x 64 loss render, against 7 MB of points in and 7 MB of
// dxyz out: for the TTO path's 2 objects 1.4 ms on the tensor cores at
// float32 accuracy (3xTF32, three TF32 products per product), 3.5 ms at
// the float32 FMA peak. So every dense layer runs on dense_mma
// (render_common.cuh): 3xTF32 mma.sync with the output columns split
// across the warps, each warp's slice of the weights streamed through its
// own cp.async ring in shared memory (each weight element enters the SM
// once per block, not once per warp), the ray's activations in shared
// memory at a row stride of W + kMmaPad floats (fragment loads free of
// bank conflicts), and the ReLU bit masks built from the accumulators in
// registers. The forward recompute is K1's (render_fwd.cu): the same layers
// in the same order, its ReLU layers with dense_mma's kRefine step (a
// pre-activation within 2^-20 of its row's scale from zero recomputed in
// float64), so every gate K2 differentiates at is the one K1's forward took
// and the gradient is the VJP of the forward the caller evaluated. The
// block stays one ray (its activations on chip, the ReLU
// patterns as bits); its shared memory (~224 KB at W 256, the weight rings
// included) allows one block of 8 warps per SM, and mma.sync runs below the
// tensor cores' wgmma rate, so the layers stay short of the bound; the
// compositing VJP's single thread and the other non-matrix steps leave the
// tensor cores idle for their span.
//
// The bfloat16 mode (render_bwd_bf16_kernel, the same body with kBf16): the
// Pallas kernel at dtype=bfloat16 (render_common.cuh's note;
// pallas_render.py:_render_bwd_kernel): the recompute runs K1's bfloat16
// layers with each ReLU output rounded to bfloat16 (its stash), so it is not
// K1's bits; the compositing VJP takes the ray's rgb cotangent rounded; the
// transposed layers run on dense_mma_bf16; the sigma and rgb cotangents are
// rounded where they enter a product; the direction encodings' cotangent is
// formed per sample (g_v @ Wvd_b^T), rounded and summed over the ray (the
// Pallas kernel's seg_reduce), and both chain rules take the rounded
// encodings and round each term (encode_backward_one_bf16).
#include "render_common.cuh"

namespace supnerf {

template <bool kBf16>
static __device__ __forceinline__ void render_bwd_body(
    const float* __restrict__ xyz, const float* __restrict__ vd, const float* __restrict__ z,
    const float* __restrict__ zs, const float* __restrict__ zt, const DecoderWeights& w,
    const Dims& d, int white_bkgd, int z_per_ray, const float* __restrict__ hit,
    const float* __restrict__ g_rgb, const float* __restrict__ g_depth,
    const float* __restrict__ g_acc, float* __restrict__ dxyz, float* __restrict__ dvd,
    float* __restrict__ dzs_part, float* __restrict__ dzt_part, float* __restrict__ dz_part) {
  const int ray = blockIdx.x, obj = blockIdx.y;
  const int W = d.W, W2 = d.W / 2, S = d.S;
  const int nj = W / 32;
  const size_t ray_idx = (size_t)obj * d.R + ray;
  const int n_masks = d.n_shape + d.n_tex + 3;

  // A ray that misses its box has zero density and zero weights, so every
  // cotangent it sends back is zero (see render_fwd.cu); its block writes the
  // zeros and returns without the recompute or the transposed chain.
  if (hit != nullptr && hit[ray_idx] == 0.f) {
    for (int i = threadIdx.x; i < S * 3; i += kThreads) dxyz[ray_idx * S * 3 + i] = 0.f;
    for (int i = threadIdx.x; i < S; i += kThreads) dz_part[ray_idx * S + i] = 0.f;
    for (int i = threadIdx.x; i < d.n_shape * W; i += kThreads)
      dzs_part[ray_idx * d.n_shape * W + i] = 0.f;
    for (int i = threadIdx.x; i < d.n_tex * W; i += kThreads)
      dzt_part[ray_idx * d.n_tex * W + i] = 0.f;
    if (threadIdx.x < 3) dvd[ray_idx * 3 + threadIdx.x] = 0.f;
    return;
  }

  extern __shared__ float smem[];
  const int Ws = W + kMmaPad;                  // activation row stride
  float* stage = smem;                         // kMmaStageFloats, dense_mma's weight slices
  float* buf_a = stage + kMmaStageFloats;      // kRows x Ws
  float* buf_b = buf_a + kRows * Ws;           // kRows x Ws
  float* pe = buf_b + kRows * Ws;              // kRows x kPeStride
  float* hdir = pe + kRows * kPeStride;        // W (later: column sums)
  float* dpe = hdir + W;                       // kMaxDirPe
  float* ddpe = dpe + kMaxDirPe;               // kMaxDirPe
  float* logit = ddpe + kMaxDirPe;             // kRows
  float* rgb = logit + kRows;                  // kRows x 3
  float* dsig = rgb + kRows * 3;               // kRows
  float* drgb = dsig + kRows;                  // kRows x 3
  uint32_t* masks = reinterpret_cast<uint32_t*>(drgb + kRows * 3);  // n_masks x kRows x nj
  // stash slots: 0 = encoding_xyz, 1..n_shape = shape blocks, then viewdir,
  // texture blocks, rgb_hidden
  auto mask_of = [&](int layer) { return masks + (size_t)layer * kRows * nj; };
  const int m_vd = d.n_shape + 1, m_tx0 = d.n_shape + 2, m_r1 = n_masks - 1;

  // ---- forward recompute, stashing ReLU patterns -------------------------
  // (kBf16: and each ReLU output rounded, round_out)
  if constexpr (kBf16) {
    encode_points_bf16(xyz + ray_idx * S * 3, S, d.l_xyz, false, pe);
    direction_term_bf16(vd + ray_idx * 3, d.l_dir, kPeDoubling, w, W, dpe, hdir);
  } else {
    encode_points(xyz + ray_idx * S * 3, S, d.l_xyz, pe);
    direction_term(vd + ray_idx * 3, d.l_dir, w, W, dpe, hdir);
  }

  dense_layer<kBf16, true>(pe, kPeStride, pe_width(d.l_xyz), w.w_xyz, W, w.b_xyz, buf_a, Ws,
                           true, mask_of(0), stage, nullptr, 0, 0, nullptr, nullptr, kBf16);
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int j = 0; j < d.n_shape; ++j) {
    add_row_vector(cur, Ws, W, zs + ((size_t)obj * d.n_shape + j) * W);
    dense_layer<kBf16, true>(cur, Ws, W, w.w_sh + (size_t)j * W * W, W, w.b_sh + j * W, nxt, Ws,
                             true, mask_of(1 + j), stage, nullptr, 0, 0, nullptr, nullptr,
                             kBf16);
    float* t = cur; cur = nxt; nxt = t;
  }
  dense_layer<kBf16>(cur, Ws, W, w.w_es, W, w.b_es, nxt, Ws, false, nullptr, stage);
  { float* t = cur; cur = nxt; nxt = t; }
  head<kBf16>(cur, Ws, W, w.w_sg, 1, w.b_sg, logit);
  dense_layer<kBf16, true>(cur, Ws, W, w.w_vd_a, W, hdir, nxt, Ws, true, mask_of(m_vd), stage,
                           nullptr, 0, 0, nullptr, nullptr, kBf16);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = 0; j < d.n_tex; ++j) {
    add_row_vector(cur, Ws, W, zt + ((size_t)obj * d.n_tex + j) * W);
    dense_layer<kBf16, true>(cur, Ws, W, w.w_tx + (size_t)j * W * W, W, w.b_tx + j * W, nxt, Ws,
                             true, mask_of(m_tx0 + j), stage, nullptr, 0, 0, nullptr, nullptr,
                             kBf16);
    float* t = cur; cur = nxt; nxt = t;
  }
  dense_layer<kBf16, true>(cur, Ws, W, w.w_r1, W2, w.b_r1, nxt, Ws, true, mask_of(m_r1), stage,
                           nullptr, 0, 0, nullptr, nullptr, kBf16);
  head<kBf16>(nxt, Ws, W2, w.w_r2, 3, w.b_r2, rgb);

  // ---- compositing forward replay + manual VJP (one thread per ray) -------
  // Reuses buf_a as per-sample scratch: alpha, T (exclusive), w, gw.
  if (threadIdx.x == 0)
    composite_vjp<kBf16>(logit, rgb, z + (z_per_ray ? ray_idx : (size_t)obj) * S, S, white_bkgd,
                         g_rgb + ray_idx * 3, g_depth[ray_idx], g_acc[ray_idx], buf_a, dsig,
                         drgb, dz_part + ray_idx * S);
  __syncthreads();

  // ---- transposed decoder chain ------------------------------------------
  // rgb_out: g_hh[r][c] = relu'(hh) * sum_k drgb[r][k] w_r2[c][k]
  auto rd = [](float x) { return kBf16 ? bf16_round(x) : x; };
  for (int e = threadIdx.x; e < kRows * W2; e += kThreads) {
    const int r = e / W2, c = e - r * W2;
    buf_a[r * Ws + c] = rd(drgb[3 * r]) * w.w_r2[3 * c] + rd(drgb[3 * r + 1]) * w.w_r2[3 * c + 1]
                        + rd(drgb[3 * r + 2]) * w.w_r2[3 * c + 2];
  }
  __syncthreads();
  apply_mask(buf_a, Ws, W2, mask_of(m_r1));
  dense_layer<kBf16>(buf_a, Ws, W2, w.wt_r1, W, nullptr, buf_b, Ws, false, nullptr, stage);
  cur = buf_b; nxt = buf_a;
  float* colsum = hdir;   // the direction term is no longer needed
  for (int j = d.n_tex - 1; j >= 0; --j) {
    apply_mask(cur, Ws, W, mask_of(m_tx0 + j));
    dense_layer<kBf16>(cur, Ws, W, w.wt_tx + (size_t)j * W * W, W, nullptr, nxt, Ws, false,
                       nullptr, stage);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, Ws, W, S, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads)
      dzt_part[(ray_idx * d.n_tex + j) * W + c] = colsum[c];
  }
  apply_mask(cur, Ws, W, mask_of(m_vd));           // cur = g_v
  if constexpr (kBf16) {
    // viewdir: per sample g_v @ Wvd_b^T (into nxt, kPeStride a row), each
    // value rounded, summed over the ray's rows, then the chain rule
    dense_layer<true>(cur, Ws, W, w.wt_vd_b, pe_width(d.l_dir), nullptr, nxt, kPeStride, false,
                      nullptr, stage);
    for (int k = threadIdx.x; k < pe_width(d.l_dir); k += kThreads) {
      float s = 0.f;
      for (int r = 0; r < S; ++r) s += bf16_round(nxt[r * kPeStride + k]);
      ddpe[k] = s;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float dv[3];
      encode_backward_one_bf16(dpe, ddpe, d.l_dir, dv);
      for (int c = 0; c < 3; ++c) dvd[ray_idx * 3 + c] = dv[c];
    }
    __syncthreads();
  } else {
    // viewdir: the direction encoding is per ray, so its cotangent is
    // (sum over the ray's rows of g_v) @ Wvd_b^T
    column_sums(cur, Ws, W, S, colsum);
    ray_direction_cotangent(colsum, dpe, w, W, d.l_dir, ddpe, dvd + ray_idx * 3);
  }
  // encoding_shape output e feeds both the viewdir layer and the sigma head
  dense_layer<kBf16>(cur, Ws, W, w.wt_vd_a, W, nullptr, nxt, Ws, false, nullptr, stage);
  for (int e = threadIdx.x; e < kRows * W; e += kThreads) {
    const int r = e / W, c = e - r * W;
    const float g_sig = (r < S) ? rd(dsig[r] * sigmoid(logit[r])) : 0.f;
    nxt[r * Ws + c] = fmaf(g_sig, w.w_sg[c], nxt[r * Ws + c]);
  }
  __syncthreads();
  { float* t = cur; cur = nxt; nxt = t; }
  dense_layer<kBf16>(cur, Ws, W, w.wt_es, W, nullptr, nxt, Ws, false, nullptr, stage);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = d.n_shape - 1; j >= 0; --j) {
    apply_mask(cur, Ws, W, mask_of(1 + j));
    dense_layer<kBf16>(cur, Ws, W, w.wt_sh + (size_t)j * W * W, W, nullptr, nxt, Ws, false,
                       nullptr, stage);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, Ws, W, S, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads)
      dzs_part[(ray_idx * d.n_shape + j) * W + c] = colsum[c];
  }
  apply_mask(cur, Ws, W, mask_of(0));
  // the points' cotangents: g @ Wxyz^T (into nxt, kPeStride a row), then the
  // encoding's chain rule
  dense_layer<kBf16>(cur, Ws, W, w.wt_xyz, pe_width(d.l_xyz), nullptr, nxt, kPeStride, false,
                     nullptr, stage);
  encode_backward_rows<kBf16>(pe, nxt, d.l_xyz, S, dxyz + ray_idx * S * 3);
}

__global__ void __launch_bounds__(kThreads, 1)
render_bwd_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                  const float* __restrict__ z, const float* __restrict__ zs,
                  const float* __restrict__ zt, DecoderWeights w, Dims d,
                  int white_bkgd, int z_per_ray, const float* __restrict__ hit,
                  const float* __restrict__ g_rgb,
                  const float* __restrict__ g_depth, const float* __restrict__ g_acc,
                  float* __restrict__ dxyz, float* __restrict__ dvd,
                  float* __restrict__ dzs_part, float* __restrict__ dzt_part,
                  float* __restrict__ dz_part) {
  render_bwd_body<false>(xyz, vd, z, zs, zt, w, d, white_bkgd, z_per_ray, hit, g_rgb, g_depth,
                         g_acc, dxyz, dvd, dzs_part, dzt_part, dz_part);
}

__global__ void __launch_bounds__(kThreads, 1)
render_bwd_bf16_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                       const float* __restrict__ z, const float* __restrict__ zs,
                       const float* __restrict__ zt, DecoderWeights w, Dims d,
                       int white_bkgd, int z_per_ray, const float* __restrict__ hit,
                       const float* __restrict__ g_rgb,
                       const float* __restrict__ g_depth, const float* __restrict__ g_acc,
                       float* __restrict__ dxyz, float* __restrict__ dvd,
                       float* __restrict__ dzs_part, float* __restrict__ dzt_part,
                       float* __restrict__ dz_part) {
  render_bwd_body<true>(xyz, vd, z, zs, zt, w, d, white_bkgd, z_per_ray, hit, g_rgb, g_depth,
                        g_acc, dxyz, dvd, dzs_part, dzt_part, dz_part);
}

size_t render_bwd_smem_bytes(int W, int n_shape, int n_tex) {
  const size_t floats = (size_t)kMmaStageFloats + 2 * kRows * (W + kMmaPad)
                        + kRows * kPeStride + W + 2 * kMaxDirPe + kRows * 8;
  const size_t words = (size_t)(n_shape + n_tex + 3) * kRows * (W / 32);
  return sizeof(float) * floats + sizeof(uint32_t) * words;
}

}  // namespace supnerf

// Plain C entry, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises or allocates.
extern "C" int supnerf_render_bwd(const float* xyz, const float* vd, const float* z,
                                  const float* zs, const float* zt,
                                  const supnerf::DecoderWeights* w, int B, int R, int S,
                                  int W, int n_shape, int n_tex, int l_xyz, int l_dir,
                                  int white_bkgd, int z_per_ray, const float* hit,
                                  const float* g_rgb, const float* g_depth,
                                  const float* g_acc, float* dxyz, float* dvd,
                                  float* dzs_part, float* dzt_part, float* dz_part,
                                  void* stream) {
  using namespace supnerf;
  const Dims d{B, R, S, W, n_shape, n_tex, l_xyz, l_dir};
  const size_t smem = render_bwd_smem_bytes(W, n_shape, n_tex);
  cudaError_t err = cudaFuncSetAttribute(
      render_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  render_bwd_kernel<<<dim3(R, B), kThreads, smem, (cudaStream_t)stream>>>(
      xyz, vd, z, zs, zt, *w, d, white_bkgd, z_per_ray, hit, g_rgb, g_depth, g_acc, dxyz,
      dvd, dzs_part, dzt_part, dz_part);
  return (int)cudaGetLastError();
}

// The bfloat16 mode's entry: supnerf_render_bwd's arguments.
extern "C" int supnerf_render_bwd_bf16(const float* xyz, const float* vd, const float* z,
                                       const float* zs, const float* zt,
                                       const supnerf::DecoderWeights* w, int B, int R, int S,
                                       int W, int n_shape, int n_tex, int l_xyz, int l_dir,
                                       int white_bkgd, int z_per_ray, const float* hit,
                                       const float* g_rgb, const float* g_depth,
                                       const float* g_acc, float* dxyz, float* dvd,
                                       float* dzs_part, float* dzt_part, float* dz_part,
                                       void* stream) {
  using namespace supnerf;
  const Dims d{B, R, S, W, n_shape, n_tex, l_xyz, l_dir};
  const size_t smem = render_bwd_smem_bytes(W, n_shape, n_tex);
  cudaError_t err = cudaFuncSetAttribute(
      render_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  render_bwd_bf16_kernel<<<dim3(R, B), kThreads, smem, (cudaStream_t)stream>>>(
      xyz, vd, z, zs, zt, *w, d, white_bkgd, z_per_ray, hit, g_rgb, g_depth, g_acc, dxyz,
      dvd, dzs_part, dzt_part, dz_part);
  return (int)cudaGetLastError();
}
