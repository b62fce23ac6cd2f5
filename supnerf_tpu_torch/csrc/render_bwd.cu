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
// The bfloat16 mode (render_bwd_bf16_kernel<W>, render_bf16.cuh): the
// Pallas kernel at dtype=bfloat16 (render_common.cuh's note;
// pallas_render.py:_render_bwd_kernel): the recompute runs K1's bfloat16
// layers with each ReLU output rounded to bfloat16 (its stash), so it is not
// K1's bits; the compositing VJP takes the ray's rgb cotangent rounded; the
// transposed layers take their cotangents rounded; the direction
// encodings' cotangent is formed per sample (g_v @ Wvd_b^T), rounded and
// summed over the ray (the Pallas kernel's seg_reduce), and both chain
// rules take the rounded encodings and round each term
// (encode_backward_one_bf16). What bounds it and what its design does:
// render_bf16.cuh, as K1's build: two rays a block on one stream of
// bfloat16 weight tiles (the forward layers', then the transposed chain's,
// 1.8 MB a pair), wgmma with the activations and cotangents in registers,
// the ReLU gates as each thread's own bits in shared memory, the column
// sums and heads reduced from registers. The compositing VJP (one thread a
// ray) and the chain rules stay on the CUDA cores.
#include "render_bf16.cuh"

namespace supnerf {

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
  encode_points(xyz + ray_idx * S * 3, S, d.l_xyz, pe);
  direction_term(vd + ray_idx * 3, d.l_dir, w, W, dpe, hdir);

  dense_layer<false, true>(pe, kPeStride, pe_width(d.l_xyz), w.w_xyz, W, w.b_xyz, buf_a, Ws,
                           true, mask_of(0), stage);
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int j = 0; j < d.n_shape; ++j) {
    add_row_vector(cur, Ws, W, zs + ((size_t)obj * d.n_shape + j) * W);
    dense_layer<false, true>(cur, Ws, W, w.w_sh + (size_t)j * W * W, W, w.b_sh + j * W, nxt, Ws,
                             true, mask_of(1 + j), stage);
    float* t = cur; cur = nxt; nxt = t;
  }
  dense_layer<false>(cur, Ws, W, w.w_es, W, w.b_es, nxt, Ws, false, nullptr, stage);
  { float* t = cur; cur = nxt; nxt = t; }
  head(cur, Ws, W, w.w_sg, 1, w.b_sg, logit);
  dense_layer<false, true>(cur, Ws, W, w.w_vd_a, W, hdir, nxt, Ws, true, mask_of(m_vd), stage);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = 0; j < d.n_tex; ++j) {
    add_row_vector(cur, Ws, W, zt + ((size_t)obj * d.n_tex + j) * W);
    dense_layer<false, true>(cur, Ws, W, w.w_tx + (size_t)j * W * W, W, w.b_tx + j * W, nxt, Ws,
                             true, mask_of(m_tx0 + j), stage);
    float* t = cur; cur = nxt; nxt = t;
  }
  dense_layer<false, true>(cur, Ws, W, w.w_r1, W2, w.b_r1, nxt, Ws, true, mask_of(m_r1), stage);
  head(nxt, Ws, W2, w.w_r2, 3, w.b_r2, rgb);

  // ---- compositing forward replay + manual VJP (one thread per ray) -------
  // Reuses buf_a as per-sample scratch: alpha, T (exclusive), w, gw.
  if (threadIdx.x == 0)
    composite_vjp(logit, rgb, z + (z_per_ray ? ray_idx : (size_t)obj) * S, S, white_bkgd,
                  g_rgb + ray_idx * 3, g_depth[ray_idx], g_acc[ray_idx], buf_a, dsig, drgb,
                  dz_part + ray_idx * S);
  __syncthreads();

  // ---- transposed decoder chain ------------------------------------------
  // rgb_out: g_hh[r][c] = relu'(hh) * sum_k drgb[r][k] w_r2[c][k]
  for (int e = threadIdx.x; e < kRows * W2; e += kThreads) {
    const int r = e / W2, c = e - r * W2;
    buf_a[r * Ws + c] = drgb[3 * r] * w.w_r2[3 * c] + drgb[3 * r + 1] * w.w_r2[3 * c + 1]
                        + drgb[3 * r + 2] * w.w_r2[3 * c + 2];
  }
  __syncthreads();
  apply_mask(buf_a, Ws, W2, mask_of(m_r1));
  dense_layer<false>(buf_a, Ws, W2, w.wt_r1, W, nullptr, buf_b, Ws, false, nullptr, stage);
  cur = buf_b; nxt = buf_a;
  float* colsum = hdir;   // the direction term is no longer needed
  for (int j = d.n_tex - 1; j >= 0; --j) {
    apply_mask(cur, Ws, W, mask_of(m_tx0 + j));
    dense_layer<false>(cur, Ws, W, w.wt_tx + (size_t)j * W * W, W, nullptr, nxt, Ws, false,
                       nullptr, stage);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, Ws, W, S, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads)
      dzt_part[(ray_idx * d.n_tex + j) * W + c] = colsum[c];
  }
  apply_mask(cur, Ws, W, mask_of(m_vd));           // cur = g_v
  // viewdir: the direction encoding is per ray, so its cotangent is
  // (sum over the ray's rows of g_v) @ Wvd_b^T
  column_sums(cur, Ws, W, S, colsum);
  ray_direction_cotangent(colsum, dpe, w, W, d.l_dir, ddpe, dvd + ray_idx * 3);
  // encoding_shape output e feeds both the viewdir layer and the sigma head
  dense_layer<false>(cur, Ws, W, w.wt_vd_a, W, nullptr, nxt, Ws, false, nullptr, stage);
  for (int e = threadIdx.x; e < kRows * W; e += kThreads) {
    const int r = e / W, c = e - r * W;
    const float g_sig = (r < S) ? dsig[r] * sigmoid(logit[r]) : 0.f;
    nxt[r * Ws + c] = fmaf(g_sig, w.w_sg[c], nxt[r * Ws + c]);
  }
  __syncthreads();
  { float* t = cur; cur = nxt; nxt = t; }
  dense_layer<false>(cur, Ws, W, w.wt_es, W, nullptr, nxt, Ws, false, nullptr, stage);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = d.n_shape - 1; j >= 0; --j) {
    apply_mask(cur, Ws, W, mask_of(1 + j));
    dense_layer<false>(cur, Ws, W, w.wt_sh + (size_t)j * W * W, W, nullptr, nxt, Ws, false,
                       nullptr, stage);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, Ws, W, S, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads)
      dzs_part[(ray_idx * d.n_shape + j) * W + c] = colsum[c];
  }
  apply_mask(cur, Ws, W, mask_of(0));
  // the points' cotangents: g @ Wxyz^T (into nxt, kPeStride a row), then the
  // encoding's chain rule
  dense_layer<false>(cur, Ws, W, w.wt_xyz, pe_width(d.l_xyz), nullptr, nxt, kPeStride, false,
                     nullptr, stage);
  encode_backward_rows(pe, nxt, d.l_xyz, S, dxyz + ray_idx * S * 3);
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
  render_bwd_body(xyz, vd, z, zs, zt, w, d, white_bkgd, z_per_ray, hit, g_rgb, g_depth, g_acc,
                  dxyz, dvd, dzs_part, dzt_part, dz_part);
}

// Ring slots of K2's bfloat16 build: 64 KB of weight tiles in flight
constexpr int kBwdSlots = 4;

// 4-byte words of one warpgroup's buffers of the bfloat16 build: its A
// fragments (W / 16 k-steps of 4 words a thread); the point encodings; the
// direction term, the direction encoding and its cotangent; the density
// logits, the colours, their cotangents, the sigma head's rounded
// cotangent; the compositing VJP's scratch; the column sums' partials;
// last, the ReLU gates (each thread's own words, mask_words a layer), whose
// room the points' cotangents take once the last gate is read.
template <int W>
__host__ __device__ constexpr int bwd_ray_fixed_words() {
  return W / 16 * 4 * 128 + kRows * kPeStride + W + 2 * kMaxDirPe + kRows + 3 * kRows + kRows
         + 3 * kRows + kRows + 4 * kRows + 4 * W;
}
template <int W>
static __host__ __device__ inline size_t bwd_ray_words(int n_masks) {
  const size_t gates = (size_t)n_masks * mask_words<W>() * 128;
  return bwd_ray_fixed_words<W>() + (gates > (size_t)kRows * kPeStride ? gates : kRows * kPeStride);
}

// The bfloat16 build (render_bf16.cuh), as K1's: a persistent grid of ray
// pairs, warpgroup g the pair's ray 2 p + g. A missed ray's cotangents are
// zero (see render_fwd.cu): a pair whose rays both miss takes no tile and
// writes the zeros; a missed ray of a pair with work runs with its partner
// and writes zeros.
template <int W>
__global__ void __launch_bounds__(kPairThreads, 1)
render_bwd_bf16_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                       const float* __restrict__ z, const float* __restrict__ zs,
                       const float* __restrict__ zt, DecoderWeights w,
                       const unsigned char* __restrict__ tiles, Dims d, int white_bkgd,
                       int z_per_ray, const float* __restrict__ hit,
                       const float* __restrict__ g_rgb, const float* __restrict__ g_depth,
                       const float* __restrict__ g_acc, float* __restrict__ dxyz,
                       float* __restrict__ dvd, float* __restrict__ dzs_part,
                       float* __restrict__ dzt_part, float* __restrict__ dz_part) {
  constexpr int KS = W / 16;                       // k-steps of a W-wide layer input
  constexpr int KS_HALF = 4 * ((W / 2 + kTileK - 1) / kTileK);   // of rgb.0^T's, whole tiles
  constexpr int MW = mask_words<W>();
  extern __shared__ unsigned char smem_raw[];
  const int n_rays = d.B * d.R, n_pairs = (n_rays + 1) / 2, S = d.S;
  const int n_masks = d.n_shape + d.n_tex + 3;
  const int d_dir = pe_width(d.l_dir), dir_n = d_dir <= 32 ? 32 : 64;
  unsigned char* rest;
  const auto ring = ring_setup<W, kBwdSlots>(smem_raw, d, dir_n, true, tiles,
                                             block_active_pairs(hit, n_rays), &rest);
  const int g = threadIdx.x >> 7;
  const Frag f = frag_of_thread();
  uint32_t* abuf = reinterpret_cast<uint32_t*>(rest) + g * bwd_ray_words<W>(n_masks);
  float* pe = reinterpret_cast<float*>(abuf + W / 16 * 4 * 128);
  float* hdir = pe + kRows * kPeStride;
  float* dpe = hdir + W;
  float* ddpe = dpe + kMaxDirPe;
  float* logit = ddpe + kMaxDirPe;
  float* rgb = logit + kRows;
  float* dsig = rgb + 3 * kRows;
  float* drgb = dsig + kRows;
  float* gsig = drgb + 3 * kRows;
  float* scratch = gsig + kRows;
  float* part = scratch + 4 * kRows;
  uint32_t* masks = reinterpret_cast<uint32_t*>(part + 4 * W);
  float* gpe = reinterpret_cast<float*>(masks);    // once the last gate is read
  // gate slots: 0 = encoding_xyz, 1..n_shape = shape blocks, then viewdir,
  // texture blocks, rgb_hidden
  auto mask_of = [&](int layer) { return masks + (size_t)layer * MW * 128; };
  const int m_vd = d.n_shape + 1, m_tx0 = d.n_shape + 2, m_r1 = n_masks - 1;

  float acc[W / 2];
  int it = 0;                                      // the block's next tile
  for (int p = blockIdx.x; p < n_pairs; p += gridDim.x) {
    const int ray = 2 * p + g;
    const bool valid = ray < n_rays;
    const size_t ridx = valid ? ray : ray - 1;
    const bool live = valid && (hit == nullptr || hit[ridx] != 0.f);
    if (!pair_active(hit, p, n_rays)) {
      if (valid) {
        for (int i = f.wt; i < S * 3; i += 128) dxyz[ridx * S * 3 + i] = 0.f;
        for (int i = f.wt; i < S; i += 128) dz_part[ridx * S + i] = 0.f;
        for (int i = f.wt; i < d.n_shape * W; i += 128) dzs_part[ridx * d.n_shape * W + i] = 0.f;
        for (int i = f.wt; i < d.n_tex * W; i += 128) dzt_part[ridx * d.n_tex * W + i] = 0.f;
        if (f.wt < 3) dvd[ridx * 3 + f.wt] = 0.f;
      }
      continue;
    }
    const int obj = (int)(ridx / d.R);
    const float* zs_o = zs + (size_t)obj * d.n_shape * W;
    const float* zt_o = zt + (size_t)obj * d.n_tex * W;

    // ---- forward recompute, each ReLU output rounded and its gates kept --
    wg_sync(g);                                    // the last pair is done with the buffers
    encode_ray_bf16(xyz + ridx * S * 3, vd + ridx * 3, S, d.l_xyz, d.l_dir, false, f, g, pe,
                    dpe);
    direction_term_wg(dpe, d_dir, w.w_vd_b, W, false, f, hdir);
    wg_sync(g);
    encoding_frags(pe, f, abuf);
    ring_layer<W, kTileK / 16>(acc, abuf, f, ring, it);  // encoding_xyz
    relu_epilogue<W, true>(acc, f, w.b_xyz, nullptr, zs_o, mask_of(0));
    to_frags<W, KS>(acc, f, abuf);
    for (int j = 0; j < d.n_shape; ++j) {
      ring_layer<W, KS>(acc, abuf, f, ring, it);  // shape block j
      relu_epilogue<W, true>(acc, f, w.b_sh + j * W, nullptr,
                             j + 1 < d.n_shape ? zs_o + (j + 1) * W : nullptr, mask_of(1 + j));
      to_frags<W, KS>(acc, f, abuf);
    }
    ring_layer<W, KS>(acc, abuf, f, ring, it);  // encoding_shape
#pragma unroll
    for (int i = 0; i < W / 2; ++i)
      acc[i] = bf16_round(acc[i] + w.b_es[8 * (i >> 2) + 2 * f.tig + (i & 1)]);
    {
      const float2 s = row_dot<W>(acc, f, w.w_sg, 1, 0);       // the sigma head's logit
      if (f.tig == 0) {
        logit[f.r0] = s.x + w.b_sg[0];
        logit[f.r1] = s.y + w.b_sg[0];
      }
    }
    to_frags<W, KS>(acc, f, abuf);
    ring_layer<W, KS>(acc, abuf, f, ring, it);  // viewdir, trunk rows
    relu_epilogue<W, true>(acc, f, hdir, w.b_vd, zt_o, mask_of(m_vd));
    to_frags<W, KS>(acc, f, abuf);
    for (int j = 0; j < d.n_tex; ++j) {
      ring_layer<W, KS>(acc, abuf, f, ring, it);  // texture block j
      relu_epilogue<W, true>(acc, f, w.b_tx + j * W, nullptr,
                             j + 1 < d.n_tex ? zt_o + (j + 1) * W : nullptr, mask_of(m_tx0 + j));
      to_frags<W, KS>(acc, f, abuf);
    }
    ring_layer<W / 2, KS>(acc, abuf, f, ring, it);  // rgb_hidden
    relu_epilogue<W / 2, true>(acc, f, w.b_r1, nullptr, nullptr, mask_of(m_r1));
#pragma unroll
    for (int k = 0; k < 3; ++k) {                              // the rgb head
      const float2 s = row_dot<W / 2>(acc, f, w.w_r2, 3, k);
      if (f.tig == 0) {
        rgb[f.r0 * 3 + k] = s.x + w.b_r2[k];
        rgb[f.r1 * 3 + k] = s.y + w.b_r2[k];
      }
    }

    // ---- compositing replay + manual VJP (one thread a ray) -------------
    wg_sync(g);
    if (f.wt == 0)
      composite_vjp<true>(logit, rgb, z + (z_per_ray ? ridx : (size_t)obj) * S, S, white_bkgd,
                          g_rgb + ridx * 3, g_depth[ridx], g_acc[ridx], scratch, dsig, drgb,
                          live ? dz_part + ridx * S : nullptr);
    wg_sync(g);
    if (valid && !live)
      for (int i = f.wt; i < S; i += 128) dz_part[ridx * S + i] = 0.f;
    if (f.wt < kRows) gsig[f.wt] = f.wt < S ? bf16_round(dsig[f.wt] * sigmoid(logit[f.wt])) : 0.f;

    // ---- transposed decoder chain ------------------------------------------
    // rgb_out: g_hh[r][c] = relu'(hh) * sum_k r(drgb[r][k]) w_r2[c][k]
    {
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const int r = (i & 2) ? f.r1 : f.r0, c = 8 * (i >> 2) + 2 * f.tig + (i & 1);
        acc[i] = bf16_round(drgb[3 * r]) * w.w_r2[3 * c]
                 + bf16_round(drgb[3 * r + 1]) * w.w_r2[3 * c + 1]
                 + bf16_round(drgb[3 * r + 2]) * w.w_r2[3 * c + 2];
      }
      apply_gates<W / 2>(acc, f, mask_of(m_r1));
      to_frags<W / 2, KS_HALF>(acc, f, abuf);
      ring_layer<W, KS_HALF>(acc, abuf, f, ring, it);  // rgb_hidden^T
    }
    for (int j = d.n_tex - 1; j >= 0; --j) {
      apply_gates<W>(acc, f, mask_of(m_tx0 + j));
      to_frags<W, KS>(acc, f, abuf);
      ring_layer<W, KS>(acc, abuf, f, ring, it);  // texture block j^T
      column_sums_wg<W>(acc, f, g, S, part,
                        valid ? dzt_part + (ridx * d.n_tex + j) * W : nullptr, W, live);
    }
    apply_gates<W>(acc, f, mask_of(m_vd));
    to_frags<W, KS>(acc, f, abuf);  // g_v, rounded
    // the direction encodings' cotangent: per sample g_v @ Wvd_b^T, each
    // value rounded, summed over the ray, then the chain rule
    if (dir_n == 32) {
      ring_layer<32, KS>(acc, abuf, f, ring, it);  // viewdir direction rows^T
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = bf16_round(acc[i]);
      column_sums_wg<32>(acc, f, g, S, part, ddpe, d_dir, true);
    } else {
      ring_layer<64, KS>(acc, abuf, f, ring, it);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = bf16_round(acc[i]);
      column_sums_wg<64>(acc, f, g, S, part, ddpe, d_dir, true);
    }
    wg_sync(g);
    if (valid && f.wt == 0) {
      float dv[3];
      encode_backward_one_bf16(dpe, ddpe, d.l_dir, dv);
      for (int c = 0; c < 3; ++c) dvd[ridx * 3 + c] = live ? dv[c] : 0.f;
    }
    // encoding_shape's output e feeds both the viewdir layer and the sigma head
    ring_layer<W, KS>(acc, abuf, f, ring, it);  // viewdir trunk rows^T
#pragma unroll
    for (int i = 0; i < W / 2; ++i)
      acc[i] = fmaf(gsig[(i & 2) ? f.r1 : f.r0], w.w_sg[8 * (i >> 2) + 2 * f.tig + (i & 1)],
                    acc[i]);
    to_frags<W, KS>(acc, f, abuf);
    ring_layer<W, KS>(acc, abuf, f, ring, it);  // encoding_shape^T
    for (int j = d.n_shape - 1; j >= 0; --j) {
      apply_gates<W>(acc, f, mask_of(1 + j));
      to_frags<W, KS>(acc, f, abuf);
      ring_layer<W, KS>(acc, abuf, f, ring, it);  // shape block j^T
      column_sums_wg<W>(acc, f, g, S, part,
                        valid ? dzs_part + (ridx * d.n_shape + j) * W : nullptr, W, live);
    }
    apply_gates<W>(acc, f, mask_of(0));
    to_frags<W, KS>(acc, f, abuf);
    ring_layer<64, KS>(acc, abuf, f, ring, it);  // encoding_xyz^T
    // the points' cotangents: the encodings' into gpe (over the gates, all
    // read now), then the encoding's chain rule
    wg_sync(g);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      gpe[((i & 2) ? f.r1 : f.r0) * kPeStride + 8 * (i >> 2) + 2 * f.tig + (i & 1)] = acc[i];
    wg_sync(g);
    if (valid)
      for (int r = f.wt; r < S; r += 128) {
        float dx[3] = {0.f, 0.f, 0.f};
        if (live) encode_backward_one_bf16(pe + r * kPeStride, gpe + r * kPeStride, d.l_xyz, dx);
        float* o = dxyz + (ridx * S + r) * 3;
        o[0] = dx[0]; o[1] = dx[1]; o[2] = dx[2];
      }
  }
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

// The bfloat16 mode's entry: supnerf_render_bwd's arguments and the pack's
// bfloat16 weight tiles (ops/render.py bf16_tile_pack) after the weights
// (W outside {64, 128, 256} is refused).
template <int W>
static int launch_render_bwd_bf16(const float* xyz, const float* vd, const float* z,
                                  const float* zs, const float* zt,
                                  const supnerf::DecoderWeights* w, const void* tiles,
                                  const supnerf::Dims& d, int white_bkgd, int z_per_ray,
                                  const float* hit, const float* g_rgb, const float* g_depth,
                                  const float* g_acc, float* dxyz, float* dvd, float* dzs_part,
                                  float* dzt_part, float* dz_part, cudaStream_t stream) {
  using namespace supnerf;
  const int n_pairs = (d.B * d.R + 1) / 2;
  if (n_pairs == 0) return 0;
  const size_t smem = ring_smem_bytes<W, kBwdSlots>(tile_count(W, d.n_shape, d.n_tex, true))
                      + 2 * sizeof(float) * bwd_ray_words<W>(d.n_shape + d.n_tex + 3);
  cudaError_t err = cudaFuncSetAttribute(render_bwd_bf16_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  render_bwd_bf16_kernel<W><<<n_pairs < sms ? n_pairs : sms, kPairThreads, smem, stream>>>(
      xyz, vd, z, zs, zt, *w, static_cast<const unsigned char*>(tiles), d, white_bkgd,
      z_per_ray, hit, g_rgb, g_depth, g_acc, dxyz, dvd, dzs_part, dzt_part, dz_part);
  return (int)cudaGetLastError();
}

extern "C" int supnerf_render_bwd_bf16(const float* xyz, const float* vd, const float* z,
                                       const float* zs, const float* zt,
                                       const supnerf::DecoderWeights* w, const void* tiles,
                                       int B, int R, int S, int W, int n_shape, int n_tex,
                                       int l_xyz, int l_dir, int white_bkgd, int z_per_ray,
                                       const float* hit, const float* g_rgb,
                                       const float* g_depth, const float* g_acc, float* dxyz,
                                       float* dvd, float* dzs_part, float* dzt_part,
                                       float* dz_part, void* stream) {
  using namespace supnerf;
  const Dims d{B, R, S, W, n_shape, n_tex, l_xyz, l_dir};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 64:
      return launch_render_bwd_bf16<64>(xyz, vd, z, zs, zt, w, tiles, d, white_bkgd, z_per_ray,
                                        hit, g_rgb, g_depth, g_acc, dxyz, dvd, dzs_part,
                                        dzt_part, dz_part, st);
    case 128:
      return launch_render_bwd_bf16<128>(xyz, vd, z, zs, zt, w, tiles, d, white_bkgd, z_per_ray,
                                         hit, g_rgb, g_depth, g_acc, dxyz, dvd, dzs_part,
                                         dzt_part, dz_part, st);
    case 256:
      return launch_render_bwd_bf16<256>(xyz, vd, z, zs, zt, w, tiles, d, white_bkgd, z_per_ray,
                                         hit, g_rgb, g_depth, g_acc, dxyz, dvd, dzs_part,
                                         dzt_part, dz_part, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
