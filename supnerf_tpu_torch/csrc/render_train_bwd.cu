// K3: training backward of the fused render, first half: everything but the
// cross-ray reduction of the decoder weight gradients.
//
// Replaces, together with K4 (wgrad.cu), the TPU kernel
// supnerf_tpu/ops/pallas_render.py:_render_train_bwd_kernel in both its
// modes (pallas_call in _render_train_bwd_call, wrapped by
// _make_render_train_core for field_composite_train_pallas). Per ray it does
// K2's work (render_bwd.cu): the forward recompute with the ReLU sign
// patterns stashed as bits, the manual compositing VJP, the transposed
// decoder chain and the per-ray partial sums of dz_shape / dz_tex, which the
// wrapper sums over rays. In the data_grads=False mode (the NeRF branch of
// every training step: training batches are data) the chain stops at the
// first layer's pre-activation gradient. With data pointers given (the
// data_grads=True mode, field_composite_train_pallas's default) it runs
// K2's remaining chain on the same values: the first layer's transpose and
// the positional-encoding chain rule per point (dxyz), the viewdir layer's
// direction cotangent summed per ray (dviewdir), and the ray's dz row,
// which the wrapper sums over rays. The mode only adds these outputs, so
// the stash and dz_shape / dz_tex are the same bits in both.
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
// What bounds it on the H100: arithmetic. K2's chain is 0.89 MFLOP per point
// of forward recompute and 0.87 of transposed chain (the first layer's
// transpose is skipped; the data mode adds it back, W x 63 multiply-adds per
// point, and writes 12 B of dxyz per point): 5.5 ms for the training path's
// 8 x 1024 x 64 points on the tensor cores at float32 accuracy (3xTF32),
// 13.6 ms at the float32 FMA peak. The stash is 15.6 KB per point, 8.2 GB
// for those points, 2.4 ms at 3.35 TB/s. So the kernel is K2's
// (render_bwd.cu) with the stash writes added: every dense layer of the
// forward recompute and of the transposed chain on dense_mma
// (render_common.cuh: 3xTF32 mma.sync, the output columns split across the
// warps, each warp's slice of the weights streamed through its own cp.async
// ring, every k-step's tensor-core sum added in float32), the ray's
// activations in shared memory at a row stride of W + kMmaPad, the layers in
// K2's order, the elementwise steps in K2's division-free per-row form. The
// ReLU layers take dense_mma's kRefine step as in K1: a pre-activation
// within 2^-20 of its row's scale from zero is recomputed in float64 before
// the ReLU and its bit mask, since a gate on the other side from float64's
// turns a whole gradient row of the point. The stash rows are copied out of
// the W + kMmaPad-strided buffers by render_common.cuh:stash_rows (K7's
// copy too): a warp per row, 16-byte streaming stores (every stash column
// block and every activation row starts on 16 bytes), and no barrier of its
// own, since the buffer a copy reads is rewritten only after the next
// barrier of the chain. Shared memory
// is K2's (~224 KB at W 256, 3 shape and 1 texture block, the weight rings
// included): one block of 8 warps per SM.
// The bfloat16 mode (render_train_bwd_bf16_kernel, the same body with
// kBf16): pallas_render.py:_render_train_bwd_kernel at dtype=bfloat16, K2's
// bfloat16 arithmetic (render_bwd.cu) on the training encodings (kPeTrain:
// exact sines and cosines rounded, the direction term rounded), with the
// stash in the layout of the float32 mode: the A side (layer inputs, the
// direction encoding) bfloat16-exact, since the Pallas kernel's weight
// products (mm_xg) cast both operands: the recompute's encodings and
// rounded ReLU outputs as they are, e and each latent-added input rounded
// as stash_rows<true> stores them; the G side float32 and unrounded, since
// every bias gradient sums the float32 cotangent; the ray's r_gv the sum of
// its rounded g_v (the Pallas kernel's seg_reduce). K4's bfloat16 entry
// rounds G where it enters a product. The data mode's direction cotangent
// is formed per sample, rounded and summed over the ray, as in K2's mode.
#include "render_common.cuh"

namespace supnerf {

template <bool kBf16>
static __device__ __forceinline__ void render_train_bwd_body(
    const float* __restrict__ xyz, const float* __restrict__ vd, const float* __restrict__ z,
    const float* __restrict__ zs, const float* __restrict__ zt, const DecoderWeights& w,
    const Dims& d, int white_bkgd, const float* __restrict__ g_rgb,
    const float* __restrict__ g_depth, const float* __restrict__ g_acc, const StashLayout& st,
    float* __restrict__ dzs_part, float* __restrict__ dzt_part, float* __restrict__ dxyz,
    float* __restrict__ dvd, float* __restrict__ dz_part) {
  const int ray = blockIdx.x, obj = blockIdx.y;
  const int W = d.W, W2 = d.W / 2, S = d.S;
  const int nj = W / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t ray_idx = (size_t)obj * d.R + ray;
  const int n_masks = d.n_shape + d.n_tex + 3;
  float* pt = st.pt + ray_idx * S * st.ld_pt;      // this ray's first stash row
  float* rrow = st.ray + ray_idx * st.ld_ray;

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
  // mask slots: 0 = encoding_xyz, 1..n_shape = shape blocks, then viewdir,
  // texture blocks, rgb_hidden
  auto mask_of = [&](int layer) { return masks + (size_t)layer * kRows * nj; };
  const int m_vd = d.n_shape + 1, m_tx0 = d.n_shape + 2, m_r1 = n_masks - 1;

  // ---- forward recompute: ReLU patterns to shared memory, layer inputs to
  // the stash (kBf16: each ReLU output rounded, round_out) -----------------
  if constexpr (kBf16) {
    encode_points_bf16(xyz + ray_idx * S * 3, S, d.l_xyz, true, pe);
    direction_term_bf16(vd + ray_idx * 3, d.l_dir, kPeTrain, w, W, dpe, hdir);    // syncs
  } else {
    encode_points(xyz + ray_idx * S * 3, S, d.l_xyz, pe);
    direction_term(vd + ray_idx * 3, d.l_dir, w, W, dpe, hdir);                   // syncs
  }
  const int d_xyz = pe_width(d.l_xyz), d_dir = pe_width(d.l_dir);
  stash_rows(pe, kPeStride, d_xyz, S, pt + st.a_xyz, st.ld_pt);
  for (int k = threadIdx.x; k < d_dir; k += kThreads) rrow[st.r_dpe + k] = dpe[k];

  dense_layer<kBf16, true>(pe, kPeStride, d_xyz, w.w_xyz, W, w.b_xyz, buf_a, Ws, true,
                           mask_of(0), stage, nullptr, 0, 0, nullptr, nullptr, kBf16);
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int j = 0; j < d.n_shape; ++j) {
    add_row_vector(cur, Ws, W, zs + ((size_t)obj * d.n_shape + j) * W);
    stash_rows<kBf16>(cur, Ws, W, S, pt + st.a_sh + j * W, st.ld_pt);
    dense_layer<kBf16, true>(cur, Ws, W, w.w_sh + (size_t)j * W * W, W, w.b_sh + j * W, nxt, Ws,
                             true, mask_of(1 + j), stage, nullptr, 0, 0, nullptr, nullptr,
                             kBf16);
    float* t = cur; cur = nxt; nxt = t;
  }
  stash_rows(cur, Ws, W, S, pt + st.a_es, st.ld_pt);
  dense_layer<kBf16>(cur, Ws, W, w.w_es, W, w.b_es, nxt, Ws, false, nullptr, stage);
  { float* t = cur; cur = nxt; nxt = t; }                       // cur = e
  stash_rows<kBf16>(cur, Ws, W, S, pt + st.a_e, st.ld_pt);
  head<kBf16>(cur, Ws, W, w.w_sg, 1, w.b_sg, logit);
  dense_layer<kBf16, true>(cur, Ws, W, w.w_vd_a, W, hdir, nxt, Ws, true, mask_of(m_vd), stage,
                           nullptr, 0, 0, nullptr, nullptr, kBf16);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = 0; j < d.n_tex; ++j) {
    add_row_vector(cur, Ws, W, zt + ((size_t)obj * d.n_tex + j) * W);
    stash_rows<kBf16>(cur, Ws, W, S, pt + st.a_tx + j * W, st.ld_pt);
    dense_layer<kBf16, true>(cur, Ws, W, w.w_tx + (size_t)j * W * W, W, w.b_tx + j * W, nxt, Ws,
                             true, mask_of(m_tx0 + j), stage, nullptr, 0, 0, nullptr, nullptr,
                             kBf16);
    float* t = cur; cur = nxt; nxt = t;
  }
  stash_rows(cur, Ws, W, S, pt + st.a_r1, st.ld_pt);
  dense_layer<kBf16, true>(cur, Ws, W, w.w_r1, W2, w.b_r1, nxt, Ws, true, mask_of(m_r1), stage,
                           nullptr, 0, 0, nullptr, nullptr, kBf16);
  stash_rows(nxt, Ws, W2, S, pt + st.a_hh, st.ld_pt);
  head<kBf16>(nxt, Ws, W2, w.w_r2, 3, w.b_r2, rgb);

  // ---- compositing forward replay + manual VJP (one thread per ray; the
  // ray's dz row only in the data mode) ------------------------------------
  // Reuses buf_a as per-sample scratch: alpha, T (exclusive), w, gw.
  const bool data = dxyz != nullptr;
  if (threadIdx.x == 0)
    composite_vjp<kBf16>(logit, rgb, z + (size_t)obj * S, S, white_bkgd, g_rgb + ray_idx * 3,
                         g_depth[ray_idx], g_acc[ray_idx], buf_a, dsig, drgb,
                         data ? dz_part + ray_idx * S : nullptr);
  __syncthreads();
  stash_rows(drgb, 3, 3, S, pt + st.g_rgb, st.ld_pt);
  for (int r = threadIdx.x; r < S; r += kThreads)
    pt[(size_t)r * st.ld_pt + st.g_sig] = dsig[r] * sigmoid(logit[r]);

  // ---- transposed decoder chain, pre-activation gradients to the stash ----
  // (kBf16: each cotangent rounded where it enters a product, rd)
  auto rd = [](float x) { return kBf16 ? bf16_round(x) : x; };
  // rgb_out: g_hh[r][c] = relu'(hh) * sum_k drgb[r][k] w_r2[c][k]
  for (int r = warp; r < kRows; r += kThreads / 32)
    for (int c = lane; c < W2; c += 32)
      buf_a[r * Ws + c] = rd(drgb[3 * r]) * w.w_r2[3 * c] + rd(drgb[3 * r + 1]) * w.w_r2[3 * c + 1]
                          + rd(drgb[3 * r + 2]) * w.w_r2[3 * c + 2];
  __syncthreads();
  apply_mask(buf_a, Ws, W2, mask_of(m_r1));
  stash_rows(buf_a, Ws, W2, S, pt + st.g_hh, st.ld_pt);
  dense_layer<kBf16>(buf_a, Ws, W2, w.wt_r1, W, nullptr, buf_b, Ws, false, nullptr, stage);
  cur = buf_b; nxt = buf_a;
  float* colsum = hdir;   // the direction term is no longer needed
  for (int j = d.n_tex - 1; j >= 0; --j) {
    apply_mask(cur, Ws, W, mask_of(m_tx0 + j));
    stash_rows(cur, Ws, W, S, pt + st.g_tx + j * W, st.ld_pt);
    dense_layer<kBf16>(cur, Ws, W, w.wt_tx + (size_t)j * W * W, W, nullptr, nxt, Ws, false,
                       nullptr, stage);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, Ws, W, S, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads)
      dzt_part[(ray_idx * d.n_tex + j) * W + c] = colsum[c];
  }
  apply_mask(cur, Ws, W, mask_of(m_vd));           // cur = g_v
  stash_rows(cur, Ws, W, S, pt + st.g_v, st.ld_pt);
  // the direction encoding is per ray: the viewdir layer's direction rows
  // get dpe^T (sum over the ray's samples of g_v, each rounded with kBf16),
  // formed by K4 over rays
  column_sums<kBf16>(cur, Ws, W, S, colsum);
  for (int c = threadIdx.x; c < W; c += kThreads) rrow[st.r_gv + c] = colsum[c];
  if (data) {
    if constexpr (kBf16) {
      // per sample g_v @ Wvd_b^T (into nxt, kPeStride a row), each value
      // rounded, summed over the ray's rows, then the chain rule
      dense_layer<true>(cur, Ws, W, w.wt_vd_b, d_dir, nullptr, nxt, kPeStride, false, nullptr,
                        stage);
      for (int k = threadIdx.x; k < d_dir; k += kThreads) {
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
      ray_direction_cotangent(colsum, dpe, w, W, d.l_dir, ddpe, dvd + ray_idx * 3);
    }
  }
  // encoding_shape output e feeds both the viewdir layer and the sigma head
  dense_layer<kBf16>(cur, Ws, W, w.wt_vd_a, W, nullptr, nxt, Ws, false, nullptr, stage);
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const float g_sig = (r < S) ? rd(dsig[r] * sigmoid(logit[r])) : 0.f;
    for (int c = lane; c < W; c += 32) nxt[r * Ws + c] = fmaf(g_sig, w.w_sg[c], nxt[r * Ws + c]);
  }
  __syncthreads();
  { float* t = cur; cur = nxt; nxt = t; }                 // cur = g_e
  stash_rows(cur, Ws, W, S, pt + st.g_e, st.ld_pt);
  dense_layer<kBf16>(cur, Ws, W, w.wt_es, W, nullptr, nxt, Ws, false, nullptr, stage);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = d.n_shape - 1; j >= 0; --j) {
    apply_mask(cur, Ws, W, mask_of(1 + j));
    stash_rows(cur, Ws, W, S, pt + st.g_sh + j * W, st.ld_pt);
    dense_layer<kBf16>(cur, Ws, W, w.wt_sh + (size_t)j * W * W, W, nullptr, nxt, Ws, false,
                       nullptr, stage);
    { float* t = cur; cur = nxt; nxt = t; }
    column_sums(cur, Ws, W, S, colsum);
    for (int c = threadIdx.x; c < W; c += kThreads)
      dzs_part[(ray_idx * d.n_shape + j) * W + c] = colsum[c];
  }
  apply_mask(cur, Ws, W, mask_of(0));
  stash_rows(cur, Ws, W, S, pt + st.g_xyz, st.ld_pt);
  if (data) {
    // the points' cotangents: g @ Wxyz^T (into nxt, kPeStride a row), then
    // the encoding's chain rule
    dense_layer<kBf16>(cur, Ws, W, w.wt_xyz, d_xyz, nullptr, nxt, kPeStride, false, nullptr,
                       stage);
    encode_backward_rows<kBf16>(pe, nxt, d.l_xyz, S, dxyz + ray_idx * S * 3);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
render_train_bwd_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                        const float* __restrict__ z, const float* __restrict__ zs,
                        const float* __restrict__ zt, DecoderWeights w, Dims d,
                        int white_bkgd, const float* __restrict__ g_rgb,
                        const float* __restrict__ g_depth, const float* __restrict__ g_acc,
                        StashLayout st, float* __restrict__ dzs_part,
                        float* __restrict__ dzt_part, float* __restrict__ dxyz,
                        float* __restrict__ dvd, float* __restrict__ dz_part) {
  render_train_bwd_body<false>(xyz, vd, z, zs, zt, w, d, white_bkgd, g_rgb, g_depth, g_acc, st,
                               dzs_part, dzt_part, dxyz, dvd, dz_part);
}

__global__ void __launch_bounds__(kThreads, 1)
render_train_bwd_bf16_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                             const float* __restrict__ z, const float* __restrict__ zs,
                             const float* __restrict__ zt, DecoderWeights w, Dims d,
                             int white_bkgd, const float* __restrict__ g_rgb,
                             const float* __restrict__ g_depth, const float* __restrict__ g_acc,
                             StashLayout st, float* __restrict__ dzs_part,
                             float* __restrict__ dzt_part, float* __restrict__ dxyz,
                             float* __restrict__ dvd, float* __restrict__ dz_part) {
  render_train_bwd_body<true>(xyz, vd, z, zs, zt, w, d, white_bkgd, g_rgb, g_depth, g_acc, st,
                              dzs_part, dzt_part, dxyz, dvd, dz_part);
}

size_t render_train_bwd_smem_bytes(int W, int n_shape, int n_tex) {
  const size_t floats = (size_t)kMmaStageFloats + 2 * kRows * (W + kMmaPad)
                        + kRows * kPeStride + W + 2 * kMaxDirPe + kRows * 8;
  const size_t words = (size_t)(n_shape + n_tex + 3) * kRows * (W / 32);
  return sizeof(float) * floats + sizeof(uint32_t) * words;
}

// Launches `kernel` (either build) on `stream`.
template <typename Kernel>
static int launch_train_bwd(Kernel kernel, const float* xyz, const float* vd, const float* z,
                            const float* zs, const float* zt, const DecoderWeights* w,
                            const Dims& d, int white_bkgd, const float* g_rgb,
                            const float* g_depth, const float* g_acc, const StashLayout* stash,
                            float* dzs_part, float* dzt_part, float* dxyz, float* dvd,
                            float* dz_part, void* stream) {
  const size_t smem = render_train_bwd_smem_bytes(d.W, d.n_shape, d.n_tex);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(d.R, d.B), kThreads, smem, (cudaStream_t)stream>>>(
      xyz, vd, z, zs, zt, *w, d, white_bkgd, g_rgb, g_depth, g_acc, *stash, dzs_part,
      dzt_part, dxyz, dvd, dz_part);
  return (int)cudaGetLastError();
}

}  // namespace supnerf

// Plain C entry, bound with ctypes. dxyz, dvd and dz_part are all null (the
// data_grads=False mode) or all given. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises or allocates.
extern "C" int supnerf_render_train_bwd(const float* xyz, const float* vd, const float* z,
                                        const float* zs, const float* zt,
                                        const supnerf::DecoderWeights* w, int B, int R,
                                        int S, int W, int n_shape, int n_tex, int l_xyz,
                                        int l_dir, int white_bkgd, const float* g_rgb,
                                        const float* g_depth, const float* g_acc,
                                        const supnerf::StashLayout* stash, float* dzs_part,
                                        float* dzt_part, float* dxyz, float* dvd,
                                        float* dz_part, void* stream) {
  using namespace supnerf;
  return launch_train_bwd(render_train_bwd_kernel, xyz, vd, z, zs, zt, w,
                          Dims{B, R, S, W, n_shape, n_tex, l_xyz, l_dir}, white_bkgd, g_rgb,
                          g_depth, g_acc, stash, dzs_part, dzt_part, dxyz, dvd, dz_part, stream);
}

// The bfloat16 mode's entry: supnerf_render_train_bwd's arguments.
extern "C" int supnerf_render_train_bwd_bf16(const float* xyz, const float* vd, const float* z,
                                             const float* zs, const float* zt,
                                             const supnerf::DecoderWeights* w, int B, int R,
                                             int S, int W, int n_shape, int n_tex, int l_xyz,
                                             int l_dir, int white_bkgd, const float* g_rgb,
                                             const float* g_depth, const float* g_acc,
                                             const supnerf::StashLayout* stash,
                                             float* dzs_part, float* dzt_part, float* dxyz,
                                             float* dvd, float* dz_part, void* stream) {
  using namespace supnerf;
  return launch_train_bwd(render_train_bwd_bf16_kernel, xyz, vd, z, zs, zt, w,
                          Dims{B, R, S, W, n_shape, n_tex, l_xyz, l_dir}, white_bkgd, g_rgb,
                          g_depth, g_acc, stash, dzs_part, dzt_part, dxyz, dvd, dz_part, stream);
}
