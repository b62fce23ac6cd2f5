// K1: fused conditioned-field + volume-compositing forward render.
//
// Replaces the TPU kernel supnerf_tpu/ops/pallas_render.py:_render_kernel in
// its shared-z mode with XLA-side positional encoding (pallas_call in
// _render_fwd_call; entry points field_composite_pallas and the forward of
// field_composite_apply) and in its per-ray-z + hit mode (the AABB contract:
// field_composite_aabb_pallas and the forward of field_composite_aabb_apply).
// The two modes differ only in the compositing: with z_per_ray each ray reads
// its own z row (B, R, S) instead of its object's (B, S), and a hit column
// (B, R) zeroes the density of rays that miss the box after the softplus
// (the Pallas kernel's sig_m * hit, the unfused path's where(hit, sigma, 0)).
// A missed ray's outputs are then constants, so its block writes them and
// returns without running the decoder.
// Same function: for every ray, the CodeNeRF decoder
// on each sample's 63-wide point encoding (encoding_xyz, shape blocks each
// adding z_shape[j], encoding_shape, softplus sigma head, viewdir layer with
// the per-ray 27-wide direction encoding, texture blocks adding z_tex[j],
// rgb_hidden, rgb_out), then alpha compositing of the ray's S samples into
// rgb, depth and acc_trans (ops/volume_render.py contract: last delta 1e10,
// transmittance max(1 - alpha, 0) + 1e-10, acc_trans = exclusive cumprod's
// last element), with an optional white background.
//
// Differences from the TPU design: an object axis in the grid (blockIdx.y)
// replaces the vmap over objects; the positional encodings are computed in
// the kernel (no 63 + 27 floats per point streamed from HBM); compositing is
// one sequential pass per ray instead of the triangular-matrix cumprod and
// segment-mask matmuls, which were devices of the TPU's matrix unit.
//
// What bounds it on the H100: arithmetic. Per point the decoder takes
// 63*256 + 3*256*256 + 256*256 + 256 + 256*256 + 256*256 + 256*128 + 128*3
// = 442,752 multiply-adds = 0.89 MFLOP (W = 256, 3 shape blocks, 1 texture
// block), so 58 GFLOP for one object's 1024 x 64 loss render, against
// 7 MB of point input: about 8,000 FLOP per byte, far above the card's
// balance point. For the TTO path's 2 objects that is 0.70 ms on the tensor
// cores at float32 accuracy (3xTF32: three TF32 products per product, 495
// TFLOP/s) and 1.73 ms at the float32 FMA peak (67 TFLOP/s). So the nine
// dense layers run on dense_mma (render_common.cuh), as K2's do: 3xTF32
// mma.sync with the output columns split across the warps, each warp's
// slice of the weights streamed through its own cp.async ring in shared
// memory (each weight element enters the SM once per block), every k-step's
// tensor-core sum added in float32. The block keeps its ray's 64 x W
// activations in shared memory across all layers at a row stride of W +
// kMmaPad floats, and the point encoding at kPeLd = kPeStride + kMmaPad
// (both 4 mod 32: the A-fragment loads hit 32 distinct banks), so no
// per-point activation reaches device memory. A forward keeps no ReLU
// patterns (mask nullptr). Its ReLU layers take dense_mma's kRefine step: a
// pre-activation within 2^-20 of its row's scale from zero is recomputed in
// float64, so its gate is the exact one for the layer's float32 inputs.
// The layers, their order and their arithmetic are those of K3's forward
// recompute and K2's, so the forward that K2 and K3 differentiate is the
// one K1 returns. Shared memory (~209 KB at
// W 256, the weight rings included) allows one block of 8 warps per SM; the
// sigma and rgb heads, the direction term and the one-thread compositing
// stay on the CUDA cores and leave the tensor cores idle for their span,
// and mma.sync runs below wgmma's rate, so the kernel stays short of the
// bound.
//
// The bfloat16 mode (render_fwd_bf16_kernel<W>, render_bf16.cuh): the
// Pallas kernel at dtype=bfloat16 (render_common.cuh's note): the encodings
// by the doubling recurrence and rounded, the per-ray direction term
// rounded, every dense layer's operands bfloat16 and its sums float32, the
// heads on rounded operands; compositing stays float32. pe_mode
// (render_common.cuh PeMode): kPeExact, the exact encodings and an
// unrounded direction term (A11a, field_composite_pallas(pe_in_kernel=
// True)); kPeTrain, the exact encodings and the direction term rounded
// (A5, the training forward of field_composite_train_pallas on per-object
// latents: _make_render_train_core's encode). Its bound is a sixth of the
// float32 build's (989 TFLOP/s against 495 / 3), so the weights' bytes and
// the fragments' conversions, which the float32 design could hide, decide
// it: the build is redesigned for Hopper in render_bf16.cuh (its note says
// what bounds it and what the design does): two rays a block on one stream
// of bfloat16 weight tiles (cp.async.bulk into a ring of mbarrier slots),
// wgmma with the activations in registers, the heads from registers; the
// compositing, the encodings and the direction term stay on the CUDA cores.
#include "render_bf16.cuh"

namespace supnerf {

static __device__ __forceinline__ void render_fwd_body(
    const float* __restrict__ xyz, const float* __restrict__ vd, const float* __restrict__ z,
    const float* __restrict__ zs, const float* __restrict__ zt, const DecoderWeights& w,
    const Dims& d, int white_bkgd, int z_per_ray, const float* __restrict__ hit,
    float* __restrict__ out_rgb, float* __restrict__ out_depth, float* __restrict__ out_acc) {
  const int ray = blockIdx.x, obj = blockIdx.y;
  const int W = d.W, W2 = d.W / 2, S = d.S;
  const size_t ray_idx = (size_t)obj * d.R + ray;

  // A ray that misses its box has zero density on every sample, so its
  // weights are 0 and its transmittance stays 1: rgb 0 (1 on a white
  // background), depth 0, acc 1 exactly, with no decoder work.
  if (hit != nullptr && hit[ray_idx] == 0.f) {
    if (threadIdx.x < 3) out_rgb[ray_idx * 3 + threadIdx.x] = white_bkgd ? 1.f : 0.f;
    if (threadIdx.x == 0) {
      out_depth[ray_idx] = 0.f;
      out_acc[ray_idx] = 1.f;
    }
    return;
  }

  extern __shared__ float smem[];
  const int Ws = W + kMmaPad;                // activation row stride
  float* stage = smem;                       // kMmaStageFloats, dense_mma's weight slices
  float* buf_a = stage + kMmaStageFloats;    // kRows x Ws
  float* buf_b = buf_a + kRows * Ws;         // kRows x Ws
  float* pe = buf_b + kRows * Ws;            // kRows x kPeLd
  float* hdir = pe + kRows * kPeLd;          // W
  float* dpe = hdir + W;                     // kMaxDirPe
  float* sig = dpe + kMaxDirPe;              // kRows
  float* rgb = sig + kRows;                  // kRows x 3

  encode_points<kPeLd>(xyz + ray_idx * S * 3, S, d.l_xyz, pe);
  direction_term(vd + ray_idx * 3, d.l_dir, w, W, dpe, hdir);  // syncs

  dense_layer<false, true>(pe, kPeLd, pe_width(d.l_xyz), w.w_xyz, W, w.b_xyz, buf_a, Ws, true,
                           nullptr, stage);
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int j = 0; j < d.n_shape; ++j) {
    add_row_vector(cur, Ws, W, zs + ((size_t)obj * d.n_shape + j) * W);
    dense_layer<false, true>(cur, Ws, W, w.w_sh + (size_t)j * W * W, W, w.b_sh + j * W, nxt, Ws,
                             true, nullptr, stage);
    float* t = cur; cur = nxt; nxt = t;
  }
  dense_layer<false>(cur, Ws, W, w.w_es, W, w.b_es, nxt, Ws, false, nullptr, stage);
  { float* t = cur; cur = nxt; nxt = t; }
  head(cur, Ws, W, w.w_sg, 1, w.b_sg, sig);
  dense_layer<false, true>(cur, Ws, W, w.w_vd_a, W, hdir, nxt, Ws, true, nullptr, stage);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = 0; j < d.n_tex; ++j) {
    add_row_vector(cur, Ws, W, zt + ((size_t)obj * d.n_tex + j) * W);
    dense_layer<false, true>(cur, Ws, W, w.w_tx + (size_t)j * W * W, W, w.b_tx + j * W, nxt, Ws,
                             true, nullptr, stage);
    float* t = cur; cur = nxt; nxt = t;
  }
  dense_layer<false, true>(cur, Ws, W, w.w_r1, W2, w.b_r1, nxt, Ws, true, nullptr, stage);
  head(nxt, Ws, W2, w.w_r2, 3, w.b_r2, rgb);

  if (threadIdx.x == 0) {
    const float* zr = z + (z_per_ray ? ray_idx : (size_t)obj) * S;
    float T = 1.f, acc = 1.f, wsum = 0.f, depth = 0.f;
    float c0 = 0.f, c1 = 0.f, c2 = 0.f;
    for (int s = 0; s < S; ++s) {
      const float delta = (s < S - 1) ? zr[s + 1] - zr[s] : kLastDelta;
      const float sg = softplus(sig[s]);
      const float alpha = 1.f - expf(-fmaxf(sg, 0.f) * delta);
      const float wt = alpha * T;
      c0 = fmaf(wt, rgb[3 * s], c0);
      c1 = fmaf(wt, rgb[3 * s + 1], c1);
      c2 = fmaf(wt, rgb[3 * s + 2], c2);
      depth = fmaf(wt, zr[s], depth);
      wsum += wt;
      if (s == S - 1) acc = T;
      T *= fmaxf(1.f - alpha, 0.f) + kEpsTrans;
    }
    if (white_bkgd) {
      c0 += 1.f - wsum; c1 += 1.f - wsum; c2 += 1.f - wsum;
    }
    out_rgb[ray_idx * 3] = c0;
    out_rgb[ray_idx * 3 + 1] = c1;
    out_rgb[ray_idx * 3 + 2] = c2;
    out_depth[ray_idx] = depth;
    out_acc[ray_idx] = acc;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
render_fwd_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                  const float* __restrict__ z, const float* __restrict__ zs,
                  const float* __restrict__ zt, DecoderWeights w, Dims d,
                  int white_bkgd, int z_per_ray, const float* __restrict__ hit,
                  float* __restrict__ out_rgb,
                  float* __restrict__ out_depth, float* __restrict__ out_acc) {
  render_fwd_body(xyz, vd, z, zs, zt, w, d, white_bkgd, z_per_ray, hit, out_rgb, out_depth,
                  out_acc);
}

// One ray's compositing from its density logits sig and colours rgb (S
// samples) and its z row, by one thread (the float32 build's arithmetic).
static __device__ void composite_ray(const float* sig, const float* rgb, const float* zr, int S,
                                     int white_bkgd, float* o_rgb, float* o_depth,
                                     float* o_acc) {
  float T = 1.f, acc = 1.f, wsum = 0.f, depth = 0.f;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  for (int s = 0; s < S; ++s) {
    const float delta = (s < S - 1) ? zr[s + 1] - zr[s] : kLastDelta;
    const float sg = softplus(sig[s]);
    const float alpha = 1.f - expf(-fmaxf(sg, 0.f) * delta);
    const float wt = alpha * T;
    c0 = fmaf(wt, rgb[3 * s], c0);
    c1 = fmaf(wt, rgb[3 * s + 1], c1);
    c2 = fmaf(wt, rgb[3 * s + 2], c2);
    depth = fmaf(wt, zr[s], depth);
    wsum += wt;
    if (s == S - 1) acc = T;
    T *= fmaxf(1.f - alpha, 0.f) + kEpsTrans;
  }
  if (white_bkgd) {
    c0 += 1.f - wsum; c1 += 1.f - wsum; c2 += 1.f - wsum;
  }
  o_rgb[0] = c0;
  o_rgb[1] = c1;
  o_rgb[2] = c2;
  *o_depth = depth;
  *o_acc = acc;
}

// Ring slots of K1's bfloat16 build: 64 KB of weight tiles in flight
constexpr int kFwdSlots = 4;

// 4-byte words of one warpgroup's buffers: its A fragments (W / 16
// k-steps of 4 words a thread), the point encodings, the direction
// encoding, the direction term, the density logits, the colours
template <int W>
__host__ __device__ constexpr int fwd_ray_words() {
  return W / 16 * 4 * 128 + kRows * kPeStride + kMaxDirPe + W + kRows + 3 * kRows;
}

// The bfloat16 build (render_bf16.cuh): a persistent grid, blockIdx.x
// taking ray pairs blockIdx.x, + gridDim.x, ...; warpgroup g the pair's
// ray 2 p + g of the B x R (the second of an odd count absent). A pair
// whose rays both miss their boxes takes no tile: its blocks write the
// missed rays' constants. A missed ray of a pair with work runs the
// decoder with its partner (every warp releases every tile) and writes
// its constants.
template <int W>
__global__ void __launch_bounds__(kPairThreads, 1)
render_fwd_bf16_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                       const float* __restrict__ z, const float* __restrict__ zs,
                       const float* __restrict__ zt, DecoderWeights w,
                       const unsigned char* __restrict__ tiles, Dims d, int white_bkgd,
                       int z_per_ray, const float* __restrict__ hit, int pe_mode,
                       float* __restrict__ out_rgb, float* __restrict__ out_depth,
                       float* __restrict__ out_acc) {
  constexpr int KS = W / 16;                  // k-steps of a W-wide layer input
  extern __shared__ unsigned char smem_raw[];
  const int n_rays = d.B * d.R, n_pairs = (n_rays + 1) / 2, S = d.S;
  unsigned char* rest;
  const auto ring = ring_setup<W, kFwdSlots>(smem_raw, d, 0, false, tiles,
                                             block_active_pairs(hit, n_rays), &rest);
  const int g = threadIdx.x >> 7;
  const Frag f = frag_of_thread();
  uint32_t* abuf = reinterpret_cast<uint32_t*>(rest) + g * fwd_ray_words<W>();
  float* pe = reinterpret_cast<float*>(abuf + W / 16 * 4 * 128);
  float* dpe = pe + kRows * kPeStride;
  float* hdir = dpe + kMaxDirPe;
  float* sig = hdir + W;
  float* rgb = sig + kRows;
  const bool exact = pe_mode != kPeDoubling;

  float acc[W / 2];
  int it = 0;                                 // the block's next tile
  for (int p = blockIdx.x; p < n_pairs; p += gridDim.x) {
    const int ray = 2 * p + g;
    const bool valid = ray < n_rays;
    const size_t ridx = valid ? ray : ray - 1;
    const bool live = valid && (hit == nullptr || hit[ridx] != 0.f);
    // a missed ray: zero density, so rgb 0 (1 on a white background),
    // depth 0, acc 1 exactly
    if (valid && !live && f.wt == 0) {
      for (int c = 0; c < 3; ++c) out_rgb[ridx * 3 + c] = white_bkgd ? 1.f : 0.f;
      out_depth[ridx] = 0.f;
      out_acc[ridx] = 1.f;
    }
    if (!pair_active(hit, p, n_rays)) continue;
    const int obj = (int)(ridx / d.R);
    const float* zs_o = zs + (size_t)obj * d.n_shape * W;
    const float* zt_o = zt + (size_t)obj * d.n_tex * W;

    wg_sync(g);                               // the last pair's compositing is done
    encode_ray_bf16(xyz + ridx * S * 3, vd + ridx * 3, S, d.l_xyz, d.l_dir, exact, f, g, pe,
                    dpe);
    direction_term_wg(dpe, pe_width(d.l_dir), w.w_vd_b, W, pe_mode == kPeExact, f, hdir);
    wg_sync(g);
    encoding_frags(pe, f, abuf);
    ring_layer<W, kTileK / 16>(acc, abuf, f, ring, it);  // encoding_xyz
    relu_epilogue<W, false>(acc, f, w.b_xyz, nullptr, zs_o, nullptr);
    to_frags<W, KS>(acc, f, abuf);
    for (int j = 0; j < d.n_shape; ++j) {
      ring_layer<W, KS>(acc, abuf, f, ring, it);  // shape block j
      relu_epilogue<W, false>(acc, f, w.b_sh + j * W, nullptr,
                              j + 1 < d.n_shape ? zs_o + (j + 1) * W : nullptr, nullptr);
      to_frags<W, KS>(acc, f, abuf);
    }
    ring_layer<W, KS>(acc, abuf, f, ring, it);  // encoding_shape
#pragma unroll
    for (int i = 0; i < W / 2; ++i)
      acc[i] = bf16_round(acc[i] + w.b_es[8 * (i >> 2) + 2 * f.tig + (i & 1)]);
    {
      const float2 s = row_dot<W>(acc, f, w.w_sg, 1, 0);       // the sigma head
      if (f.tig == 0) {
        sig[f.r0] = s.x + w.b_sg[0];
        sig[f.r1] = s.y + w.b_sg[0];
      }
    }
    to_frags<W, KS>(acc, f, abuf);
    ring_layer<W, KS>(acc, abuf, f, ring, it);  // viewdir, trunk rows
    relu_epilogue<W, false>(acc, f, hdir, w.b_vd, zt_o, nullptr);
    to_frags<W, KS>(acc, f, abuf);
    for (int j = 0; j < d.n_tex; ++j) {
      ring_layer<W, KS>(acc, abuf, f, ring, it);  // texture block j
      relu_epilogue<W, false>(acc, f, w.b_tx + j * W, nullptr,
                              j + 1 < d.n_tex ? zt_o + (j + 1) * W : nullptr, nullptr);
      to_frags<W, KS>(acc, f, abuf);
    }
    ring_layer<W / 2, KS>(acc, abuf, f, ring, it);  // rgb_hidden
    relu_epilogue<W / 2, false>(acc, f, w.b_r1, nullptr, nullptr, nullptr);
#pragma unroll
    for (int i = 0; i < W / 4; ++i) acc[i] = bf16_round(acc[i]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {                              // the rgb head
      const float2 s = row_dot<W / 2>(acc, f, w.w_r2, 3, k);
      if (f.tig == 0) {
        rgb[f.r0 * 3 + k] = s.x + w.b_r2[k];
        rgb[f.r1 * 3 + k] = s.y + w.b_r2[k];
      }
    }
    wg_sync(g);
    if (live && f.wt == 0)
      composite_ray(sig, rgb, z + (z_per_ray ? ridx : (size_t)obj) * S, S, white_bkgd,
                    out_rgb + ridx * 3, out_depth + ridx, out_acc + ridx);
  }
}

size_t render_fwd_smem_bytes(int W) {
  return sizeof(float) * ((size_t)kMmaStageFloats + 2 * kRows * (W + kMmaPad) + kRows * kPeLd
                          + W + kMaxDirPe + kRows + kRows * 3);
}

}  // namespace supnerf

// Plain C entry, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises or allocates.
extern "C" int supnerf_render_fwd(const float* xyz, const float* vd, const float* z,
                                  const float* zs, const float* zt,
                                  const supnerf::DecoderWeights* w, int B, int R, int S,
                                  int W, int n_shape, int n_tex, int l_xyz, int l_dir,
                                  int white_bkgd, int z_per_ray, const float* hit,
                                  float* out_rgb, float* out_depth, float* out_acc,
                                  void* stream) {
  using namespace supnerf;
  const Dims d{B, R, S, W, n_shape, n_tex, l_xyz, l_dir};
  const size_t smem = render_fwd_smem_bytes(W);
  cudaError_t err = cudaFuncSetAttribute(
      render_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  render_fwd_kernel<<<dim3(R, B), kThreads, smem, (cudaStream_t)stream>>>(
      xyz, vd, z, zs, zt, *w, d, white_bkgd, z_per_ray, hit, out_rgb, out_depth, out_acc);
  return (int)cudaGetLastError();
}

// The bfloat16 mode's entry: supnerf_render_fwd's arguments, the pack's
// bfloat16 weight tiles (ops/render.py bf16_tile_pack) after the weights,
// and pe_mode (PeMode; any other value, or W outside {64, 128, 256}, is
// refused).
template <int W>
static int launch_render_fwd_bf16(const float* xyz, const float* vd, const float* z,
                                  const float* zs, const float* zt,
                                  const supnerf::DecoderWeights* w, const void* tiles,
                                  const supnerf::Dims& d, int white_bkgd, int z_per_ray,
                                  const float* hit, int pe_mode, float* out_rgb,
                                  float* out_depth, float* out_acc, cudaStream_t stream) {
  using namespace supnerf;
  const int n_pairs = (d.B * d.R + 1) / 2;
  if (n_pairs == 0) return 0;
  const size_t smem = ring_smem_bytes<W, kFwdSlots>(tile_count(W, d.n_shape, d.n_tex, false))
                      + 2 * sizeof(float) * fwd_ray_words<W>();
  cudaError_t err = cudaFuncSetAttribute(render_fwd_bf16_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  render_fwd_bf16_kernel<W><<<n_pairs < sms ? n_pairs : sms, kPairThreads, smem, stream>>>(
      xyz, vd, z, zs, zt, *w, static_cast<const unsigned char*>(tiles), d, white_bkgd,
      z_per_ray, hit, pe_mode, out_rgb, out_depth, out_acc);
  return (int)cudaGetLastError();
}

extern "C" int supnerf_render_fwd_bf16(const float* xyz, const float* vd, const float* z,
                                       const float* zs, const float* zt,
                                       const supnerf::DecoderWeights* w, const void* tiles,
                                       int B, int R, int S, int W, int n_shape, int n_tex,
                                       int l_xyz, int l_dir, int white_bkgd, int z_per_ray,
                                       const float* hit, int pe_mode, float* out_rgb,
                                       float* out_depth, float* out_acc, void* stream) {
  using namespace supnerf;
  if (pe_mode < kPeDoubling || pe_mode > kPeTrain) return (int)cudaErrorInvalidValue;
  const Dims d{B, R, S, W, n_shape, n_tex, l_xyz, l_dir};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 64:
      return launch_render_fwd_bf16<64>(xyz, vd, z, zs, zt, w, tiles, d, white_bkgd, z_per_ray,
                                        hit, pe_mode, out_rgb, out_depth, out_acc, st);
    case 128:
      return launch_render_fwd_bf16<128>(xyz, vd, z, zs, zt, w, tiles, d, white_bkgd, z_per_ray,
                                         hit, pe_mode, out_rgb, out_depth, out_acc, st);
    case 256:
      return launch_render_fwd_bf16<256>(xyz, vd, z, zs, zt, w, tiles, d, white_bkgd, z_per_ray,
                                         hit, pe_mode, out_rgb, out_depth, out_acc, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
