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
// The bfloat16 mode (render_fwd_bf16_kernel, the same body with kBf16): the
// Pallas kernel at dtype=bfloat16 (render_common.cuh's note): every dense
// layer on dense_mma_bf16, one bfloat16 mma.sync per product where 3xTF32
// takes three, at twice TF32's rate, so the same work's bound is about a
// sixth of the float32 mode's (989 against 495 / 3 TFLOP/s); the encodings
// by the doubling recurrence and rounded, the per-ray direction term
// rounded, the heads on rounded operands; compositing stays float32.
// pe_mode (render_common.cuh PeMode): kPeExact, the exact encodings and an
// unrounded direction term (A11a, field_composite_pallas(pe_in_kernel=
// True)); kPeTrain, the exact encodings and the direction term rounded
// (A5, the training forward of field_composite_train_pallas on per-object
// latents: _make_render_train_core's encode).
#include "render_common.cuh"

namespace supnerf {

template <bool kBf16>
static __device__ __forceinline__ void render_fwd_body(
    const float* __restrict__ xyz, const float* __restrict__ vd, const float* __restrict__ z,
    const float* __restrict__ zs, const float* __restrict__ zt, const DecoderWeights& w,
    const Dims& d, int white_bkgd, int z_per_ray, const float* __restrict__ hit, int pe_mode,
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

  if constexpr (kBf16) {
    encode_points_bf16<kPeLd>(xyz + ray_idx * S * 3, S, d.l_xyz, pe_mode != kPeDoubling, pe);
    direction_term_bf16(vd + ray_idx * 3, d.l_dir, pe_mode, w, W, dpe, hdir);  // syncs
  } else {
    encode_points<kPeLd>(xyz + ray_idx * S * 3, S, d.l_xyz, pe);
    direction_term(vd + ray_idx * 3, d.l_dir, w, W, dpe, hdir);  // syncs
  }

  dense_layer<kBf16, true>(pe, kPeLd, pe_width(d.l_xyz), w.w_xyz, W, w.b_xyz, buf_a, Ws, true,
                           nullptr, stage);
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int j = 0; j < d.n_shape; ++j) {
    add_row_vector(cur, Ws, W, zs + ((size_t)obj * d.n_shape + j) * W);
    dense_layer<kBf16, true>(cur, Ws, W, w.w_sh + (size_t)j * W * W, W, w.b_sh + j * W, nxt, Ws,
                             true, nullptr, stage);
    float* t = cur; cur = nxt; nxt = t;
  }
  dense_layer<kBf16>(cur, Ws, W, w.w_es, W, w.b_es, nxt, Ws, false, nullptr, stage);
  { float* t = cur; cur = nxt; nxt = t; }
  head<kBf16>(cur, Ws, W, w.w_sg, 1, w.b_sg, sig);
  dense_layer<kBf16, true>(cur, Ws, W, w.w_vd_a, W, hdir, nxt, Ws, true, nullptr, stage);
  { float* t = cur; cur = nxt; nxt = t; }
  for (int j = 0; j < d.n_tex; ++j) {
    add_row_vector(cur, Ws, W, zt + ((size_t)obj * d.n_tex + j) * W);
    dense_layer<kBf16, true>(cur, Ws, W, w.w_tx + (size_t)j * W * W, W, w.b_tx + j * W, nxt, Ws,
                             true, nullptr, stage);
    float* t = cur; cur = nxt; nxt = t;
  }
  dense_layer<kBf16, true>(cur, Ws, W, w.w_r1, W2, w.b_r1, nxt, Ws, true, nullptr, stage);
  head<kBf16>(nxt, Ws, W2, w.w_r2, 3, w.b_r2, rgb);

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
  render_fwd_body<false>(xyz, vd, z, zs, zt, w, d, white_bkgd, z_per_ray, hit, kPeDoubling,
                         out_rgb, out_depth, out_acc);
}

__global__ void __launch_bounds__(kThreads, 1)
render_fwd_bf16_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                       const float* __restrict__ z, const float* __restrict__ zs,
                       const float* __restrict__ zt, DecoderWeights w, Dims d,
                       int white_bkgd, int z_per_ray, const float* __restrict__ hit,
                       int pe_mode, float* __restrict__ out_rgb,
                       float* __restrict__ out_depth, float* __restrict__ out_acc) {
  render_fwd_body<true>(xyz, vd, z, zs, zt, w, d, white_bkgd, z_per_ray, hit, pe_mode, out_rgb,
                        out_depth, out_acc);
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

// The bfloat16 mode's entry: supnerf_render_fwd's arguments and pe_mode
// (PeMode; any other value is refused).
extern "C" int supnerf_render_fwd_bf16(const float* xyz, const float* vd, const float* z,
                                       const float* zs, const float* zt,
                                       const supnerf::DecoderWeights* w, int B, int R, int S,
                                       int W, int n_shape, int n_tex, int l_xyz, int l_dir,
                                       int white_bkgd, int z_per_ray, const float* hit,
                                       int pe_mode, float* out_rgb, float* out_depth,
                                       float* out_acc, void* stream) {
  using namespace supnerf;
  if (pe_mode < kPeDoubling || pe_mode > kPeTrain) return (int)cudaErrorInvalidValue;
  const Dims d{B, R, S, W, n_shape, n_tex, l_xyz, l_dir};
  const size_t smem = render_fwd_smem_bytes(W);
  cudaError_t err = cudaFuncSetAttribute(
      render_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  render_fwd_bf16_kernel<<<dim3(R, B), kThreads, smem, (cudaStream_t)stream>>>(
      xyz, vd, z, zs, zt, *w, d, white_bkgd, z_per_ray, hit, pe_mode, out_rgb, out_depth,
      out_acc);
  return (int)cudaGetLastError();
}
