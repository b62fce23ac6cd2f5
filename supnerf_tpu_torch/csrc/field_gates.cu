// The per-point field's kernels K5, K6 and K7 with their ReLU gates written
// out, for chip_smoke.py's check that K6 and K7 differentiate at the gates
// K5 took (ops/field.py: the wrappers' `gates`, gate_buffer's layout).
//
// Each kernel is the one of field_fwd.cu, field_bwd.cu or
// field_train_bwd.cu, the same body (render_common.cuh:field_forward,
// field_backward) built with kGates: K5 keeps its ReLU masks too, and each
// writes its masks into gates (store_gates), n_shape + n_tex + 3 slots of
// W/32 words a point. They sit in a module of their own so that the
// kernels of those files, and the noinline layer functions each module
// compiles for its own callers, are built as they would be without this
// check.
#include "render_common.cuh"

namespace supnerf {

__global__ void __launch_bounds__(kThreads, 1)
field_fwd_gates_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                       const float* __restrict__ zs, const float* __restrict__ zt,
                       const __grid_constant__ DecoderWeights w, const __grid_constant__ Dims d,
                       float* __restrict__ out_sigma, float* __restrict__ out_rgb,
                       uint32_t* __restrict__ gates) {
  const int blk = blockIdx.x, obj = blockIdx.y;
  const int W = d.W, M = d.R;                         // d.R: points per object
  const size_t p0 = (size_t)obj * M + (size_t)blk * kRows;
  const int n = min(kRows, M - blk * kRows);          // this block's real rows
  extern __shared__ float smem[];
  field_forward<true>(xyz + p0 * 3, vd + p0 * 3, n, zs + (size_t)obj * d.n_shape * W,
                      zt + (size_t)obj * d.n_tex * W, w, d, smem, out_sigma + p0,
                      out_rgb + p0 * 3, gates + p0 * field_slots(d) * (W / 32));
}

// K6 (kStash false) and K7 (kStash true) with their gates
template <bool kStash>
__global__ void __launch_bounds__(kThreads, 1)
field_bwd_gates_kernel(const float* __restrict__ xyz, const float* __restrict__ vd,
                       const float* __restrict__ zs, const float* __restrict__ zt,
                       const __grid_constant__ DecoderWeights w, const __grid_constant__ Dims d,
                       const float* __restrict__ g_sigma, const float* __restrict__ g_rgb,
                       StashLayout st, float* __restrict__ dxyz, float* __restrict__ dvd,
                       float* __restrict__ dzs_part, float* __restrict__ dzt_part,
                       uint32_t* __restrict__ gates) {
  const int blk = blockIdx.x, obj = blockIdx.y, nblk = gridDim.x;
  const int W = d.W, M = d.R;                         // d.R: points per object
  const size_t p0 = (size_t)obj * M + (size_t)blk * kRows;
  const int n = min(kRows, M - blk * kRows);          // this block's real rows
  const size_t part = (size_t)obj * nblk + blk;       // this block's partial-sum row
  extern __shared__ float smem[];
  field_backward<kStash, true>(xyz + p0 * 3, vd + p0 * 3, n, zs + (size_t)obj * d.n_shape * W,
                               zt + (size_t)obj * d.n_tex * W, w, d, g_sigma + p0,
                               g_rgb + p0 * 3, smem, dxyz + p0 * 3, dvd + p0 * 3,
                               dzs_part + part * d.n_shape * W, dzt_part + part * d.n_tex * W,
                               st, kStash ? st.pt + p0 * st.ld_pt : nullptr,
                               gates + p0 * field_slots(d) * (W / 32));
}

}  // namespace supnerf

// Plain C entries, bound with ctypes: supnerf_field_fwd's,
// supnerf_field_bwd's and supnerf_field_train_bwd's arguments, then gates
// ((B, M, n_shape + n_tex + 3, W/32) words). Each launches on `stream` and
// returns cudaGetLastError() (0 on success); never synchronises or
// allocates.
extern "C" int supnerf_field_fwd_gates(const float* xyz, const float* vd, const float* zs,
                                       const float* zt, const supnerf::DecoderWeights* w,
                                       int B, int M, int W, int n_shape, int n_tex, int l_xyz,
                                       int l_dir, float* out_sigma, float* out_rgb,
                                       uint32_t* gates, void* stream) {
  using namespace supnerf;
  const Dims d{B, M, kRows, W, n_shape, n_tex, l_xyz, l_dir};
  const size_t smem = field_forward_smem_bytes(W, n_shape, n_tex, true);
  cudaError_t err = cudaFuncSetAttribute(
      field_fwd_gates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  field_fwd_gates_kernel<<<dim3((M + kRows - 1) / kRows, B), kThreads, smem,
                           (cudaStream_t)stream>>>(xyz, vd, zs, zt, *w, d, out_sigma, out_rgb,
                                                   gates);
  return (int)cudaGetLastError();
}

template <bool kStash>
static int launch_bwd_gates(const float* xyz, const float* vd, const float* zs, const float* zt,
                            const supnerf::DecoderWeights* w, int B, int M, int W, int n_shape,
                            int n_tex, int l_xyz, int l_dir, const float* g_sigma,
                            const float* g_rgb, const supnerf::StashLayout& st, float* dxyz,
                            float* dvd, float* dzs_part, float* dzt_part, uint32_t* gates,
                            void* stream) {
  using namespace supnerf;
  const Dims d{B, M, kRows, W, n_shape, n_tex, l_xyz, l_dir};
  const size_t smem = field_backward_smem_bytes(W, n_shape, n_tex);
  cudaError_t err = cudaFuncSetAttribute(
      field_bwd_gates_kernel<kStash>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  field_bwd_gates_kernel<kStash><<<dim3((M + kRows - 1) / kRows, B), kThreads, smem,
                                   (cudaStream_t)stream>>>(
      xyz, vd, zs, zt, *w, d, g_sigma, g_rgb, st, dxyz, dvd, dzs_part, dzt_part, gates);
  return (int)cudaGetLastError();
}

extern "C" int supnerf_field_bwd_gates(const float* xyz, const float* vd, const float* zs,
                                       const float* zt, const supnerf::DecoderWeights* w,
                                       int B, int M, int W, int n_shape, int n_tex, int l_xyz,
                                       int l_dir, const float* g_sigma, const float* g_rgb,
                                       float* dxyz, float* dvd, float* dzs_part,
                                       float* dzt_part, uint32_t* gates, void* stream) {
  return launch_bwd_gates<false>(xyz, vd, zs, zt, w, B, M, W, n_shape, n_tex, l_xyz, l_dir,
                                 g_sigma, g_rgb, supnerf::StashLayout{}, dxyz, dvd, dzs_part,
                                 dzt_part, gates, stream);
}

extern "C" int supnerf_field_train_bwd_gates(const float* xyz, const float* vd, const float* zs,
                                             const float* zt, const supnerf::DecoderWeights* w,
                                             int B, int M, int W, int n_shape, int n_tex,
                                             int l_xyz, int l_dir, const float* g_sigma,
                                             const float* g_rgb,
                                             const supnerf::StashLayout* stash, float* dxyz,
                                             float* dvd, float* dzs_part, float* dzt_part,
                                             uint32_t* gates, void* stream) {
  return launch_bwd_gates<true>(xyz, vd, zs, zt, w, B, M, W, n_shape, n_tex, l_xyz, l_dir,
                                g_sigma, g_rgb, *stash, dxyz, dvd, dzs_part, dzt_part, gates,
                                stream);
}
