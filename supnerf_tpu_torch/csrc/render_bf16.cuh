// Shared device code of the bfloat16 builds of K1 and K2 (render_fwd.cu
// render_fwd_bf16_kernel, render_bwd.cu render_bwd_bf16_kernel): the
// Pallas kernels at dtype=bfloat16 (render_common.cuh's note on the mode)
// on Hopper's warpgroup MMA.
//
// What bounds them on the H100: the tensor cores' bfloat16 rate (989
// TFLOP/s: 0.89 MFLOP a point forward, 1.8 with K2's transposed chain)
// and, once the operands are bfloat16, the weight stream: every block
// streams the whole decoder (0.88 MB of bfloat16 tiles forward, 1.8 MB for
// K2) from L2, so the rows that share one pass over the weights set the L2
// traffic. The old builds streamed float32 weights per ray and built every
// bfloat16 fragment from float32 shared memory, 18-24x their bound. The
// design:
// - The weights arrive packed once (ops/render.py bf16_tile_pack, at
//   pack time, not per launch): each layer's matrix in real bfloat16, cut
//   into tiles of 64 K rows and up to 128 output columns (16 KB), each in
//   the canonical 128-byte swizzle that a wgmma shared-memory descriptor
//   reads, the forward layers in kernel order, then the transposed
//   chain's (K2). One cp.async.bulk moves a tile into a ring slot,
//   completing on an mbarrier; no tensor map.
// - Two rays a block, one weight stream: two warpgroups, each owning one
//   ray's 64 samples (kRows, wgmma's M), read every tile of the ring, so
//   every weight byte enters the SM once for two rays. No producer warp:
//   the last of the 8 warps to release a slot (a shared counter) refills
//   it with the tile a ring further on, and the sequence runs on across
//   the block's ray pairs (a persistent grid, one block an SM), so the
//   next pair's first tiles arrive during this pair's compositing.
// - wgmma.m64nNk16 with A from registers: a layer's float32 sums, after
//   its epilogue (bias, ReLU, the next layer's latent added in float32,
//   rounded to bfloat16), are the next layer's A fragments (the
//   accumulator and A layouts share their lane ownership, as the P.V step
//   of FlashAttention-3); they wait in shared memory, each thread's own
//   16 bytes a k-step, and a layer loads one K-tile's 16 registers.
// - The sums are float32 per K-tile: each tile's 64 products are summed
//   on the tensor cores from zero, 32 columns at a time, and added into
//   the layer's sums in registers (ring_layer says why; with A and the
//   sums both in registers across K, or with wider pieces, W 256 spills).
//   2 x 128 threads at up to 255 registers: 128 sums, 16 piece and 16
//   fragment registers.
// - The heads reduce from registers with shuffles over the 4 lanes of a
//   row; K2's ReLU gates stay bits in shared memory, each thread's own,
//   and its column sums reduce from registers.
// What is left between them and the bound: each piece waits for its sums
// (the other warpgroup fills the tensor cores meanwhile), the compositing,
// the encodings and the direction terms run on the CUDA cores with the
// tensor cores idle (one thread a ray composites), and one pass over the
// weights feeds 128 rows (a cluster of 2 with multicast would halve the
// stream). The bfloat16 builds of K3, K5, K6 and K7 still run
// dense_mma_bf16_t (render_common.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "render_common.cuh"

namespace supnerf {

constexpr int kPairThreads = 256;     // two consumer warpgroups, one ray each
constexpr int kTileK = 64;            // K rows of a weight tile: 128 bytes of bfloat16
constexpr int kTileRowBytes = 128;
constexpr int kTileRows = 128;        // rows of a weight tile at most: 16 KB, a ring slot
constexpr int kPieceCols = 32;        // columns of a wgmma piece: its 16 sums a thread

constexpr int kWarpsPerPair = kPairThreads / 32;

// ---- PTX wrappers: mbarriers, bulk copies, warpgroup MMA ------------------

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// wait until the phase of the barrier at `bar` with this parity has
// completed; a wait that outlasts any tile's copy by far (2^24 polls)
// traps, so a broken ring fails its launch instead of hanging the card
static __device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// `bytes` (a multiple of 16) from global src to shared dst (both 16-byte
// aligned), completing on the barrier at `bar`, whose one arrival this is
static __device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                                 uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

static __device__ __forceinline__ uint32_t atom_add_shared(uint32_t addr, uint32_t v) {
  uint32_t old;
  asm volatile("atom.shared.add.u32 %0, [%1], %2;\n" : "=r"(old) : "r"(addr), "r"(v) : "memory");
  return old;
}

// barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads)
static __device__ __forceinline__ void wg_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

static __device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The shared-memory descriptor of a weight tile (up to 128 rows of 128
// bytes, K-major, the 128-byte swizzle: 16-byte chunk c of row n at chunk
// c ^ (n % 8); the slot 1024-byte aligned): start address, leading offset
// 16 bytes (unused by this layout), 1024 bytes between 8-row groups,
// layout 1 (128B). A k-step of 16 advances the start by 32 bytes (+2), 32
// rows by 4096 (+256).
static __device__ __forceinline__ uint64_t tile_desc(uint32_t slot) {
  return (uint64_t)((slot & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 32, float32; this thread's 16) (+)= a (64 x 16, bfloat16, this
// thread's fragment registers) * B (16 x 32, the 32 tile rows at desc);
// scale_d 0 starts the sum. Fragments (PTX ISA, wgmma .m64nNk16): warp w
// of the warpgroup holds rows 16 w + gid and 16 w + gid + 8 (gid = lane /
// 4, tig = lane % 4); a[0] row gid, k 2 tig + {0, 1}; a[1] row gid + 8;
// a[2] and a[3] the same rows at k + 8; d[4 j + e] row gid (e < 2) or gid
// + 8, column 8 j + 2 tig + (e & 1). After wgmma_wait_all, fence_piece
// keeps the compiler from moving reads of d above the wait.
static __device__ __forceinline__ void wgmma_m64n32k16(float* d, const uint32_t* a, uint64_t desc,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

static __device__ __forceinline__ void fence_piece(float* d) {
#pragma unroll
  for (int i = 0; i < kPieceCols / 2; ++i) asm volatile("" : "+f"(d[i]) : : "memory");
}

// ---- the thread's rows and columns ----------------------------------------

struct Frag {
  int wt;        // thread in its warpgroup
  int warp;      // warp in its warpgroup: rows 16 warp ..
  int tig;
  int r0, r1;    // the thread's two rows
};

static __device__ __forceinline__ Frag frag_of_thread() {
  Frag f;
  f.wt = threadIdx.x & 127;
  f.warp = f.wt >> 5;
  const int lane = threadIdx.x & 31;
  f.tig = lane & 3;
  f.r0 = 16 * f.warp + (lane >> 2);
  f.r1 = f.r0 + 8;
  return f;
}

// ---- the weight ring ------------------------------------------------------

// Tiles of a layer whose product has `rows` output columns (the rows of
// its K-major B): per 64-row K-tile, ceil(rows / 128) tiles of up to 128
// rows (16 KB, a slot).
static __device__ __host__ __forceinline__ int row_blocks(int rows) {
  return (rows + kTileRows - 1) / kTileRows;
}

// The tiles a ray pair consumes, in order, and their byte offsets in the
// pack (ops/render.py bf16_tile_pack), each layer's by K-tile, then by
// block of 128 rows: forward, encoding_xyz (K 63 -> one K-tile, W rows),
// each shape block, encoding_shape, the viewdir layer's trunk rows, each
// texture block (K W: W / 64 K-tiles of W rows), rgb.0 (W / 2 rows); then
// K2's transposed chain: rgb.0^T (K W / 2, W rows), the texture blocks^T
// from the last, the viewdir layer's direction rows^T (dir_n rows: the
// direction encoding's width padded to 32 or 64), its trunk rows^T,
// encoding_shape^T, the shape blocks^T from the last, encoding_xyz^T (64
// rows). Writes n + 1 offsets; returns n.
static __device__ int tile_sequence(const Dims& d, int dir_n, bool transposed, uint32_t* off) {
  const int kt = d.W / kTileK, kt_half = (d.W / 2 + kTileK - 1) / kTileK;
  int n = 0;
  uint32_t at = 0;
  auto add = [&](int k_tiles, int rows) {
    const int blocks = k_tiles * row_blocks(rows), tile_rows = rows < kTileRows ? rows : kTileRows;
    for (int i = 0; i < blocks; ++i) {
      off[n++] = at;
      at += tile_rows * kTileRowBytes;
    }
  };
  add(1, d.W);
  add(kt * (d.n_shape + 2 + d.n_tex), d.W);
  add(kt, d.W / 2);
  if (transposed) {
    add(kt_half, d.W);
    add(kt * d.n_tex, d.W);
    add(kt, dir_n);
    add(kt * (2 + d.n_shape), d.W);
    add(kt, 64);
  }
  off[n] = at;
  return n;
}

// The number of tiles tile_sequence lists.
static __device__ __host__ __forceinline__ int tile_count(int W, int n_shape, int n_tex,
                                                          bool transposed) {
  const int kt = W / kTileK, kt_half = (W / 2 + kTileK - 1) / kTileK;
  const int fwd = row_blocks(W) * (1 + kt * (n_shape + 2 + n_tex)) + kt * row_blocks(W / 2);
  return transposed ? fwd + row_blocks(W) * (kt_half + kt * (n_tex + 2 + n_shape)) + 2 * kt
                    : fwd;
}

// What a refill reads, in shared memory after the ring's barriers: the
// pack's tiles, the tiles a pair takes and the block takes, and the
// tiles' offsets (tile_sequence's, n_seq + 1 of them).
struct RingInfo {
  const unsigned char* src;
  int n_seq, total;
  uint32_t off[1];
};

// The ring of weight tiles: kSlots slots of W's tile size from `slots` (a
// 1024-byte aligned shared address), then a full barrier (8 bytes) and a
// release counter (4 bytes) per slot, then its RingInfo.
template <int W, int kSlots>
struct TileRing {
  static constexpr int kSlotBytes = (W < kTileRows ? W : kTileRows) * kTileRowBytes;
  uint32_t slots;
  const RingInfo* info;

  __device__ uint32_t slot(int t) const { return slots + (t % kSlots) * kSlotBytes; }
  __device__ uint32_t full(int t) const { return slots + kSlots * kSlotBytes + (t % kSlots) * 8; }
  __device__ uint32_t released(int t) const {
    return slots + kSlots * (kSlotBytes + 8) + (t % kSlots) * 4;
  }
  __device__ void issue(int t) const {
    const int q = t % info->n_seq;
    bulk_load(slot(t), info->src + info->off[q], info->off[q + 1] - info->off[q], full(t));
  }
  __device__ void wait(int t) const { mbar_wait(full(t), (t / kSlots) & 1); }
  // a warp is done with tile t (its wgmma reads of it have completed):
  // the last of the block's warps refills the slot with tile t + kSlots
  __device__ void release(int t) const {
    if ((threadIdx.x & 31) == 0) {
      const uint32_t before = atom_add_shared(released(t), 1u);
      if (before % kWarpsPerPair == kWarpsPerPair - 1 && t + kSlots < info->total)
        issue(t + kSlots);
    }
    __syncwarp();
  }
};

// A warpgroup's A fragments live in shared memory between layers, each
// thread's own 16 bytes a k-step (k-step k at abuf[(k * 128 + thread) *
// 4]), so that a layer holds one K-tile's 16 registers beside its sums.
static __device__ __forceinline__ uint4* frag_slot(uint32_t* abuf, int k, const Frag& f) {
  return reinterpret_cast<uint4*>(abuf) + k * 128 + f.wt;
}

// acc's columns col .. col + 31 (this thread's 16 values) += the piece's
// sums, or = them for the layer's first K-tile.
static __device__ __forceinline__ void add_piece(float* acc, int col, float* part, bool first) {
  fence_piece(part);
#pragma unroll
  for (int e = 0; e < kPieceCols / 2; ++e)
    acc[col / 2 + e] = first ? part[e] : acc[col / 2 + e] + part[e];
}

// acc (64 x N, float32) = A (64 x 16 KS, the warpgroup's fragments in
// abuf) @ the next tiles of the ring, each 64-row K-tile's in blocks of up
// to 128 output columns. Each K-tile's 64 products of an output are summed
// on the tensor cores from zero, a piece of kPieceCols columns at a time
// (wgmma.m64nNk16, four k-steps), and added into acc with float32 adds.
// The tensor core truncates the sums it accumulates onto; summed across
// the whole K in the accumulators, the layers' outputs drift toward zero
// by units of their last place, which a ray's densities carry into K2's z
// cotangent, a sum over the object's rays (the card, the first build of
// this design: dz 0.13 of its distance from float32 in root mean square,
// past chip_smoke's BF16_CLOSER bound of 0.1; 0.092 with a float32 add
// every K-tile, as here; 0.065 with one every k-step, as the old build,
// whose pieces ran K1 15 % slower in a build that spilled either way). A
// piece's sums are added as soon as it completes (a second piece in
// flight ran K1 5 % faster and spilled K2's registers); the other
// warpgroup keeps the tensor cores busy meanwhile.
template <int N, int KS, class Ring>
static __device__ __forceinline__ void ring_layer(float* acc, uint32_t* abuf, const Frag& f,
                                                  const Ring& ring, int& it) {
  static_assert(KS % 4 == 0 && N % kPieceCols == 0, "a layer takes whole K-tiles and pieces");
  constexpr int RB = N < kTileRows ? N : kTileRows;      // output columns of a tile
  float part[kPieceCols / 2];
#pragma unroll
  for (int kt = 0; kt < KS / 4; ++kt) {
    uint32_t a[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint4 v = *frag_slot(abuf, 4 * kt + s, f);
      a[s][0] = v.x;
      a[s][1] = v.y;
      a[s][2] = v.z;
      a[s][3] = v.w;
    }
#pragma unroll
    for (int nb = 0; nb < N / RB; ++nb) {
      ring.wait(it + nb);
      const uint64_t desc = tile_desc(ring.slot(it + nb));
#pragma unroll
      for (int q = 0; q < RB / kPieceCols; ++q) {
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_m64n32k16(part, a[ks], desc + ((q * kPieceCols * kTileRowBytes) >> 4) + 2 * ks,
                          ks);
        wgmma_commit();
        wgmma_wait_all();
        add_piece(acc, nb * RB + q * kPieceCols, part, kt == 0);
      }
      ring.release(it + nb);
    }
    it += N / RB;
  }
}

// ---- epilogues -------------------------------------------------------------

// The A fragments (KS k-steps) of a layer whose input is v, this thread's
// values in the accumulator layout of N columns, each rounded to nearest
// even, into abuf (the C and A fragments of mma.m16n8k16 share their
// lanes: n-tiles 2 k and 2 k + 1 are k-step k); k-steps past N are zero.
template <int N, int KS>
static __device__ __forceinline__ void to_frags(const float* v, const Frag& f, uint32_t* abuf) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
    *frag_slot(abuf, k, f) = make_uint4(bf16_pair(v[8 * k], v[8 * k + 1]),
                                        bf16_pair(v[8 * k + 2], v[8 * k + 3]),
                                        bf16_pair(v[8 * k + 4], v[8 * k + 5]),
                                        bf16_pair(v[8 * k + 6], v[8 * k + 7]));
#pragma unroll
  for (int k = N / 16; k < KS; ++k) *frag_slot(abuf, k, f) = make_uint4(0u, 0u, 0u, 0u);
}

// The mask words of an N-column layer a thread keeps: bit 4 j + e of its
// values, 32 a word.
template <int N>
__host__ __device__ constexpr int mask_words() { return N >= 64 ? N / 64 : 1; }

// acc = relu(acc + bias (+ bias2)) per column; kStash (K2's recompute):
// rounded to bfloat16, its signs into mask (this thread's words, stride
// 128); then + lat (the next layer's latent, float32) where given.
template <int N, bool kStash>
static __device__ __forceinline__ void relu_epilogue(float* acc, const Frag& f, const float* bias,
                                                     const float* bias2, const float* lat,
                                                     uint32_t* mask) {
  uint32_t bits[mask_words<N>()] = {};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * f.tig;
    float b0 = bias[c], b1 = bias[c + 1];
    const float l0 = lat != nullptr ? lat[c] : 0.f, l1 = lat != nullptr ? lat[c + 1] : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = acc[4 * j + e] + ((e & 1) ? b1 : b0);
      if (bias2 != nullptr) v += bias2[c + (e & 1)];
      v = fmaxf(v, 0.f);
      if (kStash) {
        v = bf16_round(v);
        if (v > 0.f) bits[(4 * j + e) >> 5] |= 1u << ((4 * j + e) & 31);
      }
      acc[4 * j + e] = v + ((e & 1) ? l1 : l0);
    }
  }
  if (kStash) {
#pragma unroll
    for (int q = 0; q < mask_words<N>(); ++q) mask[q * 128 + f.wt] = bits[q];
  }
}

// acc = mask ? acc : 0 (this thread's words of a layer's ReLU gates)
template <int N>
static __device__ __forceinline__ void apply_gates(float* acc, const Frag& f,
                                                   const uint32_t* mask) {
#pragma unroll
  for (int q = 0; q < mask_words<N>(); ++q) {
    const uint32_t bits = mask[q * 128 + f.wt];
#pragma unroll
    for (int i = 0; i < 32 && 32 * q + i < N / 2; ++i)
      if (!((bits >> i) & 1u)) acc[32 * q + i] = 0.f;
  }
}

// Per row, the dot product of this thread's values v (N columns) with
// column `col` of M (N x ncols, row-major), summed over the 4 lanes of the
// row: (row r0, row r1).
template <int N>
static __device__ __forceinline__ float2 row_dot(const float* v, const Frag& f,
                                                 const float* __restrict__ M, int ncols,
                                                 int col) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * f.tig;
    const float m0 = __ldg(M + c * ncols + col), m1 = __ldg(M + (c + 1) * ncols + col);
    s0 = fmaf(v[4 * j + 1], m1, fmaf(v[4 * j], m0, s0));
    s1 = fmaf(v[4 * j + 3], m1, fmaf(v[4 * j + 2], m0, s1));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  return make_float2(s0, s1);
}

// The encodings of one ray's S samples (rows >= S and columns past the
// encoding zero; kPeStride floats a row) and of its direction, by the
// warpgroup g; ends with its barrier.
static __device__ void encode_ray_bf16(const float* xyz, const float* vd, int S, int l_xyz,
                                       int l_dir, bool exact, const Frag& f, int g, float* pe,
                                       float* dpe) {
  const int d_xyz = pe_width(l_xyz);
  if (f.wt < kRows) {
    float* row = pe + f.wt * kPeStride;
    int k0 = 0;
    if (f.wt < S) {
      const float x[3] = {xyz[3 * f.wt], xyz[3 * f.wt + 1], xyz[3 * f.wt + 2]};
      encode_one_bf16(x, l_xyz, exact, row);
      k0 = d_xyz;
    }
    for (int k = k0; k < kPeStride; ++k) row[k] = 0.f;
  } else if (f.wt == kRows) {
    const float x[3] = {vd[0], vd[1], vd[2]};
    encode_one_bf16(x, l_dir, exact, dpe);
  }
  wg_sync(g);
}

// The viewdir layer's per-ray direction term dpe @ Wvd_b (exact products,
// float32 sums), rounded to bfloat16 unless `unrounded` (A11a), without
// b_vd (the epilogue adds it after); W columns into hdir.
static __device__ void direction_term_wg(const float* dpe, int d_dir, const float* w_vd_b,
                                         int W, bool unrounded, const Frag& f, float* hdir) {
  for (int n = f.wt; n < W; n += 128) {
    float s = 0.f;
    for (int k = 0; k < d_dir; ++k) s = fmaf(dpe[k], __ldg(w_vd_b + k * W + n), s);
    hdir[n] = unrounded ? s : bf16_round(s);
  }
}

// The A fragments of the first layer, the point encodings (64 wide,
// bfloat16-exact) from shared memory, into abuf.
static __device__ __forceinline__ void encoding_frags(const float* pe, const Frag& f,
                                                      uint32_t* abuf) {
#pragma unroll
  for (int ks = 0; ks < kTileK / 16; ++ks) {
    const float* p0 = pe + f.r0 * kPeStride + 16 * ks + 2 * f.tig;
    const float* p1 = pe + f.r1 * kPeStride + 16 * ks + 2 * f.tig;
    *frag_slot(abuf, ks, f) = make_uint4(bf16_pair(p0[0], p0[1]), bf16_pair(p1[0], p1[1]),
                                         bf16_pair(p0[8], p0[9]), bf16_pair(p1[8], p1[9]));
  }
}

// Bytes of shared memory ring_setup takes (the ring's alignment included).
template <int W, int kSlots>
static inline size_t ring_smem_bytes(int n_seq) {
  return 1024 + kSlots * (TileRing<W, kSlots>::kSlotBytes + 12) + 8 + sizeof(RingInfo)
         + (size_t)n_seq * 4 + 16;
}

// Pair p (rays 2 p and 2 p + 1 of the B x R) has work: a ray of it hits.
static __device__ __forceinline__ bool pair_active(const float* hit, int p, int n_rays) {
  return hit == nullptr || hit[2 * p] != 0.f || (2 * p + 1 < n_rays && hit[2 * p + 1] != 0.f);
}

// The active pairs of this block (blockIdx.x, then every gridDim.x-th).
static __device__ int block_active_pairs(const float* hit, int n_rays) {
  int n = 0;
  for (int p = blockIdx.x; p < (n_rays + 1) / 2; p += gridDim.x) n += pair_active(hit, p, n_rays);
  return n;
}

// Shared memory a block starts with: the ring (1024-byte aligned), its
// barriers and counters, its RingInfo. Returns the ring; `rest` is where
// the kernel's own buffers start (16-byte aligned). Thread 0 initialises
// the barriers and the offsets and issues the first tiles.
template <int W, int kSlots>
static __device__ TileRing<W, kSlots> ring_setup(unsigned char* smem, const Dims& d, int dir_n,
                                                 bool transposed, const unsigned char* tiles,
                                                 int n_active_pairs, unsigned char** rest) {
  TileRing<W, kSlots> ring;
  const uint32_t base = smem_u32(smem);
  const uint32_t pad = (1024 - (base & 1023)) & 1023;
  ring.slots = base + pad;
  unsigned char* after = smem + pad + kSlots * (TileRing<W, kSlots>::kSlotBytes + 12);
  after += (8 - (smem_u32(after) & 7)) & 7;
  RingInfo* info = reinterpret_cast<RingInfo*>(after);
  ring.info = info;
  const int n_seq = tile_count(d.W, d.n_shape, d.n_tex, transposed);
  if (threadIdx.x == 0) {
    info->src = tiles;
    info->n_seq = n_seq;
    info->total = n_active_pairs * n_seq;
    tile_sequence(d, dir_n, transposed, info->off);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(ring.full(s), 1);
      *reinterpret_cast<uint32_t*>(smem + pad + (ring.released(s) - ring.slots)) = 0u;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 0; t < kSlots && t < info->total; ++t) ring.issue(t);
  unsigned char* end = reinterpret_cast<unsigned char*>(info->off + n_seq + 1);
  *rest = end + ((16 - (smem_u32(end) & 15)) & 15);
  return ring;
}

// The column sums over the S real rows of a warpgroup's values v (N
// columns, the accumulator layout) into out[0 .. n_out) (zeros unless
// live; nothing with out null); part: 4 x N floats of the warpgroup's.
// Starts and ends with the warpgroup's barrier.
template <int N>
static __device__ void column_sums_wg(const float* v, const Frag& f, int g, int S, float* part,
                                      float* out, int n_out, bool live) {
  wg_sync(g);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float s0 = (f.r0 < S ? v[4 * j] : 0.f) + (f.r1 < S ? v[4 * j + 2] : 0.f);
    float s1 = (f.r0 < S ? v[4 * j + 1] : 0.f) + (f.r1 < S ? v[4 * j + 3] : 0.f);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if ((threadIdx.x & 31) < 4) {
      part[f.warp * N + 8 * j + 2 * f.tig] = s0;
      part[f.warp * N + 8 * j + 2 * f.tig + 1] = s1;
    }
  }
  wg_sync(g);
  if (out != nullptr)
    for (int c = f.wt; c < n_out; c += 128)
      out[c] = live ? part[c] + part[N + c] + part[2 * N + c] + part[3 * N + c] : 0.f;
}

}  // namespace supnerf
