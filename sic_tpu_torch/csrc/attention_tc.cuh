// Tensor-core body of the attention forwards, for Hopper (sm_90a): the
// sequence (kernel 1), NHWC window (kernel 2) and (G, s, d) window
// (kernel 6) attention, and the row statistics of the NHWC backward
// (kernel 5's first pass).  Two bodies over one plan: fp32 attention in
// split TF32 (3xTF32, `attend_tf32`) and bf16 attention with f32
// accumulation (`attend_bf16`: the bf16 entries of kernels 1, 2 and 6,
// and of kernel 5's first pass); tiles loaded by
// TMA into a shared-memory ring, online softmax in f32 on the wgmma
// accumulator fragments, the softmax steps and the epilogue shared.
//
// A split-TF32 block holds NWG consumer warpgroups (128 threads each);
// warpgroup w owns query rows [64 w, 64 w + 64) of the block's tile of
// 64 * NWG rows, and all of them share each 64-key tile of k, v (and of
// the bias): no producer warp, thread 0 issues the TMA loads two key tiles
// ahead, block barriers between tiles.  A bf16 block is one warpgroup on
// 64 query rows: a ring of full and empty mbarriers, no block barrier
// after set-up (see `attend_bf16`).
//
// Numbers (split TF32).  Every product is fp32 accuracy from three TF32
// products: each operand x is split as hi = cvt.rna.tf32(x), lo =
// cvt.rna.tf32(x - hi), and a.b is summed as lo.hi + hi.lo + hi.hi, small terms first, into one
// f32 accumulator (the lo.lo term is below f32's rounding).  q is scaled
// before it is split.  A single TF32 pass errs by about 1e3 times plain
// f32 (tests/test_torch_attention_tf32.py pins this on the CPU).  The
// tensor core's f32 accumulation truncates instead of rounding to
// nearest, so a long chain of wgmma into one accumulator drifts: each key
// tile's P v goes to a fresh accumulator (24 wgmma), and the running
// output takes it as O = alpha O + P v with an f32 FMA.  Chaining every
// key tile through the output accumulator instead erred 3-4 times more
// than plain f32 against an f64 reference on an H100 (PERF.md).
//
// The bf16 body (see `attend_bf16`) has no split and stages nothing: one
// k16 wgmma per 16-deep step, q and k K-major and v MN-major as they land,
// P from the logits fragment as it lies; its bf16 rounding of the
// probabilities and of the output is what the JAX package's bf16 mode
// rounds, and O accumulates over the key tiles in the tensor cores.
//
// Operand layouts (split TF32).  tf32 wgmma takes both operands K-major
// (the transpose bits exist only for 16-bit types):
//   * S = (q scale) k^T: K = head dim.  q is the register A operand (its
//     hi and lo fragments stay in registers for the whole block); k rows
//     lie with d contiguous, so the TMA tile is B as it lands, split in
//     place (hi) with lo beside it.
//   * O = P v: K = the key.  P goes to wgmma as the register A operand
//     straight from the logits accumulator.  The accumulator holds, for
//     each 8-key chunk, keys 2t and 2t+1 in a thread whose tf32 A fragment
//     wants logical k = t and t + 4; rather than shuffle P, v's key rows are
//     permuted when v is staged transposed (v^T, keys contiguous) in shared
//     memory: logical k = kk of a chunk holds key 2 kk (kk < 4) or
//     2 (kk - 4) + 1.  The sum over keys is the same set of products.
//
// Memory (split TF32; the bf16 plan is `Plan16`).  128-byte swizzle on
// every operand tile (a head row of 64 floats arrives as two 32-float
// boxes, one per swizzle atom along K); all tiles
// start on 1024-byte boundaries.  Per ring stage: k (16 KB, split in
// place to hi), v (16 KB, raw), and with a bias (kernels 2, 5 and 6) its
// tile (16 KB a warpgroup).  Beside the ring: k lo, v^T hi, v^T lo (48 KB), where the q
// tile lands first and is read into registers.  Rows past the sequence end
// arrive zero-filled from the TMA and their keys are masked to -inf.
//
// Softmax.  A thread holds two query rows of 16 logits each per key tile;
// row max and sum are reduced over the four lanes of a row with shuffles.
// While a row has seen only -inf logits (a shifted window's masked tiles)
// its running max stays -inf and the exponentials are taken against 0,
// never as -inf - -inf.  No atomics; the summation order is fixed, so two
// calls on the same input give the same bits.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mbarrier.cuh"

namespace sic_tc {

using namespace sic_mbar;

constexpr int kHeadDim = 64;
constexpr int kKeyTile = 64;
constexpr int kWgRows = 64;                  // query rows of one warpgroup
constexpr int kBoxRows = 64;                 // rows of one TMA box
constexpr int kAtomFloats = 32;              // 128-byte swizzle row
constexpr int kBoxBytes = kBoxRows * 128;    // (64 rows, 32 floats): 8 KB
constexpr int kTileBytes = 2 * kBoxBytes;    // (64 rows, 64 floats): 16 KB
constexpr int kStages = 2;

// Shared-memory plan of a block with NWG warpgroups (offsets in bytes from
// a 1024-aligned base).
template <int NWG, bool kBias>
struct Plan {
  static constexpr int kRows = NWG * kWgRows;
  static constexpr int kBiasBytes = kBias ? NWG * kTileBytes : 0;
  static constexpr int kStageBytes = 2 * kTileBytes + kBiasBytes;
  static constexpr int kK = 0;                       // within a stage
  static constexpr int kV = kTileBytes;
  static constexpr int kB = 2 * kTileBytes;
  static constexpr int kKlo = kStages * kStageBytes;
  static constexpr int kVthi = kKlo + kTileBytes;
  static constexpr int kVtlo = kVthi + kTileBytes;
  static constexpr int kQ = kKlo;                    // q lands on the split buffers
  static constexpr int kBar = kVtlo + kTileBytes;
  static constexpr int kBytes = kBar + 64;
  static constexpr int kAlloc = kBytes + 1024;       // slack to align the base
  static_assert(NWG * kTileBytes <= 3 * kTileBytes, "q tile overflows");
};

// Byte offset of element (r, c), c < 64, of a tile of `rows` rows stored
// as two 128-byte-swizzled halves along c (the TMA's SWIZZLE_128B layout).
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  const int h = c >> 5, cc = c & 31;
  return h * rows * 128 + r * 128 + ((((cc >> 2) ^ (r & 7))) << 4) +
         ((cc & 3) << 2);
}

// -- TMA --------------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma / TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Initialises `n` mbarriers of one arrival each (thread 0), then syncs.
__device__ __forceinline__ void init_bars(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_smem();
  }
  __syncthreads();
}

// The dynamic shared-memory base rounded up to the 1024 bytes that a
// 128-byte-swizzled tile starts on.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// -- wgmma -------------------------------------------------------------------

// K-major operand with 128-byte swizzle: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving register reads or writes across the
// asynchronous wgmma (its operands are read and written after the asm)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64 f32, wgmma fragment) (+)= a (64 x 8 tf32, register fragment)
// . b (8 x 64 tf32, K-major in shared memory at `desc`)
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint64_t desc,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(accumulate));
}

// d (64 x 64 f32) (+)= a (64 x 8 tf32, K-major in shared memory at `adesc`)
// . b (8 x 64 tf32, K-major in shared memory at `bdesc`)
__device__ __forceinline__ void wgmma_m64n64k8_ss(float (&d)[32], uint64_t adesc,
                                                  uint64_t bdesc,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}

// descriptor of k-chunk j (8 floats) of a (64 rows, 64 floats) tile stored
// as two 128-byte-swizzled boxes along the floats
__device__ __forceinline__ uint64_t chunk_desc(uint32_t tile, int j) {
  return desc_sw128(tile + (j >> 2) * kBoxBytes + (j & 3) * 32);
}

// -- split TF32 --------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x -> (hi, lo): hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// -- bf16 --------------------------------------------------------------------

// d (64 x 64 f32, wgmma fragment) (+)= a (64 x 16 bf16, register fragment)
// . b (16 x 64 bf16 in shared memory at `desc`): kTransB 0 reads b K-major
// (its 16 K values of a column contiguous), 1 MN-major (its 64 columns of a
// K row contiguous), which 16-bit wgmma can take from a swizzled tile
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32], uint32_t a0,
                                                     uint32_t a1, uint32_t a2,
                                                     uint32_t a3, uint64_t desc,
                                                     int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(accumulate),
        "n"(kTransB));
}

// Byte offset of element (r, c), c < 64, of a bf16 tile of 64-element rows
// (one 128-byte swizzle row each, the TMA's SWIZZLE_128B layout).
__device__ __forceinline__ uint32_t swz16(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + ((c & 7) << 1);
}

// two floats -> one register of two bf16, round to nearest even; lo in
// the low half (the lower column of a wgmma fragment pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two floats -> their bf16 pair (hi, as pack_bf16) and the bf16 pair of
// what hi leaves (lo): hi + lo holds each float to about 2^-17 of itself
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                          uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16),
                 b - __uint_as_float(hi & 0xffff0000u));
}

// Shared-memory plan of the bf16 body (one warpgroup, 64 query rows): a
// 64-row tile of one head is 64 x 64 bf16, one 8 KB box (a head row is one
// 128-byte swizzle row).  Per ring stage: k, v (8 KB each) and, with a
// bias, its f32 tile (16 KB, laid out as in Plan); the q tile beside the
// ring; then a full and an empty mbarrier a stage and q's.  Two stages:
// 40 KB, four blocks an SM; with a bias 72 KB, three.
template <bool kBias>
struct Plan16 {
  static constexpr int kStages = 2;
  static constexpr int kRows = kWgRows;
  static constexpr int kBiasBytes = kBias ? kTileBytes : 0;
  static constexpr int kStageBytes = 2 * kBoxBytes + kBiasBytes;
  static constexpr int kK = 0;                       // within a stage
  static constexpr int kV = kBoxBytes;
  static constexpr int kB = 2 * kBoxBytes;
  static constexpr int kQ = kStages * kStageBytes;
  static constexpr int kBar = kQ + kBoxBytes;
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;       // slack to align the base
};

// Blocks an SM the launch bounds ask registers for, as many as the bf16
// body's shared memory fits: four (at most 128 registers a thread), with a
// bias three (168).  The f32 body: one.
template <typename T, bool kBias>
constexpr int min_blocks() {
  if (std::is_same<T, float>::value) return 1;
  return kBias ? 3 : 4;
}

// -- bf16 helpers --------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22; -inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// one arrival (no transaction bytes): a consumer warp's release of a stage
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// d (64 x 64 f32) (+)= a (64 x 16 bf16, K-major in shared memory at
// `adesc`) . b (16 x 64 bf16, K-major in shared memory at `bdesc`)
__device__ __forceinline__ void wgmma_m64n64k16_bf16_ss(float (&d)[32],
                                                        uint64_t adesc,
                                                        uint64_t bdesc,
                                                        int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}

// -- the body ----------------------------------------------------------------

// A Geo with `static constexpr bool kStats = true` takes the backward's row
// statistics instead of the output rows (see `attend_tf32`).
template <class G, class = void>
struct WritesStats : std::false_type {};
template <class G>
struct WritesStats<G, std::void_t<decltype(G::kStats)>>
    : std::bool_constant<G::kStats> {};

// The steps the two bodies share, on a thread's fragment of one 64-key
// tile of logits: slot 4j+e holds row r0 + 8 (e >> 1), key 8j + 2t + (e & 1).

// adds the f32 bias tile (rows r0 and r0 + 8 of a stage's tile of `rows`
// rows), masks keys past n to -inf, and returns each row's largest logit
// over the four lanes of the row
template <bool kBias>
__device__ __forceinline__ void bias_mask_max(float (&s)[32], const uint8_t* btile,
                                              int rows, int r0, int t, int k0,
                                              int n, float (&tmax)[2]) {
  const float NEG_INF = -INFINITY;
  tmax[0] = tmax[1] = NEG_INF;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e >> 1;
      const int kc = 8 * j + 2 * t + (e & 1);
      float v = s[4 * j + e];
      if constexpr (kBias) {
        v += *reinterpret_cast<const float*>(btile + swz(rows, r0 + 8 * row, kc));
      }
      if (k0 + kc >= n) v = NEG_INF;
      s[4 * j + e] = v;
      tmax[row] = fmaxf(tmax[row], v);
    }
  }
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    tmax[row] = fmaxf(tmax[row], __shfl_xor_sync(0xffffffffu, tmax[row], 1));
    tmax[row] = fmaxf(tmax[row], __shfl_xor_sync(0xffffffffu, tmax[row], 2));
  }
}

// the online-softmax update of the running max m from the tile's row
// maxima: alpha rescales the rows' running sums, m_use is the max the
// tile's exponentials are taken against (0 while a row has seen only -inf)
__device__ __forceinline__ void softmax_rescale(const float (&tmax)[2], float (&m)[2],
                                                float (&alpha)[2],
                                                float (&m_use)[2]) {
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const float m_new = fmaxf(m[row], tmax[row]);
    m_use[row] = (m_new == -INFINITY) ? 0.f : m_new;
    alpha[row] = expf(m[row] - m_use[row]);  // 0 while m is still -inf
    m[row] = m_new;
  }
}

// l = l alpha + the tile's row sums (over the four lanes of a row)
__device__ __forceinline__ void update_sums(float (&psum)[2], const float (&alpha)[2],
                                            float (&l)[2]) {
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    psum[row] += __shfl_xor_sync(0xffffffffu, psum[row], 1);
    psum[row] += __shfl_xor_sync(0xffffffffu, psum[row], 2);
    l[row] = l[row] * alpha[row] + psum[row];
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A Geo whose heads are narrower than the body's 64 columns specialises
// this to true and gives the head dim as `cols` (kernel 1, whose
// specialisation stands beside its SeqGeo): the epilogue then stores only
// columns [0, cols) of each row.  Every other Geo stores all 64.
template <class Geo>
struct NarrowHead : std::false_type {};

// the output rows r0 and r0 + 8 of the tile, 16 columns each: O / l,
// rounded once to the output's type
template <class Geo>
__device__ __forceinline__ void write_rows(const Geo& geo, const float (&o)[32],
                                          const float (&l)[2], int q0, int r0,
                                          int t, int n) {
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int qi = q0 + r0 + 8 * row;
    if (qi < n) {
      const float inv = 1.f / l[row];
      auto* orow = geo.out_row(qi);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // cols is a multiple of 4, so a pair lies wholly inside or past it
        if constexpr (NarrowHead<Geo>::value) {
          if (8 * j + 2 * t >= geo.cols) continue;
        }
        store_pair(orow + 8 * j + 2 * t, o[4 * j + 2 * row] * inv,
                   o[4 * j + 2 * row + 1] * inv);
      }
    }
  }
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the backward's row statistics instead of output rows: lse = m + log l
// and D = g . O / l for rows r0 and r0 + 8, the four lanes of a row summing
// their 16 columns (g in f32 or bf16, the dot in f32)
template <class Geo>
__device__ __forceinline__ void write_stats_rows(const Geo& geo, const float (&o)[32],
                                                 const float (&m)[2],
                                                 const float (&l)[2], int q0,
                                                 int r0, int t, int n) {
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int qi = q0 + r0 + 8 * row;
    const auto* grow = geo.g_row(qi < n ? qi : 0);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 gv = load_pair(grow + 8 * j + 2 * t);
      dot = fmaf(gv.x, o[4 * j + 2 * row], dot);
      dot = fmaf(gv.y, o[4 * j + 2 * row + 1], dot);
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    if (t == 0 && qi < n)
      geo.write_stats(qi, m[row] + logf(l[row]), dot / l[row]);
  }
}

// Geo supplies the tile loads and the output rows of one (sequence or
// window, head):
//   load(dst, bar, which, half, row0): TMA box of 64 rows starting at token
//     row0 of q (which 0), k (1) or v (2), channels [32 half, 32 half + 32)
//     of the head (f32; a bf16 box is the whole head, half 0);
//   load_bias(dst, bar, half, qrow0, k0): bias rows qrow0.., keys
//     k0 + 32 half..;
//   out_row(t): the head's 64 output values of token t (float or bf16;
//     the first `cols` of them with NarrowHead);
// or, with kStats, g_row(t) (the head's 64 floats of the output gradient
// at token t) and write_stats(t, lse, D): the epilogue then writes
// lse = m + log l and D = sum_d g_d O_d for each query row instead of O.

// The split-TF32 body (f32 operands).
template <int NWG, bool kBias, class Geo>
__device__ __forceinline__ void attend_tf32(const Geo& geo, int n, float scale,
                                            int q0, uint8_t* smem_raw) {
  using P = Plan<NWG, kBias>;
  constexpr int kThreads = NWG * 128;
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBar);
  uint64_t* qbar = full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wg * kWgRows + warp * 16 + g;  // rows r0 and r0 + 8 of the tile
  const int ntiles = (n + kKeyTile - 1) / kKeyTile;
  const float NEG_INF = -INFINITY;

  auto issue_tile = [&](int i, int st) {
    uint8_t* stage = smem + st * P::kStageBytes;
    mbar_expect_tx(&full[st], P::kStageBytes);
    const int k0 = i * kKeyTile;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      geo.load(stage + P::kK + h * kBoxBytes, &full[st], 1, h, k0);
      geo.load(stage + P::kV + h * kBoxBytes, &full[st], 2, h, k0);
      if constexpr (kBias) {
#pragma unroll
        for (int b = 0; b < NWG; ++b)
          geo.load_bias(stage + P::kB + h * NWG * kBoxBytes + b * kBoxBytes,
                        &full[st], h, q0 + b * kBoxRows, k0);
      }
    }
  };

  init_bars(full, kStages + 1);  // the ring's and q's
  if (tid == 0) {
    mbar_expect_tx(qbar, NWG * kTileBytes);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < NWG; ++b)
        geo.load(smem + P::kQ + h * NWG * kBoxBytes + b * kBoxBytes, qbar, 0,
                 h, q0 + b * kBoxRows);
    for (int i = 0; i < kStages && i < ntiles; ++i) issue_tile(i, i);
  }

  // q (scaled) as hi and lo A fragments: chunk j, slots (r0, 8j+t),
  // (r0+8, 8j+t), (r0, 8j+t+4), (r0+8, 8j+t+4)
  uint32_t qhi[32], qlo[32];
  mbar_wait(qbar, 0);
  {
    const uint8_t* qs = smem + P::kQ;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int r = r0 + ((s & 1) ? 8 : 0);
        const int c = 8 * j + t + ((s & 2) ? 4 : 0);
        const float x =
            *reinterpret_cast<const float*>(qs + swz(P::kRows, r, c)) * scale;
        split(x, qhi[4 * j + s], qlo[4 * j + s]);
      }
    }
  }
  __syncthreads();  // the q tile's space is the split buffers'

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  uint8_t* klo = smem + P::kKlo;
  uint8_t* vthi = smem + P::kVthi;
  uint8_t* vtlo = smem + P::kVtlo;

  for (int i = 0; i < ntiles; ++i) {
    const int st = i & 1;
    uint8_t* stage = smem + st * P::kStageBytes;
    uint8_t* kt = stage + P::kK;
    const uint8_t* vt = stage + P::kV;
    mbar_wait(&full[st], (i >> 1) & 1);

    // k: hi in place, lo beside it (same swizzled offsets)
#pragma unroll
    for (int e = tid; e < kTileBytes / 16; e += kThreads) {
      float4 x = reinterpret_cast<float4*>(kt)[e];
      uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
      split(x.x, h0, l0);
      split(x.y, h1, l1);
      split(x.z, h2, l2);
      split(x.w, h3, l3);
      reinterpret_cast<uint4*>(kt)[e] = make_uint4(h0, h1, h2, h3);
      reinterpret_cast<uint4*>(klo)[e] = make_uint4(l0, l1, l2, l3);
    }
    // v -> v^T hi and lo, key rows permuted to P's fragment order
#pragma unroll
    for (int e = tid; e < kTileBytes / 16; e += kThreads) {
      const int kr = e & 63;       // key of the tile
      const int dc = e >> 6;       // 4-float group of the head dim, 0..15
      const float4 x = *reinterpret_cast<const float4*>(
          vt + (dc >> 3) * kBoxBytes + kr * 128 +
          ((((dc & 7) ^ (kr & 7))) << 4));
      const int mm = kr & 7;
      const int kpos = (kr & ~7) + ((mm & 1) ? 4 + (mm >> 1) : (mm >> 1));
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t hv, lv;
        split(xs[u], hv, lv);
        const uint32_t off = swz(kHeadDim, 4 * dc + u, kpos);
        *reinterpret_cast<uint32_t*>(vthi + off) = hv;
        *reinterpret_cast<uint32_t*>(vtlo + off) = lv;
      }
    }
    fence_async_smem();
    __syncthreads();

    // S = q k^T: lo.hi, hi.lo, hi.hi
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    const uint32_t khi_a = smem_u32(kt), klo_a = smem_u32(klo);
    wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
      const uint32_t* a = pass == 0 ? qlo : qhi;
      const uint32_t bbase = pass == 1 ? klo_a : khi_a;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wgmma_m64n64k8(s, a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3],
                       chunk_desc(bbase, j), (pass | j) != 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax
    float tmax[2], alpha[2], m_use[2];
    bias_mask_max<kBias>(s, stage + P::kB, P::kRows, r0, t, i * kKeyTile, n,
                         tmax);
    softmax_rescale(tmax, m, alpha, m_use);
    float psum[2] = {0.f, 0.f};
    uint32_t phi[32], plo[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        const float p = expf(s[4 * j + e] - m_use[row]);
        psum[row] += p;
        // A slot order of chunk j: (r0, k t), (r0+8, k t), (r0, k t+4),
        // (r0+8, k t+4) <- keys 2t, 2t, 2t+1, 2t+1 of the chunk
        const int slot = ((e & 1) << 1) | (e >> 1);
        split(p, phi[4 * j + slot], plo[4 * j + slot]);
      }
    }
    update_sums(psum, alpha, l);

    // this tile's P v (lo.hi, hi.lo, hi.hi) in a fresh accumulator, then
    // O = alpha O + P v on the CUDA cores
    const uint32_t vhi_a = smem_u32(vthi), vlo_a = smem_u32(vtlo);
    float pv[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) pv[e] = 0.f;
    fence_regs(pv);
    fence_regs(phi);
    fence_regs(plo);
    wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
      const uint32_t* a = pass == 0 ? plo : phi;
      const uint32_t bbase = pass == 1 ? vlo_a : vhi_a;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wgmma_m64n64k8(pv, a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3],
                       chunk_desc(bbase, j), (pass | j) != 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
    fence_regs(phi);
    fence_regs(plo);
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = fmaf(o[e], alpha[(e >> 1) & 1], pv[e]);
    __syncthreads();  // every warpgroup is done with this stage and the split buffers
    if (tid == 0 && i + kStages < ntiles) {
      fence_async_smem();
      issue_tile(i + kStages, st);
    }
  }

  if constexpr (WritesStats<Geo>::value) {
    write_stats_rows(geo, o, m, l, q0, r0, t, n);
  } else {
    write_rows(geo, o, l, q0, r0, t, n);
  }
}

// The bf16 body, laid out for Hopper: bf16 operands, f32 accumulation,
// one k16 wgmma a 16-deep step, f32 logits and softmax.
//
// Roles.  Thread 0 issues every TMA load: the q tile and the ring's first
// kStages key tiles at the start, then key tile i + kStages into stage
// i % kStages as soon as that stage's empty mbarrier says every warp is
// done with tile i.  No producer warp of its own: a ninth warp leaves 96
// registers a thread at two blocks of eight warps an SM, and ptxas then
// serializes the wgmma for want of registers (PERF.md).  Each warp
// releases a stage by an arrival on its empty mbarrier.  No __syncthreads
// runs after the barriers' set-up.
//
// Block shape (Plan16, min_blocks).  The softmax's instructions, not the
// tensor cores, set the pace, so the SM wants several warpgroups at once,
// each hiding another's softmax behind its products: one warpgroup a
// block (64 query rows), four blocks an SM (three with a bias), every
// flagship shape of kernels 1, 2, 5 and 6 in one wave.  On an H100 these
// blocks beat or tied two warpgroups a block in ping-pong on named
// barriers (PERF.md), which this body therefore does not keep.
//
// A consumer's key loop.  S_i = q k_i^T takes q and k as K-major tiles in
// shared memory (no q fragments in registers); O += P_{i-1} v_{i-1} takes
// the previous tile's probabilities as the register A operand and v
// MN-major as it lands.  Both are issued together, one wait for both
// (the tensor cores run them back to back), then the softmax of tile i:
// logits scaled (and biased, and masked past n) in f32, the running max,
// P = 2^((s - m) log2 e) on the special-function unit, O rescaled in
// place by alpha before the next tile's P v accumulates into it.  O
// accumulates over the key tiles in the tensor
// cores' f32 (truncating) adds: within bf16's own rounding of the output
// (PERF.md: the bf16 entries' error against f64).
//
// With a stats Geo (kernel 5's first pass on bf16 operands) the
// probabilities go to O = P v split as bf16 hi + lo (two k16 wgmma a step,
// lo first), so that O, and the row statistic D = g . O taken from it, is
// near f32 as the TPU kernel's f32 inside is; lse = m + log l in the
// natural base.
template <int NWG, bool kBias, class Geo>
__device__ __forceinline__ void attend_bf16(const Geo& geo, int n, float scale,
                                            int q0, uint8_t* smem_raw) {
  static_assert(NWG == 1, "the bf16 body runs one warpgroup a block");
  constexpr bool kStats = WritesStats<Geo>::value;
  using P = Plan16<kBias>;
  constexpr int kS = P::kStages;
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBar);
  uint64_t* empty = full + kS;
  uint64_t* qbar = empty + kS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ntiles = (n + kKeyTile - 1) / kKeyTile;
  const float NEG_INF = -INFINITY;
  const bool issuer = tid == 0;

  if (issuer) {
    for (int i = 0; i < kS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // every warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_smem();
  }
  __syncthreads();

  auto issue_tile = [&](int i) {
    const int st = i % kS;
    uint8_t* stage = smem + st * P::kStageBytes;
    mbar_expect_tx(&full[st], P::kStageBytes);
    const int k0 = i * kKeyTile;
    geo.load(stage + P::kK, &full[st], 1, 0, k0);
    geo.load(stage + P::kV, &full[st], 2, 0, k0);
    if constexpr (kBias) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        geo.load_bias(stage + P::kB + h * kBoxBytes, &full[st], h, q0, k0);
    }
  };
  if (issuer) {
    mbar_expect_tx(qbar, kBoxBytes);
    geo.load(smem + P::kQ, qbar, 0, 0, q0);
    for (int i = 0; i < kS && i < ntiles; ++i) issue_tile(i);
  }

  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // rows r0 and r0 + 8 of the tile
  // logits -> base-2 exponent: kernel 1's logits stay q k^T (its scale
  // folds in here); a bias Geo's are scaled and biased first
  const float c = kBias ? kLog2e : scale * kLog2e;

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  uint32_t pf[16], plo[16];
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  const uint32_t q_a = smem_u32(smem + P::kQ);
  auto stage_of = [&](int i) { return smem + (i % kS) * P::kStageBytes; };

  // S = q k^T, four k16 steps along the head dim (32 bytes of a swizzled
  // row each)
  auto issue_s = [&](int i) {
    const uint32_t k_a = smem_u32(stage_of(i) + P::kK);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_bf16_ss(s, desc_sw128(q_a + 32 * kk),
                              desc_sw128(k_a + 32 * kk), kk != 0);
  };
  // O += P v, four k16 steps along the keys, 16 rows of v (2048 bytes) each
  auto issue_pv = [&](int i) {
    const uint32_t v_a = smem_u32(stage_of(i) + P::kV);
    if constexpr (kStats) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_bf16<1>(o, plo[4 * kk], plo[4 * kk + 1], plo[4 * kk + 2],
                                plo[4 * kk + 3], desc_sw128(v_a + 2048 * kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_bf16<1>(o, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                              pf[4 * kk + 3], desc_sw128(v_a + 2048 * kk), 1);
  };
  auto fence_all = [&]() {
    fence_regs(s);
    fence_regs(o);
    fence_regs(pf);
    if constexpr (kStats) fence_regs(plo);
  };
  // a phase of wgmma: the products, one commit, one wait
  auto phase_begin = [&]() {
    fence_all();
    wgmma_fence();
  };
  auto phase_end = [&]() {
    wgmma_commit();
    wgmma_wait_all();
    fence_all();
  };
  // every product of this warp has read tile i (and its softmax the
  // bias): release its stage, and refill it with tile i + kStages
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % kS]);
    if (issuer && i + kS < ntiles) {
      mbar_wait(&empty[i % kS], (i / kS) & 1);
      fence_async_smem();  // the bias reads before the TMA overwrites
      issue_tile(i + kS);
    }
  };
  // the online softmax of tile i on s: P (bf16, or hi + lo) into pf, the
  // sums, O rescaled; keys past n are masked (`masked`: std::true_type)
  // only in a ragged last tile, so that a whole tile spends no
  // instructions on them (the softmax's instructions, not the tensor
  // cores, set the pace of this body)
  auto softmax = [&](int i, auto masked) {
    const uint8_t* btile = stage_of(i) + P::kB;
    const int k0 = i * kKeyTile;
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = 8 * j + 2 * t + (e & 1);
        float v = s[4 * j + e];
        if constexpr (kBias) {
          v = fmaf(v, scale, *reinterpret_cast<const float*>(
                                 btile + swz(P::kRows, r0 + 8 * (e >> 1), kc)));
        }
        if constexpr (decltype(masked)::value) {
          if (k0 + kc >= n) v = NEG_INF;
        }
        s[4 * j + e] = v;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], v);
      }
    }
    float alpha[2], mc[2];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      tmax[row] = fmaxf(tmax[row], __shfl_xor_sync(0xffffffffu, tmax[row], 1));
      tmax[row] = fmaxf(tmax[row], __shfl_xor_sync(0xffffffffu, tmax[row], 2));
      const float m_new = fmaxf(m[row], tmax[row]);
      // 0 while the row has seen only -inf: never -inf - -inf
      const float m_use = (m_new == NEG_INF) ? 0.f : m_new;
      alpha[row] = ex2((m[row] - m_use) * c);  // 0 while m is still -inf
      m[row] = m_new;
      mc[row] = m_use * c;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(fmaf(s[4 * j + e], c, -mc[e >> 1]));
        psum[e >> 1] += p[e];
      }
      // chunk j = 2kk + h: registers 4kk + 2h (row r0) and 4kk + 2h + 1
      // (row r0 + 8), keys 8j + 2t and 8j + 2t + 1
      if constexpr (kStats) {
        split_bf16(p[0], p[1], pf[2 * j], plo[2 * j]);
        split_bf16(p[2], p[3], pf[2 * j + 1], plo[2 * j + 1]);
      } else {
        pf[2 * j] = pack_bf16(p[0], p[1]);
        pf[2 * j + 1] = pack_bf16(p[2], p[3]);
      }
    }
    update_sums(psum, alpha, l);
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] *= alpha[(e >> 1) & 1];
  };

  auto softmax_tile = [&](int i) {
    if (i == ntiles - 1 && n % kKeyTile) softmax(i, std::true_type{});
    else softmax(i, std::false_type{});
  };

  mbar_wait(qbar, 0);
  // tile 0: S alone
  mbar_wait(&full[0], 0);
  phase_begin();
  issue_s(0);
  phase_end();
  softmax_tile(0);
  // tile i: S_i with P_{i-1} v_{i-1}
  for (int i = 1; i < ntiles; ++i) {
    mbar_wait(&full[i % kS], (i / kS) & 1);
    phase_begin();
    issue_s(i);
    issue_pv(i - 1);
    phase_end();
    release(i - 1);
    softmax_tile(i);
  }
  // the last tile's P v
  phase_begin();
  issue_pv(ntiles - 1);
  phase_end();
  release(ntiles - 1);

  if constexpr (kStats) {
    const float mn[2] = {kBias ? m[0] : m[0] * scale, kBias ? m[1] : m[1] * scale};
    write_stats_rows(geo, o, mn, l, q0, r0, t, n);
  } else {
    write_rows(geo, o, l, q0, r0, t, n);
  }
}

// T is the operand type: float runs the split-TF32 body, __nv_bfloat16
// the bf16 body.
template <typename T, int NWG, bool kBias, class Geo>
__device__ __forceinline__ void attend(const Geo& geo, int n, float scale,
                                       int q0, uint8_t* smem_raw) {
  if constexpr (std::is_same<T, float>::value) {
    attend_tf32<NWG, kBias>(geo, n, scale, q0, smem_raw);
  } else {
    static_assert(std::is_same<T, __nv_bfloat16>::value,
                  "the bodies take f32 or bf16 operands");
    attend_bf16<NWG, kBias>(geo, n, scale, q0, smem_raw);
  }
}

// Whether T runs the bf16 body.
template <typename T>
constexpr bool is_bf16() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// The dynamic shared memory a block of the T body takes.
template <typename T, int NWG, bool kBias>
constexpr int alloc_bytes() {
  return std::is_same<T, float>::value ? Plan<NWG, kBias>::kAlloc
                                       : Plan16<kBias>::kAlloc;
}

// Token t of a ws x ws window of an NHWC map, and the tile loads of one
// (batch, window, head) through a 4-D map over (channels, W, H, B) whose
// box of (one swizzle row of channels, ws columns, 64 / ws rows, 1) is a
// 64-token tile of the window as it lies in NHWC (kernels 2 and 5); T is
// the output's type.
template <typename T>
struct WindowGeoT {
  const CUtensorMap* map;
  const CUtensorMap* bias_map;
  T* out;
  int H, W, C, ws, head, b, x0, y0, bias_win;
  __device__ __forceinline__ int64_t pix(int t) const {
    return ((int64_t)b * H + y0 + t / ws) * W + x0 + t % ws;
  }
  __device__ __forceinline__ void load(void* dst, uint64_t* bar, int which,
                                       int half, int row0) const {
    tma_load_4d(dst, map, bar, which * C + head * kHeadDim + half * 32, x0,
                y0 + row0 / ws, b);
  }
  __device__ __forceinline__ void load_bias(void* dst, uint64_t* bar, int half,
                                            int qrow0, int k0) const {
    tma_load_3d(dst, bias_map, bar, k0 + half * 32, qrow0, bias_win);
  }
  __device__ __forceinline__ T* out_row(int t) const {
    return out + pix(t) * C + head * kHeadDim;
  }
};
using WindowGeo = WindowGeoT<float>;

// -- host ---------------------------------------------------------------------

// Lets `kernel` use `bytes` of dynamic shared memory on the current device;
// with `max_shared`, also asks for the SM's largest shared-memory carveout
// (so that two blocks of the bf16 body fit an SM); set once a device and
// kernel (the attributes outlive the call).  0 on success.
template <auto kernel>
static inline int allow_smem(int bytes, bool max_shared = false) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < 64 && done[dev]) return 0;
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            bytes);
  if (rc == cudaSuccess && max_shared)
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < 64) done[dev] = true;
  return 0;
}


typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no link
// against libcuda)
static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map with 128-byte swizzle over f32 or bf16 elements (T); dims
// innermost first, strides in bytes for dims 1.., rows past the end read
// as zeros.  0 on success.
template <typename T>
static inline int encode_map(CUtensorMap* map, const void* base, int rank,
                             const cuuint64_t* dims, const cuuint64_t* strides,
                             const cuuint32_t* box) {
  static_assert(std::is_same<T, float>::value ||
                    std::is_same<T, __nv_bfloat16>::value,
                "f32 or bf16 maps");
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map,
                        std::is_same<T, float>::value
                            ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        rank, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

static inline int encode_f32_map(CUtensorMap* map, const void* base, int rank,
                                 const cuuint64_t* dims,
                                 const cuuint64_t* strides,
                                 const cuuint32_t* box) {
  return encode_map<float>(map, base, rank, dims, strides, box);
}

// Elements of T in one 128-byte swizzle row: the inner box of a tile
// (half an f32 head row, a whole bf16 one).
template <typename T>
constexpr int atom_elems() {
  return 128 / (int)sizeof(T);
}

// The 4-D map of an NHWC map of `channels` channels of T read in 64-token
// window tiles (WindowGeoT::load), and the 3-D map of an (n, s, s) f32
// stack of s x s matrices read in (64 rows, 32 columns) boxes, its rows
// `row_floats` apart.  0 on success.
template <typename T = float>
static inline int encode_window_map(CUtensorMap* map, const void* base,
                                    int channels, int W, int H, int B,
                                    int ws) {
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)channels, (cuuint64_t)W,
                              (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)channels * e,
                                 (cuuint64_t)W * channels * e,
                                 (cuuint64_t)H * W * channels * e};
  const cuuint32_t box[4] = {(cuuint32_t)atom_elems<T>(), (cuuint32_t)ws,
                             (cuuint32_t)(kBoxRows / ws), 1};
  return encode_map<T>(map, base, 4, dims, strides, box);
}

static inline int encode_square_map(CUtensorMap* map, const void* base, int s,
                                    int row_floats, int n) {
  const cuuint64_t dims[3] = {(cuuint64_t)s, (cuuint64_t)s, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)row_floats * 4,
                                 (cuuint64_t)s * row_floats * 4};
  const cuuint32_t box[3] = {kAtomFloats, kBoxRows, 1};
  return encode_f32_map(map, base, 3, dims, strides, box);
}

}  // namespace sic_tc
