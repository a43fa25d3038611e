// Tensor-core body of the attention forwards, for Hopper (sm_90a): the
// sequence (kernel 1), NHWC window (kernel 2) and (G, s, d) window
// (kernel 6) attention, and the row statistics of the NHWC backward
// (kernel 5's first pass).  fp32 attention on the tensor cores in split
// TF32 (3xTF32), tiles loaded by TMA into a shared-memory ring, online
// softmax on the wgmma accumulator fragments.
//
// One block holds NWG consumer warpgroups (128 threads each); warpgroup w
// owns query rows [64 w, 64 w + 64) of the block's tile of 64 * NWG rows,
// and all of them share each 64-key tile of k, v (and of the bias).  No
// producer warp: thread 0 issues the TMA loads, two key tiles ahead.
//
// Numbers.  Every product is fp32 accuracy from three TF32 products: each
// operand x is split as hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi),
// and a.b is summed as lo.hi + hi.lo + hi.hi, small terms first, into one
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
// Operand layouts.  tf32 wgmma takes both operands K-major (the transpose
// bits exist only for 16-bit types):
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
// Memory.  128-byte swizzle on every operand tile (a head row of 64 floats
// arrives as two 32-float boxes, one per swizzle atom along K); all tiles
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

// -- the body ----------------------------------------------------------------

// A Geo with `static constexpr bool kStats = true` takes the backward's row
// statistics instead of the output rows (see `attend`).
template <class G, class = void>
struct WritesStats : std::false_type {};
template <class G>
struct WritesStats<G, std::void_t<decltype(G::kStats)>>
    : std::bool_constant<G::kStats> {};

// Geo supplies the tile loads and the output rows of one (sequence or
// window, head):
//   load(dst, bar, which, half, row0): TMA box of 64 rows starting at token
//     row0 of q (which 0), k (1) or v (2), channels [32 half, 32 half + 32)
//     of the head;
//   load_bias(dst, bar, half, qrow0, k0): bias rows qrow0.., keys
//     k0 + 32 half..;
//   out_row(t): the head's 64 output floats of token t;
// or, with kStats, g_row(t) (the head's 64 floats of the output gradient
// at token t) and write_stats(t, lse, D): the epilogue then writes
// lse = m + log l and D = sum_d g_d O_d for each query row instead of O.
// T is the operand type; the one entry point today is float (split TF32),
// the slot a bf16 entry would take.
template <typename T, int NWG, bool kBias, class Geo>
__device__ __forceinline__ void attend(const Geo& geo, int n, float scale,
                                       int q0, uint8_t* smem_raw) {
  static_assert(std::is_same<T, float>::value,
                "the split-TF32 body takes f32 operands");
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

    // online softmax; fragment slot 4j+e holds row r0 + 8 (e >> 1), key
    // 8j + 2t + (e & 1)
    const int k0 = i * kKeyTile;
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        const int kc = 8 * j + 2 * t + (e & 1);
        float v = s[4 * j + e];
        if constexpr (kBias) {
          v += *reinterpret_cast<const float*>(
              stage + P::kB + swz(P::kRows, r0 + 8 * row, kc));
        }
        if (k0 + kc >= n) v = NEG_INF;
        s[4 * j + e] = v;
        tmax[row] = fmaxf(tmax[row], v);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      tmax[row] = fmaxf(tmax[row], __shfl_xor_sync(0xffffffffu, tmax[row], 1));
      tmax[row] = fmaxf(tmax[row], __shfl_xor_sync(0xffffffffu, tmax[row], 2));
      const float m_new = fmaxf(m[row], tmax[row]);
      m_use[row] = (m_new == NEG_INF) ? 0.f : m_new;
      alpha[row] = expf(m[row] - m_use[row]);  // 0 while m is still -inf
      m[row] = m_new;
    }
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
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      psum[row] += __shfl_xor_sync(0xffffffffu, psum[row], 1);
      psum[row] += __shfl_xor_sync(0xffffffffu, psum[row], 2);
      l[row] = l[row] * alpha[row] + psum[row];
    }

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
    // the backward's row statistics: lse and D = g . O, the four lanes of
    // a row summing their 16 columns
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int qi = q0 + r0 + 8 * row;
      const float* grow = geo.g_row(qi < n ? qi : 0);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 gv = *reinterpret_cast<const float2*>(grow + 8 * j + 2 * t);
        dot = fmaf(gv.x, o[4 * j + 2 * row], dot);
        dot = fmaf(gv.y, o[4 * j + 2 * row + 1], dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if (t == 0 && qi < n)
        geo.write_stats(qi, m[row] + logf(l[row]), dot / l[row]);
    }
  } else {
    // epilogue: rows r0 and r0 + 8 of the tile, 16 floats each
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int qi = q0 + r0 + 8 * row;
      if (qi < n) {
        const float inv = 1.f / l[row];
        float* orow = geo.out_row(qi);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) = make_float2(
              o[4 * j + 2 * row] * inv, o[4 * j + 2 * row + 1] * inv);
        }
      }
    }
  }
}

// Token t of a ws x ws window of an NHWC map, and the tile loads of one
// (batch, window, head) through a 4-D map over (channels, W, H, B) whose
// box of (32 channels, ws columns, 64 / ws rows, 1) is a 64-token tile of
// the window as it lies in NHWC (kernels 2 and 5).
struct WindowGeo {
  const CUtensorMap* map;
  const CUtensorMap* bias_map;
  float* out;
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
  __device__ __forceinline__ float* out_row(int t) const {
    return out + pix(t) * C + head * kHeadDim;
  }
};

// -- host ---------------------------------------------------------------------

// Lets `kernel` use `bytes` of dynamic shared memory on the current device;
// set once a device and kernel (the attribute outlives the call).  0 on
// success.
template <auto kernel>
static inline int allow_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < 64 && done[dev]) return 0;
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            bytes);
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

// An f32 tensor map with 128-byte swizzle; dims innermost first, strides
// in bytes for dims 1.., rows past the end read as zeros.  0 on success.
static inline int encode_f32_map(CUtensorMap* map, const void* base, int rank,
                                 const cuuint64_t* dims,
                                 const cuuint64_t* strides,
                                 const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The 4-D map of an NHWC f32 map of `channels` channels read in 64-token
// window tiles (WindowGeo::load), and the 3-D map of an (n, s, s) f32
// stack of s x s matrices read in (64 rows, 32 columns) boxes, its rows
// `row_floats` apart.  0 on success.
static inline int encode_window_map(CUtensorMap* map, const void* base,
                                    int channels, int W, int H, int B,
                                    int ws) {
  const cuuint64_t dims[4] = {(cuuint64_t)channels, (cuuint64_t)W,
                              (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)channels * 4,
                                 (cuuint64_t)W * channels * 4,
                                 (cuuint64_t)H * W * channels * 4};
  const cuuint32_t box[4] = {kAtomFloats, (cuuint32_t)ws,
                             (cuuint32_t)(kBoxRows / ws), 1};
  return encode_f32_map(map, base, 4, dims, strides, box);
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
