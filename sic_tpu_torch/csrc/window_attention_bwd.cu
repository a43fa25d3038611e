// Backward of NHWC window attention over a packed qkv projection, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel sic_tpu/ops/window_attention.py::_nhwc_bwd_kernel
// (launcher _nhwc_bwd_pallas): the recompute-attention VJP of
// softmax(q * scale . k^T + bias[(i * nww + j) % nB]) v for every ws x ws
// window (i, j) of a (B, H, W, 3C) packed [q | k | v] map and every head.
// Given g = dL/dout (B, H, W, C) it writes dqkv (B, H, W, 3C) in the packed
// head-major layout and dbias (nB, s, s), s = ws * ws: dbias is summed over
// the batch and the heads, and over the windows too when nB == 1 (nB == nW
// keeps one bias per window, the shifted layers' case).
//
// What bounds it on the H100: 10 * s * s * d flops per (window, head) (the
// logits, dP = g . v^T and the three products for dq, dk and dv) against
// 28 bytes per token and channel read or written, so it is bound by
// operations: at fp32 accuracy on the tensor cores, 3 TF32 products per
// product over 495 TFLOP/s (the f32 CUDA cores' 67 TFLOP/s bound is kept
// beside it; the first version ran every product as an f32 FMA there, at
// 11% of that bound).
//
// The TPU kernel walked its grid in order and carried dbias in VMEM across
// the batch.  Here blocks run in parallel in no fixed order, so the work is
// four launches with no float atomics (two launches on one input give the
// same bits):
//
//   1. stats:  per (b, window, head, query tile) the forward body of
//              kernel 2 (attention_tc.cuh) with the StatsGeo epilogue: the
//              row lse_i = m_i + log l_i and D_i = sum_d g_id O_id (equal
//              to sum_j P_ij dP_ij) instead of O;
//   2. dk, dv: per (b, window, head, 64-key tile), two warpgroups sweep
//              the query tiles side by side on the same 64 keys: S^T =
//              k (q scale)^T in one and dP^T = v g^T in the other, with k
//              and v as shared-memory A operands and q and g as B operands
//              as they land (d contiguous: K-major); P^T = exp(S^T +
//              bias^T - lse) (bias^T read transposed from the swizzled
//              bias tile; a -inf logit gives 0) passes through shared
//              memory to the second, which forms dS^T = P^T (dP^T - D);
//              then dv += P^T g and dk += dS^T (q scale) run side by side,
//              P^T and dS^T as register A operands straight from the
//              accumulators, g^T and (q scale)^T staged transposed with
//              their query columns permuted to the fragments' order (as
//              the forward stages v^T); dS goes to the scratch as (query,
//              key) rows;
//   3. dq:     per (b, window, head, 64-query tile) dq = dS k scale, the dS
//              tile by TMA (keys contiguous: K-major A, split in place) and
//              k^T staged transposed in logical order (A comes from shared
//              memory, so no permutation);
//   4. dbias:  one thread per bias element sums the scratch over batch,
//              heads (and windows) in a fixed order.
//
// Numbers.  Every product is split TF32 (lo.hi + hi.lo + hi.hi, small
// terms first).  The tensor core's f32 accumulation truncates, so no chain
// runs longer than one tile of 64 over K (24 wgmma): each query tile's dv
// and dk products, and each key tile's dq product, go to a fresh
// accumulator and are added in with f32 adds.
//
// Shared memory and registers (pass 2, ptxas -v: see the build report of
// chip_smoke.py): the block's k and v tiles as A operands in hi and lo
// (64 KB: as register fragments they would cost 128 registers beside the
// accumulators), and per query tile q and g in hi and lo, their
// transposes in hi and lo, the bias tile and P^T (160 KB): 224 KB, one
// 256-thread block an SM, no ring; the next query tile's q and g are
// loaded as soon as the products have read them, its bias after P^T.  A
// thread holds one 64 x 64 accumulator of dv or dk, the tile's S^T or
// dP^T, their split A fragments and a fresh tile accumulator: 146
// registers, no spills.  Two warpgroups, because one taking all four
// products in turn waits on each chain in turn: 0.122 ms of the
// backward's 0.219 at 512 px on an H100 80GB HBM3 (PERF.md).  The wgmma
// calls sit in no branch (a warpgroup picks its operands by address): in
// a branch on the warpgroup ptxas serializes them.  Pass 3 (91
// registers) fits two 128-thread blocks an SM (115,712 bytes each).
// Scratch (allocated by the wrapper): dS as (B, nW, heads, s, s) f32 and
// the row stats as (B, nW, heads, s) float2; the dS scratch (4 s^2 bytes
// per window and head) is device-memory traffic the TPU kernel did not
// have, and buys a deterministic dq and dbias without atomics.
//
// The bf16 entry (sic_window_attention_bwd_bf16; every Swin layer's
// gradient when training computes in bf16): bf16 qkv, g and dqkv, f32
// bias, dbias and scratch, the same four passes.  The TPU
// kernel upcasts qkv and g and computes in f32 inside, so the only
// rounding it adds is dqkv's to bf16.  Here S = q k^T and dP = g v^T take
// their bf16 operands exactly (one k16 wgmma a step, f32 accumulation);
// the error would enter where the f32 intermediates P and dS meet the
// tensor cores, in dv = P^T g, dk = dS^T q and dq = dS k, and in O of the
// first pass (D = g . O): there each goes in as bf16 hi + lo, two wgmma
// a step, which leaves it about 2^-17 of itself, below dqkv's own
// rounding (2^-9).  Each tile's product still goes to a fresh
// accumulator added in f32 in pass 3; in pass 2, dv and dk accumulate
// over the query tiles in the tensor cores.  v, g, q and k are read
// MN-major as TMA lands them (the transpose bit of 16-bit wgmma), so the
// bf16 passes stage no transposes: pass 2 holds k, v, P^T and a two-stage
// ring of (q, g, bias) in 97 KB, pass 3 a two-stage ring of (dS, k) in 48
// KB.  dqkv is rounded once to bf16; dbias (pass 4, shared) is f32 as in
// the f32 entry.  Its bound: the same 10 s^2 d flops a window and head
// over 989 TFLOP/s, at 2 bytes an element of qkv, g and dqkv.
//
// The bf16 passes' schedule, set by what the card measured (PERF.md):
// pass 1 runs attention_tc.cuh's bf16 body in one-warpgroup blocks, three
// an SM (at 512 px 384 blocks, one wave; two-warpgroup blocks, one an SM
// by their shared memory, would take 1.45); pass 2 fits two blocks an SM
// (at most 128 registers: dv and dk need no fresh accumulator), takes P^T
// by ex2, hands P^T from warpgroup 0 to 1 through an mbarrier pair and
// refills its ring from warpgroup 1's first thread once all eight warps
// have released a stage, with no block barrier after set-up; pass 3 runs
// four blocks an SM.
#include "attention_tc.cuh"

namespace {

using sic_tc::kBoxBytes;
using sic_tc::kHeadDim;
using sic_tc::kTileBytes;

constexpr int kRows = 64;  // keys (pass 2) or queries (pass 3) of a block

// -- pass 1 -------------------------------------------------------------------

// T: the type of qkv and g (f32 or bf16); the statistics are f32
template <typename T>
struct StatsGeo : sic_tc::WindowGeoT<T> {
  static constexpr bool kStats = true;
  const T* g;
  float2* stats;  // the rows of this (b, window, head)
  __device__ __forceinline__ const T* g_row(int t) const {
    return g + this->pix(t) * this->C + this->head * kHeadDim;
  }
  __device__ __forceinline__ void write_stats(int t, float lse,
                                              float d) const {
    stats[t] = make_float2(lse, d);
  }
};

// grid: x = head * ntiles + query tile, y = window, z = batch
template <typename T, int NWG>
__global__ void __launch_bounds__(NWG * 128,
                      sic_tc::min_blocks<T, true>())
    bwd_stats_kernel(const __grid_constant__ CUtensorMap map,
                     const __grid_constant__ CUtensorMap bias_map,
                     const T* __restrict__ g, float2* __restrict__ stats,
                     int H, int W, int C, int ws, int nB, float scale) {
  extern __shared__ uint8_t smem[];
  const int s = ws * ws;
  const int ntiles = s / (NWG * sic_tc::kWgRows);
  const int nww = W / ws;
  const int win = blockIdx.y;
  const int head = blockIdx.x / ntiles;
  const int64_t slab =
      ((int64_t)blockIdx.z * gridDim.y + win) * (gridDim.x / ntiles) + head;
  const StatsGeo<T> geo{{&map, &bias_map, nullptr, H, W, C, ws, head,
                         (int)blockIdx.z, (win % nww) * ws, (win / nww) * ws,
                         win % nB},
                        g,
                        stats + slab * s};
  sic_tc::attend<T, NWG, true>(
      geo, s, scale, ((int)blockIdx.x % ntiles) * NWG * sic_tc::kWgRows, smem);
}

// -- shared pieces of passes 2 and 3 ------------------------------------------

// Offset of float4 group (r, c4) of a swizzled (64 rows, 64 floats) tile.
__device__ __forceinline__ uint32_t swz4(int r, int c4) {
  return (c4 >> 3) * kBoxBytes + r * 128 + ((((c4 & 7) ^ (r & 7))) << 4);
}

// Column of query (or key) q of a 64-wide tile staged transposed for a
// register A operand taken from an accumulator: logical k = kk of each
// 8-chunk holds q = 2 kk (kk < 4) or 2 (kk - 4) + 1 (attention_tc.cuh).
__device__ __forceinline__ int frag_col(int q) {
  const int mm = q & 7;
  return (q & ~7) + ((mm & 1) ? 4 + (mm >> 1) : (mm >> 1));
}

// A raw (64 rows, 64 floats) tile, times `mul`: hi in place and lo beside
// it (same offsets), and, if `thi`, its transpose (64 floats as rows) in
// hi and lo, row r going to column frag_col(r) (permuted) or r.
// The 128 threads of one warpgroup (index `tid`) share the work.
template <bool kPermute>
__device__ __forceinline__ void split_tile(int tid, uint8_t* raw, uint8_t* lo,
                                           uint8_t* thi, uint8_t* tlo,
                                           float mul, bool in_place) {
#pragma unroll 2
  for (int e = tid; e < kTileBytes / 16; e += 128) {
    const int r = e & 63;
    const int c4 = e >> 6;
    const uint32_t off = swz4(r, c4);
    const float4 x = *reinterpret_cast<const float4*>(raw + off);
    const float xs[4] = {x.x * mul, x.y * mul, x.z * mul, x.w * mul};
    uint32_t h[4], l[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) sic_tc::split(xs[u], h[u], l[u]);
    if (in_place) {
      *reinterpret_cast<uint4*>(raw + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    if (thi != nullptr) {
      const int col = kPermute ? frag_col(r) : r;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t toff = sic_tc::swz(kRows, 4 * c4 + u, col);
        *reinterpret_cast<uint32_t*>(thi + toff) = h[u];
        *reinterpret_cast<uint32_t*>(tlo + toff) = l[u];
      }
    }
  }
}

// acc = a . b^T over K = 64 in split TF32, both operands (64 rows, 64
// floats) K-major tiles in shared memory (hi and lo); one accumulator
// (24 wgmma).  The caller fences, commits and waits.
__device__ __forceinline__ void mma3_ss(float (&acc)[32], const uint8_t* ahi,
                                        const uint8_t* alo, const uint8_t* bhi,
                                        const uint8_t* blo) {
  const uint32_t a[2] = {sic_tc::smem_u32(alo), sic_tc::smem_u32(ahi)};
  const uint32_t b[2] = {sic_tc::smem_u32(blo), sic_tc::smem_u32(bhi)};
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t abase = a[pass != 0];   // lo, hi, hi
    const uint32_t bbase = b[pass != 1];   // hi, lo, hi
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sic_tc::wgmma_m64n64k8_ss(acc, sic_tc::chunk_desc(abase, j),
                                sic_tc::chunk_desc(bbase, j), (pass | j) != 0);
  }
}

// acc += x . b over K = 64 in split TF32: x is an accumulator fragment
// (rows of the warpgroup's 64, columns the K index), split into register
// A fragments; b^T is staged in shared memory (hi and lo) with its K
// columns permuted by frag_col.  The tile's product goes to a fresh
// accumulator and is added into acc with f32 adds.
__device__ __forceinline__ void mma3_rs_add(float (&acc)[32],
                                            const float (&x)[32],
                                            const uint8_t* bhi,
                                            const uint8_t* blo) {
  uint32_t xhi[32], xlo[32];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int slot = ((e & 1) << 1) | (e >> 1);
      sic_tc::split(x[4 * j + e], xhi[4 * j + slot], xlo[4 * j + slot]);
    }
  }
  float tile[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) tile[e] = 0.f;
  sic_tc::fence_regs(tile);
  sic_tc::fence_regs(xhi);
  sic_tc::fence_regs(xlo);
  const uint32_t b[2] = {sic_tc::smem_u32(blo), sic_tc::smem_u32(bhi)};
  sic_tc::wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t* a = pass == 0 ? xlo : xhi;
    const uint32_t bbase = b[pass != 1];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sic_tc::wgmma_m64n64k8(tile, a[4 * j], a[4 * j + 1], a[4 * j + 2],
                             a[4 * j + 3], sic_tc::chunk_desc(bbase, j),
                             (pass | j) != 0);
  }
  sic_tc::wgmma_commit();
  sic_tc::wgmma_wait_all();
  sic_tc::fence_regs(tile);
  sic_tc::fence_regs(xhi);
  sic_tc::fence_regs(xlo);
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] += tile[e];
}

// -- pass 2 -------------------------------------------------------------------

// 16-KB tiles of the pass-2 block (kPx: P^T passed between the
// warpgroups), then two mbarriers; slack to align the base to 1024 bytes
// from the 16 bytes dynamic shared memory is aligned to at least
enum DkdvTile { kKhi, kKlo, kVhi, kVlo, kQhi, kQlo, kGhi, kGlo, kQThi, kQTlo,
                kGThi, kGTlo, kBias, kPx, kDkdvTiles };
constexpr int kDkdvBytes = kDkdvTiles * kTileBytes + 16 + 1008;

// grid: x = head * nk + key tile, y = window, z = batch; 256 threads.
// Both warpgroups hold the same 64 keys in the same fragment layout:
// warpgroup 0 takes S^T, P^T and dv, warpgroup 1 dP^T, dS^T and dk, so the
// logits' and dP's products run side by side on the tensor cores, and so
// do dv's and dk's; P^T passes from 0 to 1 through shared memory.
__global__ void __launch_bounds__(256, 1)
    bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map,
                    const __grid_constant__ CUtensorMap g_map,
                    const __grid_constant__ CUtensorMap bias_map,
                    const float2* __restrict__ stats, float* __restrict__ ds,
                    float* __restrict__ dqkv, int H, int W, int C, int ws,
                    int nB, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sic_tc::align1024(smem_raw);
  auto tile = [&](int i) { return smem + i * kTileBytes; };
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + kDkdvTiles * kTileBytes);
  uint64_t* tbar = kvbar + 1;
  float4* px = reinterpret_cast<float4*>(tile(kPx));  // [8][128] float4

  const int s = ws * ws;
  const int n = s / kRows;  // key tiles = query tiles of a window
  const int head = blockIdx.x / n;
  const int k0 = (blockIdx.x % n) * kRows;
  const int win = blockIdx.y;
  const int b = blockIdx.z;
  const int nww = W / ws;
  const int x0 = (win % nww) * ws, y0 = (win / nww) * ws;
  const int64_t slab =
      ((int64_t)b * gridDim.y + win) * (gridDim.x / n) + head;
  const int tid = threadIdx.x;
  // 0: P^T and dv; 1: dP^T, dS^T and dk (broadcast from lane 0, so that
  // the compiler sees it uniform across the warp)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wtid = tid & 127;
  const int lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int r0 = (wtid >> 5) * 16 + gq;  // keys r0 and r0 + 8 of the tile

  // 64 tokens from row0 of the window, channels c0.. of a 4-D NHWC map
  auto load = [&](uint8_t* dst, const CUtensorMap* m, uint64_t* bar, int c0,
                  int row0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sic_tc::tma_load_4d(dst + h * kBoxBytes, m, bar, c0 + h * 32, x0,
                          y0 + row0 / ws, b);
  };
  auto issue_qg = [&](int i0) {
    load(tile(kQhi), &map, tbar, head * kHeadDim, i0);
    load(tile(kGhi), &g_map, tbar, head * kHeadDim, i0);
  };
  auto issue_bias = [&](int i0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sic_tc::tma_load_3d(tile(kBias) + h * kBoxBytes, &bias_map, tbar,
                          k0 + h * 32, i0, win % nB);
  };

  sic_tc::init_bars(kvbar, 2);
  if (tid == 0) {
    sic_tc::mbar_expect_tx(kvbar, 2 * kTileBytes);
    load(tile(kKhi), &map, kvbar, C + head * kHeadDim, k0);
    load(tile(kVhi), &map, kvbar, 2 * C + head * kHeadDim, k0);
    sic_tc::mbar_expect_tx(tbar, 3 * kTileBytes);
    issue_qg(0);
    issue_bias(0);
  }
  // warpgroup 0 splits k and then each q tile (scaled), warpgroup 1 v and
  // each g tile; each runs its products on its own operands, picked by
  // address, so no wgmma sits in a branch
  const int mine = wg == 0 ? kKhi : kVhi;
  const int q_or_g = wg == 0 ? kQhi : kGhi;
  const int other_t = wg == 0 ? kGThi : kQThi;  // g^T for dv, q^T for dk
  sic_tc::mbar_wait(kvbar, 0);
  split_tile<false>(wtid, tile(mine), tile(mine + 1), nullptr, nullptr, 1.f,
                    true);

  float acc[32];  // dv (warpgroup 0) or dk (warpgroup 1)
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  const float* srow0 = reinterpret_cast<const float*>(stats + slab * s);
  float* ds_slab = ds + slab * s * s;
  const float NEG_INF = -INFINITY;

  for (int it = 0; it < n; ++it) {
    const int i0 = it * kRows;
    sic_tc::mbar_wait(tbar, it & 1);
    split_tile<true>(wtid, tile(q_or_g), tile(q_or_g + 1),
                     tile(wg == 0 ? kQThi : kGThi),
                     tile(wg == 0 ? kQTlo : kGTlo), wg == 0 ? scale : 1.f,
                     true);
    // this tile's lse (warpgroup 0) or D (warpgroup 1) of queries
    // 8j + 2t and 8j + 2t + 1
    float st[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 v4 = *reinterpret_cast<const float4*>(
          srow0 + 2 * (i0 + 8 * j + 2 * t));
      st[2 * j] = wg == 0 ? v4.x : v4.y;
      st[2 * j + 1] = wg == 0 ? v4.z : v4.w;
    }
    sic_tc::fence_async_smem();
    __syncthreads();

    // S^T = k (q scale)^T or dP^T = v g^T: rows keys, columns queries
    float x[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) x[e] = 0.f;
    sic_tc::fence_regs(x);
    sic_tc::wgmma_fence();
    mma3_ss(x, tile(mine), tile(mine + 1), tile(q_or_g), tile(q_or_g + 1));
    sic_tc::wgmma_commit();
    sic_tc::wgmma_wait_all();
    sic_tc::fence_regs(x);
    __syncthreads();  // both products have read q and g
    if (tid == 0 && it + 1 < n) {
      sic_tc::mbar_expect_tx(tbar, 3 * kTileBytes);
      sic_tc::fence_async_smem();
      issue_qg(i0 + kRows);
    }

    // slot 4j+e holds key r0 + 8 (e >> 1), query 8j + 2t + (e & 1)
    if (wg == 0) {
      const uint8_t* bias = tile(kBias);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          const int kr = r0 + 8 * (e >> 1);
          const float v = x[4 * j + e] + *reinterpret_cast<const float*>(
                                             bias + sic_tc::swz(kRows, qc, kr));
          x[4 * j + e] = (v == NEG_INF) ? 0.f : expf(v - st[2 * j + (e & 1)]);
        }
        px[j * 128 + wtid] =
            make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      }
    }
    __syncthreads();  // P^T is passed on and the bias tile read
    if (tid == 0 && it + 1 < n) {
      sic_tc::fence_async_smem();
      issue_bias(i0 + kRows);
    }

    if (wg == 1) {
      // dS^T = P^T (dP^T - D), to the scratch as (query, key) rows
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p = px[j * 128 + wtid];
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          const int kr = r0 + 8 * (e >> 1);
          x[4 * j + e] = pv[e] * (x[4 * j + e] - st[2 * j + (e & 1)]);
          ds_slab[(int64_t)(i0 + qc) * s + k0 + kr] = x[4 * j + e];
        }
      }
    }
    // dv += P^T g (warpgroup 0) or dk += dS^T (q scale) (warpgroup 1)
    mma3_rs_add(acc, x, tile(other_t), tile(other_t + 1));
    __syncthreads();  // the transposes, lo tiles and P^T are free again
  }

  // rows r0 and r0 + 8: the keys' dv (warpgroup 0) or dk (1; q was scaled)
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int key = k0 + r0 + 8 * row;
    float* out = dqkv +
                 (((int64_t)b * H + y0 + key / ws) * W + x0 + key % ws) * 3 * C +
                 (wg == 0 ? 2 * C : C) + head * kHeadDim;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * row], acc[4 * j + 2 * row + 1]);
  }
}

// -- pass 3 -------------------------------------------------------------------

// a two-stage ring of (dS tile, k tile), then dS lo, k^T hi, k^T lo
constexpr int kDqStage = 2 * kTileBytes;
constexpr int kDqDslo = 2 * kDqStage;
constexpr int kDqKthi = kDqDslo + kTileBytes;
constexpr int kDqKtlo = kDqKthi + kTileBytes;
constexpr int kDqBar = kDqKtlo + kTileBytes;
// two blocks an SM: 2 x (115,712 + 1,024 reserved) = the SM's 233,472
constexpr int kDqBytes = kDqBar + 16 + 1008;

// grid: x = head * nq + query tile, y = window, z = batch; 128 threads
__global__ void __launch_bounds__(128, 2)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap map,
                  const __grid_constant__ CUtensorMap ds_map,
                  float* __restrict__ dqkv, int H, int W, int C, int ws,
                  float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sic_tc::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDqBar);

  const int s = ws * ws;
  const int n = s / kRows;
  const int head = blockIdx.x / n;
  const int i0 = (blockIdx.x % n) * kRows;
  const int win = blockIdx.y;
  const int b = blockIdx.z;
  const int nww = W / ws;
  const int x0 = (win % nww) * ws, y0 = (win / nww) * ws;
  const int slab =
      (int)(((int64_t)b * gridDim.y + win) * (gridDim.x / n) + head);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);  // queries r0, r0 + 8

  auto issue = [&](int kt, int st) {
    uint8_t* stage = smem + st * kDqStage;
    sic_tc::mbar_expect_tx(&full[st], 2 * kTileBytes);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sic_tc::tma_load_3d(stage + h * kBoxBytes, &ds_map, &full[st],
                          kt * kRows + h * 32, i0, slab);
      sic_tc::tma_load_4d(stage + kTileBytes + h * kBoxBytes, &map, &full[st],
                          C + head * kHeadDim + h * 32, x0,
                          y0 + kt * kRows / ws, b);
    }
  };

  sic_tc::init_bars(full, 2);
  if (tid == 0) {
    for (int i = 0; i < 2 && i < n; ++i) issue(i, i);
  }
  float dq[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dq[e] = 0.f;
  uint8_t* dslo = smem + kDqDslo;
  uint8_t* kthi = smem + kDqKthi;
  uint8_t* ktlo = smem + kDqKtlo;
  for (int kt = 0; kt < n; ++kt) {
    const int st = kt & 1;
    uint8_t* stage = smem + st * kDqStage;
    sic_tc::mbar_wait(&full[st], (kt >> 1) & 1);
    split_tile<false>(tid, stage, dslo, nullptr, nullptr, 1.f, true);
    split_tile<false>(tid, stage + kTileBytes, nullptr, kthi, ktlo, 1.f, false);
    sic_tc::fence_async_smem();
    __syncthreads();
    // this key tile's dS k in a fresh accumulator
    float part[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) part[e] = 0.f;
    sic_tc::fence_regs(part);
    sic_tc::wgmma_fence();
    mma3_ss(part, stage, dslo, kthi, ktlo);
    sic_tc::wgmma_commit();
    sic_tc::wgmma_wait_all();
    sic_tc::fence_regs(part);
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[e] += part[e];
    __syncthreads();  // the stage and the split buffers are free
    if (tid == 0 && kt + 2 < n) {
      sic_tc::fence_async_smem();
      issue(kt + 2, st);
    }
  }

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int q = i0 + r0 + 8 * row;
    float* out = dqkv +
                 (((int64_t)b * H + y0 + q / ws) * W + x0 + q % ws) * 3 * C +
                 head * kHeadDim;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j + 2 * t) = make_float2(
          dq[4 * j + 2 * row] * scale, dq[4 * j + 2 * row + 1] * scale);
  }
}

// -- bf16 passes 2 and 3 -------------------------------------------------------
//
// The bf16 entry's passes on the bf16 tensor cores (k16 wgmma, f32
// accumulation).  A 64-token tile of one head is one 8-KB box of 64 rows
// of 64 bf16 (one 128-byte swizzle row each).  S^T = k q^T and dP^T =
// v g^T take bf16 operands exactly: k or v as register A fragments, q or
// g as K-major B tiles as they land.  dv += P^T g, dk += dS^T q and dq +=
// dS k take the f32 P and dS as bf16 hi + lo (two k16 wgmma a step, lo
// first), g, q and k as MN-major B tiles as they land (the transpose
// bit), so nothing is staged or transposed.  scale multiplies the logits,
// dk and dq in f32.

// acc += x . b over K = 64: x an accumulator fragment (rows of the
// warpgroup's 64, columns the K index) split into register A fragments
// of bf16 hi and lo (for 16-bit types the accumulator's slots of columns
// 16kk.. are the A fragment of step kk), b a (64 K rows, 64 bf16) MN-major
// tile at shared address b_a.  The products accumulate into acc in the
// tensor cores' f32 over the query tiles (truncating adds, below dqkv's
// bf16 rounding; PERF.md): no fresh accumulator, so that the pass fits
// two blocks an SM.
__device__ __forceinline__ void mma16_rs_acc(float (&acc)[32],
                                             const float (&x)[32],
                                             uint32_t b_a) {
  uint32_t hi[16], lo[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int row = 0; row < 2; ++row)
      sic_tc::split_bf16(x[4 * j + 2 * row], x[4 * j + 2 * row + 1],
                         hi[2 * j + row], lo[2 * j + row]);
  }
  sic_tc::fence_regs(acc);
  sic_tc::fence_regs(hi);
  sic_tc::fence_regs(lo);
  sic_tc::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sic_tc::wgmma_m64n64k16_bf16<1>(acc, lo[4 * kk], lo[4 * kk + 1],
                                    lo[4 * kk + 2], lo[4 * kk + 3],
                                    sic_tc::desc_sw128(b_a + 2048 * kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sic_tc::wgmma_m64n64k16_bf16<1>(acc, hi[4 * kk], hi[4 * kk + 1],
                                    hi[4 * kk + 2], hi[4 * kk + 3],
                                    sic_tc::desc_sw128(b_a + 2048 * kk), 1);
  sic_tc::wgmma_commit();
  sic_tc::wgmma_wait_all();
  sic_tc::fence_regs(acc);
  sic_tc::fence_regs(hi);
  sic_tc::fence_regs(lo);
}

// The pass-2 block: k and v (8 KB each), P^T passed between the
// warpgroups (f32, 16 KB), then a two-stage ring of (q, g, bias) tiles
// (8 + 8 + 16 KB), then the mbarriers: k and v's, the ring's full and
// empty pairs, P^T's full and empty pair.  97 KB: two blocks an SM.
constexpr int kB16K = 0;
constexpr int kB16V = kBoxBytes;
constexpr int kB16Px = 2 * kBoxBytes;
constexpr int kB16Ring = kB16Px + kTileBytes;
constexpr int kB16Q = 0;  // within a stage
constexpr int kB16G = kBoxBytes;
constexpr int kB16Bias = 2 * kBoxBytes;
constexpr int kB16Stage = 2 * kBoxBytes + kTileBytes;
constexpr int kB16Bar = kB16Ring + 2 * kB16Stage;
constexpr int kDkdv16Bytes = kB16Bar + 64 + 1024;

// grid: x = head * nk + key tile, y = window, z = batch; 256 threads, two
// blocks an SM (at most 128 registers a thread).  Warpgroup 0 takes S^T,
// P^T and dv, warpgroup 1 dP^T, dS^T and dk, as in the f32 pass; each picks
// its operands by address, so no wgmma sits in a branch.  No block
// barrier after set-up: P^T goes from warpgroup 0 to 1 through an mbarrier
// pair (full: its four warps wrote it; empty: warpgroup 1's four read
// it), each stage of the ring is released by an arrival of each of the
// eight warps on its empty mbarrier, and thread 0 of warpgroup 1 (the
// later of the two, as it waits for P^T) refills it.
__global__ void __launch_bounds__(256, 2)
    bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap map,
                         const __grid_constant__ CUtensorMap g_map,
                         const __grid_constant__ CUtensorMap bias_map,
                         const float2* __restrict__ stats,
                         float* __restrict__ ds,
                         __nv_bfloat16* __restrict__ dqkv, int H, int W,
                         int C, int ws, int nB, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sic_tc::align1024(smem_raw);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + kB16Bar);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + 2;
  uint64_t* px_full = empty + 2;
  uint64_t* px_empty = px_full + 1;
  float4* px = reinterpret_cast<float4*>(smem + kB16Px);  // [8][128] float4

  const int s = ws * ws;
  const int n = s / kRows;
  const int head = blockIdx.x / n;
  const int k0 = (blockIdx.x % n) * kRows;
  const int win = blockIdx.y;
  const int b = blockIdx.z;
  const int nww = W / ws;
  const int x0 = (win % nww) * ws, y0 = (win / nww) * ws;
  const int64_t slab =
      ((int64_t)b * gridDim.y + win) * (gridDim.x / n) + head;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wtid = tid & 127;
  const int lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int r0 = (wtid >> 5) * 16 + gq;  // keys r0 and r0 + 8 of the tile

  auto stage = [&](int st) { return smem + kB16Ring + st * kB16Stage; };
  auto issue = [&](int it, int st) {
    uint8_t* sp = stage(st);
    const int i0 = it * kRows;
    sic_tc::mbar_expect_tx(&full[st], kB16Stage);
    sic_tc::tma_load_4d(sp + kB16Q, &map, &full[st], head * kHeadDim, x0,
                        y0 + i0 / ws, b);
    sic_tc::tma_load_4d(sp + kB16G, &g_map, &full[st], head * kHeadDim, x0,
                        y0 + i0 / ws, b);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sic_tc::tma_load_3d(sp + kB16Bias + h * kBoxBytes, &bias_map, &full[st],
                          k0 + h * 32, i0, win % nB);
  };

  if (tid == 0) {
    sic_tc::mbar_init(kvbar, 1);
    for (int i = 0; i < 2; ++i) {
      sic_tc::mbar_init(&full[i], 1);
      sic_tc::mbar_init(&empty[i], 8);  // every warp of the block
    }
    sic_tc::mbar_init(px_full, 4);      // warpgroup 0's warps
    sic_tc::mbar_init(px_empty, 4);     // warpgroup 1's warps
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sic_tc::fence_async_smem();
  }
  __syncthreads();
  if (tid == 0) {
    sic_tc::mbar_expect_tx(kvbar, 2 * kBoxBytes);
    sic_tc::tma_load_4d(smem + kB16K, &map, kvbar, C + head * kHeadDim, x0,
                        y0 + k0 / ws, b);
    sic_tc::tma_load_4d(smem + kB16V, &map, kvbar, 2 * C + head * kHeadDim, x0,
                        y0 + k0 / ws, b);
    for (int i = 0; i < 2 && i < n; ++i) issue(i, i);
  }
  // k (warpgroup 0) or v (1) as A fragments: step kk, registers (r0,
  // 16kk+2t..), (r0+8, 16kk+2t..), (r0, 16kk+8+2t..), (r0+8, 16kk+8+2t..)
  uint32_t af[16];
  sic_tc::mbar_wait(kvbar, 0);
  {
    const uint8_t* src = smem + (wg == 0 ? kB16K : kB16V);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + ((e & 1) ? 8 : 0);
        const int c = 16 * kk + 2 * t + ((e & 2) ? 8 : 0);
        af[4 * kk + e] =
            *reinterpret_cast<const uint32_t*>(src + sic_tc::swz16(r, c));
      }
    }
  }

  float acc[32];  // dv (warpgroup 0) or dk (warpgroup 1, before scale)
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  const float* srow0 = reinterpret_cast<const float*>(stats + slab * s);
  float* ds_slab = ds + slab * s * s;
  const float NEG_INF = -INFINITY;
  const float c = sic_tc::kLog2e;

  for (int it = 0; it < n; ++it) {
    const int i0 = it * kRows;
    const int st = it & 1;
    uint8_t* sp = stage(st);
    // this tile's lse (warpgroup 0, in base-2 units) or D (warpgroup 1) of
    // queries 8j + 2t and 8j + 2t + 1
    float stv[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 v4 = *reinterpret_cast<const float4*>(
          srow0 + 2 * (i0 + 8 * j + 2 * t));
      stv[2 * j] = wg == 0 ? v4.x * c : v4.y;
      stv[2 * j + 1] = wg == 0 ? v4.z * c : v4.w;
    }
    sic_tc::mbar_wait(&full[st], (it >> 1) & 1);

    // S^T = k q^T or dP^T = v g^T: rows keys, columns queries
    float x[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) x[e] = 0.f;
    const uint32_t b_a = sic_tc::smem_u32(sp + (wg == 0 ? kB16Q : kB16G));
    sic_tc::fence_regs(x);
    sic_tc::fence_regs(af);
    sic_tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sic_tc::wgmma_m64n64k16_bf16<0>(x, af[4 * kk], af[4 * kk + 1],
                                      af[4 * kk + 2], af[4 * kk + 3],
                                      sic_tc::desc_sw128(b_a + 32 * kk), kk != 0);
    sic_tc::wgmma_commit();
    sic_tc::wgmma_wait_all();
    sic_tc::fence_regs(x);
    sic_tc::fence_regs(af);

    // slot 4j+e holds key r0 + 8 (e >> 1), query 8j + 2t + (e & 1)
    if (wg == 0) {
      // P^T = 2^((S^T scale + bias^T) log2 e - lse log2 e); a -inf logit
      // gives 0
      const uint8_t* bias = sp + kB16Bias;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          const int kr = r0 + 8 * (e >> 1);
          const float v = fmaf(x[4 * j + e], scale,
                               *reinterpret_cast<const float*>(
                                   bias + sic_tc::swz(kRows, qc, kr)));
          x[4 * j + e] = (v == NEG_INF) ? 0.f
                                        : sic_tc::ex2(fmaf(v, c, -stv[2 * j + (e & 1)]));
        }
      }
      if (it > 0) sic_tc::mbar_wait(px_empty, (it - 1) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        px[j * 128 + wtid] =
            make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      __syncwarp();
      if (lane == 0) sic_tc::mbar_arrive(px_full);
    } else {
      // dS^T = P^T (dP^T - D), to the scratch as (query, key) rows
      sic_tc::mbar_wait(px_full, it & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p = px[j * 128 + wtid];
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          const int kr = r0 + 8 * (e >> 1);
          x[4 * j + e] = pv[e] * (x[4 * j + e] - stv[2 * j + (e & 1)]);
          ds_slab[(int64_t)(i0 + qc) * s + k0 + kr] = x[4 * j + e];
        }
      }
      __syncwarp();
      if (lane == 0) sic_tc::mbar_arrive(px_empty);
    }
    // dv += P^T g (warpgroup 0) or dk += dS^T q (warpgroup 1)
    mma16_rs_acc(acc, x, sic_tc::smem_u32(sp + (wg == 0 ? kB16G : kB16Q)));
    __syncwarp();
    if (lane == 0) sic_tc::mbar_arrive(&empty[st]);  // this warp is done with it
    if (tid == 128 && it + 2 < n) {
      sic_tc::mbar_wait(&empty[st], (it >> 1) & 1);
      sic_tc::fence_async_smem();  // the bias reads before the TMA overwrites
      issue(it + 2, st);
    }
  }

  // rows r0 and r0 + 8: the keys' dv (warpgroup 0) or dk (1), rounded once
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int key = k0 + r0 + 8 * row;
    __nv_bfloat16* out =
        dqkv + (((int64_t)b * H + y0 + key / ws) * W + x0 + key % ws) * 3 * C +
        (wg == 0 ? 2 * C : C) + head * kHeadDim;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sic_tc::store_pair(out + 8 * j + 2 * t, acc[4 * j + 2 * row] * mul,
                         acc[4 * j + 2 * row + 1] * mul);
  }
}

// The pass-3 block: a two-stage ring of (dS tile f32 16 KB, k tile bf16
// 8 KB), then two mbarriers.
constexpr int kDq16Stage = kTileBytes + kBoxBytes;
constexpr int kDq16Bar = 2 * kDq16Stage;
constexpr int kDq16Bytes = kDq16Bar + 16 + 1008;

// grid: x = head * nq + query tile, y = window, z = batch; 128 threads.
// dq = dS k scale: the dS rows as split register A fragments read from the
// f32 tile as it lands, k as the MN-major B tile.
__global__ void __launch_bounds__(128)
    bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap map,
                       const __grid_constant__ CUtensorMap ds_map,
                       __nv_bfloat16* __restrict__ dqkv, int H, int W, int C,
                       int ws, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sic_tc::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDq16Bar);

  const int s = ws * ws;
  const int n = s / kRows;
  const int head = blockIdx.x / n;
  const int i0 = (blockIdx.x % n) * kRows;
  const int win = blockIdx.y;
  const int b = blockIdx.z;
  const int nww = W / ws;
  const int x0 = (win % nww) * ws, y0 = (win / nww) * ws;
  const int slab =
      (int)(((int64_t)b * gridDim.y + win) * (gridDim.x / n) + head);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);  // queries r0, r0 + 8

  auto issue = [&](int kt, int st) {
    uint8_t* sp = smem + st * kDq16Stage;
    sic_tc::mbar_expect_tx(&full[st], kDq16Stage);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sic_tc::tma_load_3d(sp + h * kBoxBytes, &ds_map, &full[st],
                          kt * kRows + h * 32, i0, slab);
    sic_tc::tma_load_4d(sp + kTileBytes, &map, &full[st], C + head * kHeadDim,
                        x0, y0 + kt * kRows / ws, b);
  };

  sic_tc::init_bars(full, 2);
  if (tid == 0) {
    for (int i = 0; i < 2 && i < n; ++i) issue(i, i);
  }
  float dq[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dq[e] = 0.f;
  for (int kt = 0; kt < n; ++kt) {
    const int st = kt & 1;
    uint8_t* sp = smem + st * kDq16Stage;
    sic_tc::mbar_wait(&full[st], (kt >> 1) & 1);
    // dS rows r0, r0 + 8 of this key tile as hi and lo A fragments
    uint32_t hi[16], lo[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + ((e & 1) ? 8 : 0);
        const int c = 16 * kk + 2 * t + ((e & 2) ? 8 : 0);
        const float2 v =
            *reinterpret_cast<const float2*>(sp + sic_tc::swz(kRows, r, c));
        sic_tc::split_bf16(v.x, v.y, hi[4 * kk + e], lo[4 * kk + e]);
      }
    }
    const uint32_t k_a = sic_tc::smem_u32(sp + kTileBytes);
    float part[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) part[e] = 0.f;
    sic_tc::fence_regs(part);
    sic_tc::fence_regs(hi);
    sic_tc::fence_regs(lo);
    sic_tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sic_tc::wgmma_m64n64k16_bf16<1>(part, lo[4 * kk], lo[4 * kk + 1],
                                      lo[4 * kk + 2], lo[4 * kk + 3],
                                      sic_tc::desc_sw128(k_a + 2048 * kk), kk != 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sic_tc::wgmma_m64n64k16_bf16<1>(part, hi[4 * kk], hi[4 * kk + 1],
                                      hi[4 * kk + 2], hi[4 * kk + 3],
                                      sic_tc::desc_sw128(k_a + 2048 * kk), 1);
    sic_tc::wgmma_commit();
    sic_tc::wgmma_wait_all();
    sic_tc::fence_regs(part);
    sic_tc::fence_regs(hi);
    sic_tc::fence_regs(lo);
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[e] += part[e];
    __syncthreads();  // the stage is free
    if (tid == 0 && kt + 2 < n) {
      sic_tc::fence_async_smem();  // the dS reads before the TMA overwrites
      issue(kt + 2, st);
    }
  }

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int q = i0 + r0 + 8 * row;
    __nv_bfloat16* out =
        dqkv + (((int64_t)b * H + y0 + q / ws) * W + x0 + q % ws) * 3 * C +
        head * kHeadDim;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sic_tc::store_pair(out + 8 * j + 2 * t, dq[4 * j + 2 * row] * scale,
                         dq[4 * j + 2 * row + 1] * scale);
  }
}

// -- pass 4 -------------------------------------------------------------------

// dbias[nb, i, j] = sum over b, windows w (w == nb, or every w when
// nB == 1) and heads h of dS[b, w, h, i, j], in that fixed order.
__global__ void __launch_bounds__(256)
    bwd_dbias_kernel(const float* __restrict__ ds, float* __restrict__ dbias,
                     int B, int nW, int heads, int s, int nB) {
  const int64_t ss = (int64_t)s * s;
  const int64_t e = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= nB * ss) return;
  const int nb = (int)(e / ss);
  const int64_t ij = e % ss;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) {
    for (int w = (nB == 1 ? 0 : nb); w < (nB == 1 ? nW : nb + 1); ++w) {
      const float* slab = ds + (((int64_t)b * nW + w) * heads) * ss + ij;
      for (int h = 0; h < heads; ++h) acc += slab[h * ss];
    }
  }
  dbias[e] = acc;
}

template <typename T, int NWG>
int launch_stats(const CUtensorMap& map, const CUtensorMap& bias_map,
                 const T* g, float2* stats, int B, int H, int W, int C,
                 int heads, int ws, int nB, float scale, cudaStream_t st) {
  constexpr int bytes = sic_tc::alloc_bytes<T, NWG, true>();
  const int rc =
      sic_tc::allow_smem<bwd_stats_kernel<T, NWG>>(bytes, sic_tc::is_bf16<T>());
  if (rc != 0) return rc;
  const int ntiles = ws * ws / (NWG * sic_tc::kWgRows);
  const dim3 grid(heads * ntiles, (H / ws) * (W / ws), B);
  bwd_stats_kernel<T, NWG><<<grid, NWG * 128, bytes,
                             st>>>(
      map, bias_map, g, stats, H, W, C, ws, nB, scale);
  return (int)cudaGetLastError();
}

// T: the type of qkv, g and dqkv (f32: split TF32; bf16: the bf16 passes);
// bias, dbias and the scratch are f32 in both
template <typename T>
int run(const void* qkv, const void* bias, const void* g, void* dqkv,
        void* dbias, void* ds_scratch, void* stats_scratch, int B, int H,
        int W, int C, int heads, int ws, int nB, float scale, void* stream) {
  if (C != heads * kHeadDim || B <= 0 || ws < 8 || sic_tc::kBoxRows % ws ||
      H % ws || W % ws) {
    return (int)cudaErrorInvalidValue;
  }
  const int s = ws * ws;
  const int nW = (H / ws) * (W / ws);
  const long long slabs = (long long)B * nW * heads;
  if ((nB != 1 && nB != nW) || slabs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const void* bases[4] = {qkv, bias, g, ds_scratch};
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  CUtensorMap map, g_map, bias_map, ds_map;
  int rc = sic_tc::encode_window_map<T>(&map, qkv, 3 * C, W, H, B, ws);
  if (rc == 0) rc = sic_tc::encode_window_map<T>(&g_map, g, C, W, H, B, ws);
  if (rc == 0) rc = sic_tc::encode_square_map(&bias_map, bias, s, s, nB);
  if (rc == 0)
    rc = sic_tc::encode_square_map(&ds_map, ds_scratch, s, s, (int)slabs);
  if (rc != 0) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  const T* tg = (const T*)g;
  float* fds = (float*)ds_scratch;
  float2* fst = (float2*)stats_scratch;

  if constexpr (sic_tc::is_bf16<T>()) {  // 64-row blocks, three an SM
    rc = launch_stats<T, 1>(map, bias_map, tg, fst, B, H, W, C, heads, ws, nB,
                            scale, st);
  } else {
    rc = s % (2 * sic_tc::kWgRows) == 0
             ? launch_stats<T, 2>(map, bias_map, tg, fst, B, H, W, C, heads,
                                  ws, nB, scale, st)
             : launch_stats<T, 1>(map, bias_map, tg, fst, B, H, W, C, heads,
                                  ws, nB, scale, st);
  }
  if (rc != 0) return rc;

  const dim3 grid(heads * (s / kRows), nW, B);
  if constexpr (std::is_same<T, float>::value) {
    rc = sic_tc::allow_smem<bwd_dkdv_kernel>(kDkdvBytes);
    if (rc != 0) return rc;
    bwd_dkdv_kernel<<<grid, 256, kDkdvBytes, st>>>(
        map, g_map, bias_map, fst, fds, (float*)dqkv, H, W, C, ws, nB, scale);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;

    rc = sic_tc::allow_smem<bwd_dq_kernel>(kDqBytes);
    if (rc != 0) return rc;
    bwd_dq_kernel<<<grid, 128, kDqBytes, st>>>(map, ds_map, (float*)dqkv, H,
                                               W, C, ws, scale);
  } else {
    rc = sic_tc::allow_smem<bwd_dkdv_bf16_kernel>(kDkdv16Bytes, true);
    if (rc != 0) return rc;
    bwd_dkdv_bf16_kernel<<<grid, 256, kDkdv16Bytes, st>>>(
        map, g_map, bias_map, fst, fds, (__nv_bfloat16*)dqkv, H, W, C, ws, nB,
        scale);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;

    rc = sic_tc::allow_smem<bwd_dq_bf16_kernel>(kDq16Bytes, true);
    if (rc != 0) return rc;
    bwd_dq_bf16_kernel<<<grid, 128, kDq16Bytes, st>>>(
        map, ds_map, (__nv_bfloat16*)dqkv, H, W, C, ws, scale);
  }
  if ((rc = (int)cudaGetLastError()) != 0) return rc;

  const int64_t n = (int64_t)nB * s * s;
  bwd_dbias_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      fds, (float*)dbias, B, nW, heads, s, nB);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 qkv, g and dqkv (split TF32)
extern "C" int sic_window_attention_bwd(const void* qkv, const void* bias,
                                        const void* g, void* dqkv, void* dbias,
                                        void* ds_scratch, void* stats_scratch,
                                        int B, int H, int W, int C, int heads,
                                        int ws, int nB, float scale,
                                        void* stream) {
  return run<float>(qkv, bias, g, dqkv, dbias, ds_scratch, stats_scratch, B,
                    H, W, C, heads, ws, nB, scale, stream);
}

// bf16 qkv, g and dqkv (bf16 tensor cores, f32 accumulation and softmax);
// bias and dbias f32
extern "C" int sic_window_attention_bwd_bf16(
    const void* qkv, const void* bias, const void* g, void* dqkv, void* dbias,
    void* ds_scratch, void* stats_scratch, int B, int H, int W, int C,
    int heads, int ws, int nB, float scale, void* stream) {
  return run<__nv_bfloat16>(qkv, bias, g, dqkv, dbias, ds_scratch,
                            stats_scratch, B, H, W, C, heads, ws, nB, scale,
                            stream);
}
