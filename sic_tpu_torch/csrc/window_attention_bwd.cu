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
// The TPU kernel walked its grid in order and carried dbias in VMEM across
// the batch.  Here blocks run in parallel in no fixed order, and a full
// s x s f32 probability matrix (256 KB at s = 256) does not fit in shared
// memory, so the work is four passes, each a plain loop over tiles, with no
// float atomics (the result is the same on every run):
//
//   1. stats:  per (window, head, 64-query tile) the row log-sum-exp of the
//              logits and D_i = sum_j P_ij dP_ij (dP = g . v^T), one online
//              sweep over 32-key tiles, the forward kernel's -inf guard;
//   2. dk, dv: per (window, head, 64-key tile) a sweep over 32-query tiles
//              that recomputes P_ij = exp(S_ij - lse_i) and
//              dS_ij = P_ij (dP_ij - D_i), accumulates dv_j += P_ij g_i and
//              dk_j += dS_ij q_i in registers, and writes dS to scratch;
//   3. dq:     per (window, head, 64-query tile) dq_i = sum_j dS_ij k_j from
//              the scratch;
//   4. dbias:  one thread per bias element sums the scratch over batch,
//              heads (and windows) in a fixed order.
//
// Scratch (allocated by the wrapper): dS as (B, nW, heads, s, s) f32 and the
// row stats as (B, nW, heads, s) float2.  q, k, v and g are read straight
// from NHWC through the token -> (row, column) map of the forward kernel
// (csrc/window_attention.cu), so no window partition or head split is
// written to device memory.
//
// What bounds it on the H100: about 10 * s * s * d flops per (window,
// head) -- logits twice, g . v^T twice, and the three products for dq, dk,
// dv -- against 28 bytes per token and channel read or written, so it is
// compute-bound at the 67 TFLOP/s of the f32 CUDA cores (no tensor cores
// in this first version).  The dS scratch (4 * s * s bytes per window and
// head) is extra device-memory traffic the TPU kernel did not have; it buys
// a deterministic dq and dbias without atomics.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kThreads = 256;
constexpr int kRowTile = 64;                        // rows a block owns
constexpr int kInnerTile = 32;                      // rows staged per sweep step
constexpr int kGroups = kThreads / kRowTile;        // threads per owned row
constexpr int kPerThread = kInnerTile / kGroups;    // 8
constexpr int kDims = kHeadDim / kGroups;           // 16
constexpr int kPad = kHeadDim + 1;                  // padded smem row

struct Window {
  int64_t pix0;  // pixel index of the window's top-left token
  int W;         // map width in pixels
  int ws;        // window side
  __device__ __forceinline__ int64_t pix(int t) const {
    return pix0 + (int64_t)(t / ws) * W + (t % ws);
  }
};

struct Block {
  int head, tile, win, b, heads, nW, s;
  Window w;
  int64_t slab;  // (b, win, head) index into the scratch
};

__device__ __forceinline__ Block block_of(int H, int W, int ws) {
  Block k;
  k.s = ws * ws;
  const int ntiles = k.s / kRowTile;
  k.head = blockIdx.x / ntiles;
  k.tile = blockIdx.x % ntiles;
  k.heads = gridDim.x / ntiles;
  k.win = blockIdx.y;
  k.nW = gridDim.y;
  k.b = blockIdx.z;
  const int nww = W / ws;
  k.w = Window{((int64_t)k.b * H + (int64_t)(k.win / nww) * ws) * W +
                   (k.win % nww) * ws,
               W, ws};
  k.slab = ((int64_t)k.b * k.nW + k.win) * k.heads + k.head;
  return k;
}

__device__ __forceinline__ void load_row(float* dst, const float* src,
                                         float mul) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < kHeadDim / 4; ++i) {
    const float4 v = p[i];
    dst[4 * i + 0] = v.x * mul;
    dst[4 * i + 1] = v.y * mul;
    dst[4 * i + 2] = v.z * mul;
    dst[4 * i + 3] = v.w * mul;
  }
}

// Stage kInnerTile rows of two head slices into padded shared memory:
// a from `a_base + a_off`, b from `b_base + b_off` of each token's row.
__device__ __forceinline__ void stage_rows(
    float (*as)[kPad], float (*bs)[kPad], const float* __restrict__ a_base,
    int a_stride, int a_off, const float* __restrict__ b_base, int b_stride,
    int b_off, const Window& w, int r0) {
  for (int e = threadIdx.x; e < kInnerTile * kHeadDim / 4; e += kThreads) {
    const int r = e / (kHeadDim / 4);
    const int c4 = e % (kHeadDim / 4);
    const int64_t p = w.pix(r0 + r);
    const float4 av = *reinterpret_cast<const float4*>(
        a_base + p * a_stride + a_off + 4 * c4);
    const float4 bv = *reinterpret_cast<const float4*>(
        b_base + p * b_stride + b_off + 4 * c4);
    as[r][4 * c4 + 0] = av.x;
    as[r][4 * c4 + 1] = av.y;
    as[r][4 * c4 + 2] = av.z;
    as[r][4 * c4 + 3] = av.w;
    bs[r][4 * c4 + 0] = bv.x;
    bs[r][4 * c4 + 1] = bv.y;
    bs[r][4 * c4 + 2] = bv.z;
    bs[r][4 * c4 + 3] = bv.w;
  }
}

__device__ __forceinline__ float dot_row(const float* reg, const float* row) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc = fmaf(reg[d], row[d], acc);
  return acc;
}

// Pass 1. grid: x = head * ntiles + query tile, y = window, z = batch.
__global__ void __launch_bounds__(kThreads)
    bwd_stats_kernel(const float* __restrict__ qkv,
                     const float* __restrict__ bias,
                     const float* __restrict__ g, float2* __restrict__ stats,
                     int H, int W, int C, int ws, int nB, float scale) {
  __shared__ float ks[kInnerTile][kPad];
  __shared__ float vs[kInnerTile][kPad];
  const Block k = block_of(H, W, ws);
  const int tid = threadIdx.x;
  const int r = tid / kGroups;
  const int grp = tid % kGroups;
  const int qi = k.tile * kRowTile + r;
  const int64_t p = k.w.pix(qi);
  const float NEG_INF = -INFINITY;

  float q[kHeadDim], go[kHeadDim];
  load_row(q, qkv + p * 3 * C + k.head * kHeadDim, scale);
  load_row(go, g + p * C + k.head * kHeadDim, 1.f);
  const float* brow = bias + (int64_t)(k.win % nB) * k.s * k.s + (int64_t)qi * k.s;

  float m = NEG_INF, l = 0.f, dacc = 0.f;
  for (int k0 = 0; k0 < k.s; k0 += kInnerTile) {
    __syncthreads();  // the previous step's readers are done with ks/vs
    stage_rows(ks, vs, qkv, 3 * C, C + k.head * kHeadDim, qkv, 3 * C,
               2 * C + k.head * kHeadDim, k.w, k0);
    __syncthreads();
    float sv[kPerThread], dp[kPerThread];
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int kk = grp + kGroups * j;
      sv[j] = dot_row(q, ks[kk]) + brow[k0 + kk];
      dp[j] = dot_row(go, vs[kk]);
      tile_max = fmaxf(tile_max, sv[j]);
    }
    // the kGroups threads of a row are adjacent lanes of one warp
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float m_use = (m_new == NEG_INF) ? 0.f : m_new;
    const float alpha = expf(m - m_use);  // 0 while m is still -inf
    float psum = 0.f, pdsum = 0.f;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const float pj = expf(sv[j] - m_use);
      psum += pj;
      pdsum = fmaf(pj, dp[j], pdsum);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    pdsum += __shfl_xor_sync(0xffffffffu, pdsum, 1);
    pdsum += __shfl_xor_sync(0xffffffffu, pdsum, 2);
    l = l * alpha + psum;
    dacc = dacc * alpha + pdsum;
    m = m_new;
  }
  if (grp == 0) {
    stats[k.slab * k.s + qi] = make_float2(m + logf(l), dacc / l);
  }
}

// Pass 2. grid: x = head * ntiles + key tile, y = window, z = batch.
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv_kernel(const float* __restrict__ qkv,
                    const float* __restrict__ bias,
                    const float* __restrict__ g,
                    const float2* __restrict__ stats, float* __restrict__ ds,
                    float* __restrict__ dqkv, int H, int W, int C, int ws,
                    int nB, float scale) {
  __shared__ float qs[kInnerTile][kPad];
  __shared__ float gs[kInnerTile][kPad];
  __shared__ float ps[kInnerTile][kPad];
  __shared__ float dss[kInnerTile][kPad];
  __shared__ float2 st[kInnerTile];
  const Block k = block_of(H, W, ws);
  const int tid = threadIdx.x;
  const int r = tid / kGroups;
  const int grp = tid % kGroups;
  const int kj = k.tile * kRowTile + r;
  const int64_t p = k.w.pix(kj);

  float kr[kHeadDim], vr[kHeadDim];
  load_row(kr, qkv + p * 3 * C + C + k.head * kHeadDim, 1.f);
  load_row(vr, qkv + p * 3 * C + 2 * C + k.head * kHeadDim, 1.f);
  float dk[kDims], dv[kDims];
#pragma unroll
  for (int j = 0; j < kDims; ++j) dk[j] = dv[j] = 0.f;
  const float* wbias = bias + (int64_t)(k.win % nB) * k.s * k.s;
  float* ds_slab = ds + k.slab * k.s * k.s;

  for (int i0 = 0; i0 < k.s; i0 += kInnerTile) {
    __syncthreads();  // the previous step's readers are done with the tiles
    stage_rows(qs, gs, qkv, 3 * C, k.head * kHeadDim, g, C,
               k.head * kHeadDim, k.w, i0);
    if (tid < kInnerTile) st[tid] = stats[k.slab * k.s + i0 + tid];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = grp + kGroups * j;
      const float logit =
          dot_row(kr, qs[i]) * scale + wbias[(int64_t)(i0 + i) * k.s + kj];
      const float2 sti = st[i];
      const float pij = expf(logit - sti.x);  // 0 where the bias is -inf
      const float dpij = dot_row(vr, gs[i]);
      ps[i][r] = pij;
      dss[i][r] = pij * (dpij - sti.y);
    }
    __syncthreads();
    // dS rows i0..i0+31, columns of this key tile, to the scratch (coalesced)
    for (int e = tid; e < kInnerTile * kRowTile; e += kThreads) {
      const int i = e / kRowTile;
      const int c = e % kRowTile;
      ds_slab[(int64_t)(i0 + i) * k.s + k.tile * kRowTile + c] = dss[i][c];
    }
#pragma unroll 4
    for (int i = 0; i < kInnerTile; ++i) {
      const float pij = ps[i][r];
      const float dsij = dss[i][r];
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        const int d = grp + kGroups * j;
        dv[j] = fmaf(pij, gs[i][d], dv[j]);
        dk[j] = fmaf(dsij, qs[i][d], dk[j]);
      }
    }
  }
  float* out = dqkv + p * 3 * C + k.head * kHeadDim;
#pragma unroll
  for (int j = 0; j < kDims; ++j) {
    const int d = grp + kGroups * j;
    out[C + d] = dk[j] * scale;
    out[2 * C + d] = dv[j];
  }
}

// Pass 3. grid: x = head * ntiles + query tile, y = window, z = batch.
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ ds,
                  float* __restrict__ dqkv, int H, int W, int C, int ws,
                  float scale) {
  __shared__ __align__(16) float ks[kInnerTile][kHeadDim];
  __shared__ float dsr[kRowTile][kInnerTile + 1];
  const Block k = block_of(H, W, ws);
  const int tid = threadIdx.x;
  const int r = tid / kGroups;
  const int grp = tid % kGroups;
  const int qi = k.tile * kRowTile + r;
  const float* ds_rows = ds + k.slab * k.s * k.s + (int64_t)k.tile * kRowTile * k.s;

  float dq[kDims];
#pragma unroll
  for (int j = 0; j < kDims; ++j) dq[j] = 0.f;
  for (int k0 = 0; k0 < k.s; k0 += kInnerTile) {
    __syncthreads();
    for (int e = tid; e < kInnerTile * kHeadDim / 4; e += kThreads) {
      const int kr = e / (kHeadDim / 4);
      const int c4 = e % (kHeadDim / 4);
      *reinterpret_cast<float4*>(&ks[kr][4 * c4]) =
          *reinterpret_cast<const float4*>(qkv + k.w.pix(k0 + kr) * 3 * C + C +
                                           k.head * kHeadDim + 4 * c4);
    }
    for (int e = tid; e < kRowTile * kInnerTile; e += kThreads) {
      const int i = e / kInnerTile;
      const int c = e % kInnerTile;
      dsr[i][c] = ds_rows[(int64_t)i * k.s + k0 + c];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kInnerTile; ++kk) {
      const float dsij = dsr[r][kk];
#pragma unroll
      for (int j = 0; j < kDims; ++j)
        dq[j] = fmaf(dsij, ks[kk][grp + kGroups * j], dq[j]);
    }
  }
  float* out = dqkv + k.w.pix(qi) * 3 * C + k.head * kHeadDim;
#pragma unroll
  for (int j = 0; j < kDims; ++j) out[grp + kGroups * j] = dq[j] * scale;
}

// Pass 4: dbias[nb, i, j] = sum over b, windows w (w == nb, or every w when
// nB == 1) and heads h of dS[b, w, h, i, j], in that fixed order.
__global__ void __launch_bounds__(kThreads)
    bwd_dbias_kernel(const float* __restrict__ ds, float* __restrict__ dbias,
                     int B, int nW, int heads, int s, int nB) {
  const int64_t ss = (int64_t)s * s;
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
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

}  // namespace

extern "C" int sic_window_attention_bwd(const void* qkv, const void* bias,
                                        const void* g, void* dqkv, void* dbias,
                                        void* ds_scratch, void* stats_scratch,
                                        int B, int H, int W, int C, int heads,
                                        int ws, int nB, float scale,
                                        void* stream) {
  if (C != heads * kHeadDim || ws <= 0 || H % ws || W % ws ||
      (ws * ws) % kRowTile) {
    return (int)cudaErrorInvalidValue;
  }
  const int s = ws * ws;
  const int nW = (H / ws) * (W / ws);
  if (nB != 1 && nB != nW) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(heads * (s / kRowTile), nW, B);
  const float* fq = (const float*)qkv;
  const float* fb = (const float*)bias;
  const float* fg = (const float*)g;
  float* fds = (float*)ds_scratch;
  float2* fst = (float2*)stats_scratch;
  cudaError_t err;
  bwd_stats_kernel<<<grid, kThreads, 0, st>>>(fq, fb, fg, fst, H, W, C, ws,
                                              nB, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_dkdv_kernel<<<grid, kThreads, 0, st>>>(fq, fb, fg, fst, fds,
                                             (float*)dqkv, H, W, C, ws, nB,
                                             scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_dq_kernel<<<grid, kThreads, 0, st>>>(fq, fds, (float*)dqkv, H, W, C, ws,
                                           scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)nB * s * s;
  bwd_dbias_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     st>>>(fds, (float*)dbias, B, nW, heads, s, nB);
  return (int)cudaGetLastError();
}
