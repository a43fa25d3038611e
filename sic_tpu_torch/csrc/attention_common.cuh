// Body of the (G, s, d) window attention (kernel 6), on the f32 CUDA
// cores.  The sequence and NHWC window kernels run on the tensor cores
// (attention_tc.cuh).
//
// One thread block computes one (sequence or window, head, 64-query tile):
// softmax(q * scale . k^T + bias) v with f32 logits and an online softmax,
// reading q, k and v through three base pointers and one row-address
// functor (for the packed [q | k | v] projection the three bases are the
// same buffer offset by 0, C and 2C channels; for separate q, k, v tensors
// they are the three tensors) and writing the head-major output in place.
// Nothing but the inputs and the output touches device memory.
//
// Layout of the work inside a block (256 threads, head dim 64):
//   * thread t owns query row r = t / 4 of the tile and column group
//     g = t % 4; its query row (pre-scaled) lives in 64 registers;
//   * per 32-key tile, K and V are staged in shared memory; the thread
//     computes the 8 logits of keys g, g+4, ..., g+28, the row max and sum
//     are reduced over the 4 threads of the row with warp shuffles, and
//     the probabilities go through shared memory so that each thread can
//     accumulate its 16 output dims g, g+4, ..., g+60 over all 32 keys;
//   * K and P rows are padded by one float, so the strided reads hit 32
//     distinct banks.
// Rows past the sequence end and keys masked to -inf are handled by the
// -inf guard: while a row has seen only -inf logits its running max stays
// -inf and the exponentials are taken against 0, never as -inf - -inf.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sic {

constexpr int kHeadDim = 64;
constexpr int kQueryTile = 64;
constexpr int kKeyTile = 32;
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kQueryTile;          // threads per query row
constexpr int kKeysPerThread = kKeyTile / kGroups;      // 8
constexpr int kDimsPerThread = kHeadDim / kGroups;      // 16

// rows.qkv(t): float offset of token t's row from each of qb, kb and vb;
// rows.out(t): float offset of token t's output row.
template <class Rows>
__device__ __forceinline__ void attend_tile(
    const float* __restrict__ qb, const float* __restrict__ kb,
    const float* __restrict__ vb, float* __restrict__ out, const Rows& rows,
    int n, int head, float scale, const float* __restrict__ bias, int q0) {
  __shared__ float ks[kKeyTile][kHeadDim + 1];
  __shared__ __align__(16) float vs[kKeyTile][kHeadDim];
  __shared__ float ps[kQueryTile][kKeyTile + 1];

  const int tid = threadIdx.x;
  const int r = tid / kGroups;
  const int g = tid % kGroups;
  const int qi = q0 + r;
  const bool qvalid = qi < n;
  const int qrow = qvalid ? qi : n - 1;
  const float NEG_INF = -INFINITY;

  float q[kHeadDim];
  {
    const float4* qp = reinterpret_cast<const float4*>(
        qb + rows.qkv(qrow) + head * kHeadDim);
#pragma unroll
    for (int i = 0; i < kHeadDim / 4; ++i) {
      const float4 v = qp[i];
      q[4 * i + 0] = v.x * scale;
      q[4 * i + 1] = v.y * scale;
      q[4 * i + 2] = v.z * scale;
      q[4 * i + 3] = v.w * scale;
    }
  }
  const float* brow = bias ? bias + (int64_t)qrow * n : nullptr;

  float o[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) o[j] = 0.f;
  float m = NEG_INF;
  float l = 0.f;

  for (int k0 = 0; k0 < n; k0 += kKeyTile) {
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    for (int e = tid; e < kKeyTile * kHeadDim / 4; e += kThreads) {
      const int kr = e / (kHeadDim / 4);
      const int c4 = e % (kHeadDim / 4);
      const int kj = k0 + kr;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (kj < n) {
        const int64_t off = rows.qkv(kj) + head * kHeadDim + 4 * c4;
        kv = *reinterpret_cast<const float4*>(kb + off);
        vv = *reinterpret_cast<const float4*>(vb + off);
      }
      ks[kr][4 * c4 + 0] = kv.x;
      ks[kr][4 * c4 + 1] = kv.y;
      ks[kr][4 * c4 + 2] = kv.z;
      ks[kr][4 * c4 + 3] = kv.w;
      *reinterpret_cast<float4*>(&vs[kr][4 * c4]) = vv;
    }
    __syncthreads();

    float s[kKeysPerThread];
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int kk = g + kGroups * j;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) acc = fmaf(q[d], ks[kk][d], acc);
      const int kj = k0 + kk;
      if (kj >= n) {
        acc = NEG_INF;
      } else if (brow) {
        acc += brow[kj];
      }
      s[j] = acc;
      tile_max = fmaxf(tile_max, acc);
    }
    // the kGroups threads of a row are adjacent lanes of one warp
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float m_use = (m_new == NEG_INF) ? 0.f : m_new;
    const float alpha = expf(m - m_use);  // 0 while m is still -inf
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const float p = expf(s[j] - m_use);
      ps[r][g + kGroups * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) o[j] *= alpha;
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kKeyTile; ++kk) {
      const float p = ps[r][kk];
#pragma unroll
      for (int j = 0; j < kDimsPerThread; ++j)
        o[j] = fmaf(p, vs[kk][g + kGroups * j], o[j]);
    }
  }

  if (qvalid) {
    const float inv = 1.f / l;
    float* orow = out + rows.out(qi) + head * kHeadDim;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) orow[g + kGroups * j] = o[j] * inv;
  }
}

}  // namespace sic
