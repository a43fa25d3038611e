// GroupNorm over the channel axis of a contiguous NHWC tensor, optionally
// followed by SiLU, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm and swish to
// XLA, which fuses them.  In eager PyTorch the same function took an f32
// copy, a layout copy to NCHW, a moments pass, an affine pass, a cast back
// (NCHW-strided) and a SiLU pass, then cuDNN transposed the result back to
// NHWC for the next convolution: about 40 bytes moved an element.  The
// flagship's VQGAN decoder runs it 39 times a decode (35 times with SiLU),
// the MaskGIT-VQGAN pixel decoder in f32 after every resnet half.
//
// What bounds it on the H100: bytes.  A few operations an element against
// 6 bytes an element in bf16 (read, read again, write) and 12 in f32, at
// 3.35 TB/s.  The design moves nothing else:
//   * stats pass, grid (S chunks, B images): a block walks a contiguous
//     run of P pixels x all C channels with 16-byte loads, neighbouring
//     threads on neighbouring vectors (a thread keeps one vector column,
//     rows = 256 / (C / vector) pixels apart), four loads in flight a
//     thread.  Each vector's share of a group gives its exact mean and M2,
//     merged into the thread's running (mean, M2) by Chan's formula (one
//     correctly rounded reciprocal a step, no raw sum of squares: a group
//     at 512x512 holds millions of elements).  The block merges its
//     threads' partials in shared memory in a fixed order and writes
//     (n, mean, M2) for each group to [B, S, G, 3];
//   * apply pass, the same grid: a block merges its image's S partials
//     in a fixed order (a few lanes a group, then a shuffle tree), folds mean, rstd, gamma and beta into a scale and a
//     shift a channel (f32), then writes silu(x * a + b) (or x * a + b),
//     rounded once to the element type, with 16-byte stores;
//   * no atomics: the same input gives the same bits on every run.
// The chunking (S, P) is the wrapper's (ops/group_norm.py): about four
// blocks an SM a pass, at least 16K elements a block, at most 128 partials
// an image to merge.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&f)[N]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&f)[N]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 is the top half of an f32: widening is a shift
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&f)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Chan's merge of the partial (nb, mb, Mb) into (n, m, M)
__device__ __forceinline__ void merge(float& n, float& m, float& M, float nb,
                                      float mb, float Mb) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - m;
  const float w = nb / nn;
  m = fmaf(d, w, m);
  M += fmaf(d * d * n, w, Mb);
  n = nn;
}

// One vector into the thread's NACC running partials: step i (i vectors
// merged before, each K elements of a group an accumulator).
template <int N, int NACC>
__device__ __forceinline__ void accumulate(const float (&f)[N], int i,
                                           float (&mean)[NACC],
                                           float (&m2)[NACC]) {
  constexpr int K = N / NACC;
  const float r = __frcp_rn(static_cast<float>(i + 1));
  const float kw = K * (1.f - r);  // n_a n_b / n over d^2, per K elements
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < K; ++e) s += f[a * K + e];
    const float mb = s * (1.f / K);  // K is a power of two: exact
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < K; ++e) {
      const float d = f[a * K + e] - mb;
      q = fmaf(d, d, q);
    }
    const float d = mb - mean[a];
    mean[a] = fmaf(d, r, mean[a]);
    m2[a] += fmaf(d * d, kw, q);
  }
}

template <typename T, int NACC>
__global__ void __launch_bounds__(kThreads)
    gn_stats(const T* __restrict__ x, float* __restrict__ part, int HW, int C,
             int G, int S, int P) {
  constexpr int N = Vec<T>::N;
  constexpr int K = N / NACC;
  __shared__ float sh_n[kThreads * NACC];
  __shared__ float sh_mean[kThreads * NACC];
  __shared__ float sh_m2[kThreads * NACC];
  const int b = blockIdx.y, s = blockIdx.x, t = threadIdx.x;
  const int nv = C / N, rows = kThreads / nv;
  const int col = t % nv, row = t / nv;
  const int p0 = s * P, p1 = min(p0 + P, HW);
  float mean[NACC], m2[NACC];
#pragma unroll
  for (int a = 0; a < NACC; ++a) mean[a] = m2[a] = 0.f;
  int steps = 0;
  if (row < rows) {
    const T* base = x + static_cast<size_t>(b) * HW * C + col * N;
    int p = p0 + row;
    for (; p + 3 * rows < p1; p += 4 * rows) {
      float f[4][N];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        Vec<T>::load(base + static_cast<size_t>(p + u * rows) * C, f[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) accumulate<N, NACC>(f[u], steps++, mean, m2);
    }
    for (; p < p1; p += rows) {
      float f[N];
      Vec<T>::load(base + static_cast<size_t>(p) * C, f);
      accumulate<N, NACC>(f, steps++, mean, m2);
    }
  }
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    sh_n[t * NACC + a] = static_cast<float>(steps * K);
    sh_mean[t * NACC + a] = mean[a];
    sh_m2[t * NACC + a] = m2[a];
  }
  __syncthreads();
  for (int g = t; g < G; g += kThreads) {
    float n = 0.f, m = 0.f, M = 0.f;
    if (NACC == 1) {  // a group spans vpg whole vectors of a row
      const int vpg = C / G / N;
      for (int r = 0; r < rows; ++r)
        for (int j = 0; j < vpg; ++j) {
          const int i = r * nv + g * vpg + j;
          merge(n, m, M, sh_n[i], sh_mean[i], sh_m2[i]);
        }
    } else {  // a vector holds NACC groups, one an accumulator
      const int v = g / NACC, a = g % NACC;
      for (int r = 0; r < rows; ++r) {
        const int i = (r * nv + v) * NACC + a;
        merge(n, m, M, sh_n[i], sh_mean[i], sh_m2[i]);
      }
    }
    float* o = part + ((static_cast<size_t>(b) * S + s) * G + g) * 3;
    o[0] = n;
    o[1] = m;
    o[2] = M;
  }
}

// PyTorch's formula in f32 with the hardware's exp2 and reciprocal (a few
// ulps of f32): the IEEE expf and division made the bf16 apply pass bound
// by instructions, not bytes.  y -> -inf gives -0.
__device__ __forceinline__ float silu(float y) {
  return __fdividef(y, 1.f + __expf(-y));
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads)
    gn_apply(const T* __restrict__ x, const float* __restrict__ part,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             T* __restrict__ y, int HW, int C, int G, int S, int P, float eps) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float sh[];  // scale[C], shift[C], mean[G], rstd[G]
  float* sa = sh;
  float* sb = sa + C;
  float* smean = sb + C;
  float* srstd = smean + G;
  const int b = blockIdx.y, s = blockIdx.x, t = threadIdx.x;
  // each group's S partials, merged by tpg neighbouring lanes (chunks j,
  // j + tpg, ...), then across those lanes in a fixed tree: every block of
  // the image gets the same bits
  int tpg = 1;
  while (tpg < 32 && 2 * tpg * G <= kThreads) tpg *= 2;
  const int j = t % tpg;
  for (int g0 = 0; g0 < G; g0 += kThreads / tpg) {
    const int g = g0 + t / tpg;
    float n = 0.f, m = 0.f, M = 0.f;
    if (g < G) {
      const float* q = part + (static_cast<size_t>(b) * S * G + g) * 3;
#pragma unroll 4
      for (int c = j; c < S; c += tpg) {
        const float* r = q + static_cast<size_t>(c) * G * 3;
        merge(n, m, M, r[0], r[1], r[2]);
      }
    }
    for (int off = tpg / 2; off > 0; off /= 2) {
      const float n2 = __shfl_down_sync(0xffffffffu, n, off);
      const float m2 = __shfl_down_sync(0xffffffffu, m, off);
      const float M2 = __shfl_down_sync(0xffffffffu, M, off);
      if (j < off) merge(n, m, M, n2, m2, M2);
    }
    if (g < G && j == 0) {
      smean[g] = m;
      srstd[g] = 1.f / sqrtf(fmaxf(M / n, 0.f) + eps);  // biased variance
    }
  }
  __syncthreads();
  const int cpg = C / G;
  for (int c = t; c < C; c += kThreads) {
    const int g = c / cpg;
    const float a = srstd[g] * gamma[c];
    sa[c] = a;
    sb[c] = fmaf(-a, smean[g], beta[c]);
  }
  __syncthreads();
  const int nv = C / N, rows = kThreads / nv;
  const int col = t % nv, row = t / nv;
  if (row >= rows) return;
  float a[N], shift[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    a[e] = sa[col * N + e];
    shift[e] = sb[col * N + e];
  }
  const int p0 = s * P, p1 = min(p0 + P, HW);
  const size_t off = static_cast<size_t>(b) * HW * C + col * N;
  const T* xb = x + off;
  T* yb = y + off;
  int p = p0 + row;
  for (; p + 3 * rows < p1; p += 4 * rows) {
    float f[4][N];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      Vec<T>::load(xb + static_cast<size_t>(p + u * rows) * C, f[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float v = fmaf(f[u][e], a[e], shift[e]);
        f[u][e] = SILU ? silu(v) : v;
      }
      Vec<T>::store(yb + static_cast<size_t>(p + u * rows) * C, f[u]);
    }
  }
  for (; p < p1; p += rows) {
    float f[N];
    Vec<T>::load(xb + static_cast<size_t>(p) * C, f);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float v = fmaf(f[e], a[e], shift[e]);
      f[e] = SILU ? silu(v) : v;
    }
    Vec<T>::store(yb + static_cast<size_t>(p) * C, f);
  }
}

template <typename T, int NACC>
void launch_stats(const T* x, float* part, int B, int HW, int C, int G, int S,
                  int P, cudaStream_t st) {
  if constexpr (NACC <= Vec<T>::N)
    gn_stats<T, NACC><<<dim3(S, B), kThreads, 0, st>>>(x, part, HW, C, G, S, P);
}

template <typename T>
int run(const void* xv, const float* gamma, const float* beta, void* yv,
        float* part, int B, int HW, int C, int G, int S, int P, float eps,
        int silu, void* stream) {
  constexpr int N = Vec<T>::N;
  // the wrapper refuses these first; a bad call never launches
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || G <= 0 || C % G ||
      C % N || C / N > kThreads || S <= 0 || P <= 0 ||
      static_cast<long long>(S) * P < HW ||
      static_cast<long long>(S - 1) * P >= HW)
    return cudaErrorInvalidValue;
  const int cpg = C / G;
  const int nacc = cpg % N == 0 ? 1 : (N % cpg == 0 ? N / cpg : 0);
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nacc) {
    case 1: launch_stats<T, 1>(x, part, B, HW, C, G, S, P, st); break;
    case 2: launch_stats<T, 2>(x, part, B, HW, C, G, S, P, st); break;
    case 4: launch_stats<T, 4>(x, part, B, HW, C, G, S, P, st); break;
    case 8: launch_stats<T, 8>(x, part, B, HW, C, G, S, P, st); break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (2 * static_cast<size_t>(C) + 2 * G) * sizeof(float);
  if (silu)
    gn_apply<T, true><<<dim3(S, B), kThreads, smem, st>>>(
        x, part, gamma, beta, y, HW, C, G, S, P, eps);
  else
    gn_apply<T, false><<<dim3(S, B), kThreads, smem, st>>>(
        x, part, gamma, beta, y, HW, C, G, S, P, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: (B, HW, C) contiguous NHWC f32; gamma, beta: (C,) f32; part:
// (B, S, G, 3) f32 scratch.  Returns a cudaError_t (0: both passes launched).
extern "C" int sic_group_norm(const void* x, const float* gamma,
                              const float* beta, void* y, float* part, int B,
                              int HW, int C, int G, int S, int P, float eps,
                              int silu, void* stream) {
  return run<float>(x, gamma, beta, y, part, B, HW, C, G, S, P, eps, silu,
                    stream);
}

// bf16 x and y; statistics, affine and SiLU in f32, the output rounded once
extern "C" int sic_group_norm_bf16(const void* x, const float* gamma,
                                   const float* beta, void* y, float* part,
                                   int B, int HW, int C, int G, int S, int P,
                                   float eps, int silu, void* stream) {
  return run<__nv_bfloat16>(x, gamma, beta, y, part, B, HW, C, G, S, P, eps,
                            silu, stream);
}
