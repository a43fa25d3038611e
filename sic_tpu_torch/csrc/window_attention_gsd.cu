// Window attention over separate (G, s, d) q, k, v tensors, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel sic_tpu/ops/window_attention.py::_attention_kernel
// (launcher _pallas_forward): for every window-head g of G,
// softmax(q[g] * scale . k[g]^T + bias[g % nW]) v[g], written into (G, s, d).
// bias is f32 (nW, s, s): the relative-position bias plus any -inf shift
// mask, with the windows innermost in g (the (G // nW, nW) order).  Head dim
// 64; s is the window's token count (256 for the shipped 16x16 window).
//
// What bounds it on the H100: 4*s*d flops per query against 16 bytes per
// token read and written make it compute-bound (s/4 = 64 flops a byte at s
// = 256, far above the f32 ridge of about 20), at the 67 TFLOP/s of the f32
// CUDA cores, since this first version does not use the tensor cores.  The
// Pallas kernel held one whole window in VMEM per grid step; here one
// 256-thread block takes one 64-query tile of one window (s / 64 blocks a
// window, G * s / 64 in all, spread over the 132 SMs), streams the keys
// through shared memory in 32-key tiles with an online softmax, and keeps
// every logit and probability on chip.  The body (attention_common.cuh)
// reads q, k and v from three base pointers; f32 FMAs on the CUDA cores.
// An all -inf key tile of a shifted window gives 0, not NaN (the shared
// body's guard of the running max).
#include "attention_common.cuh"

namespace {

// token t of one window-head sits at row t of q, k, v and out, offset to
// the window-head by the caller
struct GsdRows {
  __device__ __forceinline__ int64_t qkv(int t) const {
    return (int64_t)t * sic::kHeadDim;
  }
  __device__ __forceinline__ int64_t out(int t) const {
    return (int64_t)t * sic::kHeadDim;
  }
};

// grid: x = g * ntiles + query tile
__global__ void __launch_bounds__(sic::kThreads)
    window_attention_gsd_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ bias,
                                float* __restrict__ out, int s, int nW,
                                float scale) {
  const int ntiles = (s + sic::kQueryTile - 1) / sic::kQueryTile;
  const int g = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  const int64_t base = (int64_t)g * s * sic::kHeadDim;
  const float* gbias = bias + (int64_t)(g % nW) * s * s;
  sic::attend_tile(q + base, k + base, v + base, out + base, GsdRows{}, s, 0,
                   scale, gbias, tile * sic::kQueryTile);
}

}  // namespace

extern "C" int sic_window_attention_gsd(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        void* out, int G, int s, int d,
                                        int nW, float scale, void* stream) {
  if (d != sic::kHeadDim || G <= 0 || s <= 0 || nW <= 0 || G % nW) {
    return (int)cudaErrorInvalidValue;
  }
  const int ntiles = (s + sic::kQueryTile - 1) / sic::kQueryTile;
  const long long blocks = (long long)G * ntiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  window_attention_gsd_kernel<<<(unsigned)blocks, sic::kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (float*)out, s, nW, scale);
  return (int)cudaGetLastError();
}
