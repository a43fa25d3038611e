// NHWC window attention over a packed qkv projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel sic_tpu/ops/window_attention.py::_nhwc_kernel
// (launcher _nhwc_pallas): for every ws x ws window (i, j) of a
// (B, H, W, 3C) packed [q | k | v] map and every head,
// softmax(q * scale . k^T + bias[(i * nww + j) % nB]) v, written head-major
// into (B, H, W, C).  bias is f32 (nB, s, s), s = ws * ws, with nB = 1 (a
// shared relative-position bias) or nB = nww * nwh (bias plus the -inf
// masks of a shifted layer).
//
// What bounds it on the H100: with s = 256 and head dim 64 the block does
// 4*s*d = 64 Kflop per query against 16 bytes per token and channel, so it
// is compute-bound at the 67 TFLOP/s of the f32 CUDA cores (no tensor
// cores in this first version).  The design reads each window's q/k/v
// straight from NHWC through the token -> (row, column) map, so no window
// partition or head split is ever written to device memory; logits and
// probabilities stay on chip; the bias is read once per query row and key.
// A shifted window's first key tiles can be all -inf for some rows; the
// shared body guards the running max against -inf - -inf.
#include "attention_common.cuh"

namespace {

struct WindowRows {
  int64_t pix0;   // pixel index of the window's top-left token
  int W;          // map width in pixels
  int ws;         // window side
  int qkv_ch;     // 3C
  int out_ch;     // C
  __device__ __forceinline__ int64_t pix(int t) const {
    return pix0 + (int64_t)(t / ws) * W + (t % ws);
  }
  __device__ __forceinline__ int64_t qkv(int t) const {
    return pix(t) * qkv_ch;
  }
  __device__ __forceinline__ int64_t out(int t) const {
    return pix(t) * out_ch;
  }
};

// grid: x = head * ntiles + query tile, y = window (i * nww + j), z = batch
__global__ void __launch_bounds__(sic::kThreads)
    window_attention_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ bias,
                            float* __restrict__ out, int H, int W, int C,
                            int ws, int nB, float scale) {
  const int s = ws * ws;
  const int ntiles = (s + sic::kQueryTile - 1) / sic::kQueryTile;
  const int head = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  const int nww = W / ws;
  const int win = blockIdx.y;
  const int wi = win / nww;
  const int wj = win % nww;
  const int b = blockIdx.z;
  const WindowRows rows{((int64_t)b * H + (int64_t)wi * ws) * W + wj * ws,
                        W, ws, 3 * C, C};
  const float* wbias = bias + (int64_t)(win % nB) * s * s;
  sic::attend_tile(qkv, qkv + C, qkv + 2 * C, out, rows, s, head, scale,
                   wbias, tile * sic::kQueryTile);
}

}  // namespace

extern "C" int sic_window_attention(const void* qkv, const void* bias,
                                    void* out, int B, int H, int W, int C,
                                    int heads, int ws, int nB, float scale,
                                    void* stream) {
  if (C != heads * sic::kHeadDim || ws <= 0 || H % ws || W % ws || nB <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int s = ws * ws;
  const int ntiles = (s + sic::kQueryTile - 1) / sic::kQueryTile;
  const dim3 grid(heads * ntiles, (H / ws) * (W / ws), B);
  window_attention_kernel<<<grid, sic::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)qkv, (const float*)bias, (float*)out, H, W, C, ws, nB,
      scale);
  return (int)cudaGetLastError();
}
