// NHWC window attention over a packed qkv projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel sic_tpu/ops/window_attention.py::_nhwc_kernel
// (launcher _nhwc_pallas): for every ws x ws window (i, j) of a
// (B, H, W, 3C) packed [q | k | v] map and every head,
// softmax(q * scale . k^T + bias[(i * nww + j) % nB]) v, written head-major
// into (B, H, W, C).  bias is f32 (nB, s, s), s = ws * ws, with nB = 1 (a
// shared relative-position bias) or nB = nww * nwh (bias plus the -inf
// masks of a shifted layer).  ws is 16 in every Swin layer; the kernel
// takes ws in {8, 16, 32, 64} (a 64-token tile is whole window rows).
//
// What bounds it on the H100: with s = 256 and head dim 64 a window does
// 4*s*d = 64 Kflop per query against 16 bytes per token and channel, so it
// is bound by operations: at fp32 accuracy on the tensor cores, 3 TF32
// products per product over 495 TFLOP/s (the f32 CUDA cores' 67 TFLOP/s
// bound is kept beside it: the first version ran every product as an f32
// FMA reading shared memory, at a quarter of that peak at best).
//
// Design (the body and WindowGeo are attention_tc.cuh): split-TF32 wgmma for both
// products, both operands K-major as tf32 wgmma requires (v staged
// transposed, its key rows permuted so that the probabilities go to wgmma
// as the register A operand from the logits accumulator).  One 4-D tensor
// map (3C, W, H, B) serves q, k and v: a box of (32 channels, ws columns,
// 64 / ws rows, 1) is a 64-token tile of a window as it lies in NHWC, so
// the window partition is never written to device memory.  The bias tile
// (a 3-D map over (s, s, nB)) comes through the same ring.  A shifted
// window's all -inf key tiles give 0, not NaN (the body's -inf guard).
//
// Block shape, from ptxas and the wave count (132 SMs): two consumer
// warpgroups (128 queries of one window-head) share each 64-key tile and
// its split into hi and lo; 254-255 registers a thread, no spills
// (ptxas), and 181,312 bytes of shared memory (two ring stages of k, v and
// a 128 x 64 bias tile, 64 KB each, 48 KB of split buffers, alignment
// slack): one 256-thread block an SM.  The
// flagship's 32 x 32 maps (2 x 2 windows) give 2 tiles x 12 heads x 4 =
// 96 blocks at width 768 (0.73 of a wave) and 128 at 1024 (0.97); 64-row
// tiles would give 192 and 256 blocks, 1.45 and 1.94 waves at one an SM.
// Keys are not split across blocks (a window has only four key tiles):
// widths 768 (0.73 of a wave) and 1024 (0.97) read the same device time,
// so a block's latency, not the SMs left idle, sets it; a split would
// halve that latency at the cost of a second, fixed-order pass.
//
// The bf16 entry (sic_window_attention_bf16; every Swin layer in the JAX
// package's bf16 serving mode): bf16 qkv and out, f32 bias, one bf16
// wgmma per product with f32 accumulation, f32 logits and softmax
// (attention_tc.cuh's bf16 body: one warpgroup on 64 queries a block, a
// two-stage ring of k, v and the bias tile on full and empty mbarriers,
// 72 KB with the q tile, three blocks an SM): 192 and 256 blocks at the
// flagship's windows, one wave.  Its bound is 4 * s * d flops a query
// over 989 TFLOP/s against its bytes at 2 bytes an element (4 a bias
// element).
#include "attention_tc.cuh"

namespace {

// grid: x = head * ntiles + query tile, y = window (i * nww + j), z = batch
template <typename T, int NWG>
__global__ void __launch_bounds__(NWG * 128,
                      sic_tc::min_blocks<T, true>())
    window_attention_kernel(const __grid_constant__ CUtensorMap map,
                            const __grid_constant__ CUtensorMap bias_map,
                            T* __restrict__ out, int H, int W, int C, int ws,
                            int nB, float scale) {
  extern __shared__ uint8_t smem[];
  const int s = ws * ws;
  const int ntiles = s / (NWG * sic_tc::kWgRows);
  const int nww = W / ws;
  const int win = blockIdx.y;
  const sic_tc::WindowGeoT<T> geo{&map,
                                  &bias_map,
                                  out,
                                  H,
                                  W,
                                  C,
                                  ws,
                                  (int)blockIdx.x / ntiles,
                                  (int)blockIdx.z,
                                  (win % nww) * ws,
                                  (win / nww) * ws,
                                  win % nB};
  sic_tc::attend<T, NWG, true>(
      geo, s, scale, ((int)blockIdx.x % ntiles) * NWG * sic_tc::kWgRows, smem);
}

template <typename T, int NWG>
int launch(const CUtensorMap& map, const CUtensorMap& bias_map, T* out, int B,
           int H, int W, int C, int heads, int ws, int nB, float scale,
           cudaStream_t stream) {
  constexpr int bytes = sic_tc::alloc_bytes<T, NWG, true>();
  const int rc = sic_tc::allow_smem<window_attention_kernel<T, NWG>>(
      bytes, sic_tc::is_bf16<T>());
  if (rc != 0) return rc;
  const int ntiles = ws * ws / (NWG * sic_tc::kWgRows);
  const dim3 grid(heads * ntiles, (H / ws) * (W / ws), B);
  window_attention_kernel<T, NWG><<<grid, NWG * 128,
                                        bytes, stream>>>(
      map, bias_map, out, H, W, C, ws, nB, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* qkv, const void* bias, void* out, int B, int H, int W,
        int C, int heads, int ws, int nB, float scale, void* stream) {
  if (C != heads * sic_tc::kHeadDim || ws < 8 || sic_tc::kBoxRows % ws ||
      H % ws || W % ws || nB <= 0 || B <= 0 ||
      reinterpret_cast<uintptr_t>(qkv) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int s = ws * ws;
  CUtensorMap map, bias_map;
  int rc = sic_tc::encode_window_map<T>(&map, qkv, 3 * C, W, H, B, ws);
  if (rc != 0) return rc;
  rc = sic_tc::encode_square_map(&bias_map, bias, s, s, nB);
  if (rc != 0) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (sic_tc::is_bf16<T>()) {  // 64-row blocks, three an SM
    return launch<T, 1>(map, bias_map, (T*)out, B, H, W, C, heads, ws, nB,
                        scale, st);
  } else {
    return s % (2 * sic_tc::kWgRows) == 0
               ? launch<T, 2>(map, bias_map, (T*)out, B, H, W, C, heads, ws,
                              nB, scale, st)
               : launch<T, 1>(map, bias_map, (T*)out, B, H, W, C, heads, ws,
                              nB, scale, st);
  }
}

}  // namespace

// f32 qkv and out (split TF32); the bias is f32 in both entries
extern "C" int sic_window_attention(const void* qkv, const void* bias,
                                    void* out, int B, int H, int W, int C,
                                    int heads, int ws, int nB, float scale,
                                    void* stream) {
  return run<float>(qkv, bias, out, B, H, W, C, heads, ws, nB, scale, stream);
}

// bf16 qkv and out (bf16 tensor cores, f32 accumulation, bias and softmax)
extern "C" int sic_window_attention_bf16(const void* qkv, const void* bias,
                                         void* out, int B, int H, int W, int C,
                                         int heads, int ws, int nB,
                                         float scale, void* stream) {
  return run<__nv_bfloat16>(qkv, bias, out, B, H, W, C, heads, ws, nB, scale,
                            stream);
}
