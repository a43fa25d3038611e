// Sequence self-attention over a packed qkv projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel sic_tpu/ops/seq_attention.py::_seq_attn_kernel
// (launcher _seq_attn_pallas): unmasked multi-head attention from
// (B, S, 3C) packed [q | k | v] to (B, S, C) head-major, f32 logits and
// softmax.  S is 289 in the ViT trunks and 545 in the cross-attention
// blocks, head dim 64.
//
// What bounds it on the H100: 4*S*d flops per (query, head) against 4*C*4
// bytes read/written per token make it compute-bound (S*d/(4*C/heads) =
// S/4 flops per byte, far above the f32 ridge of ~20), at the 67 TFLOP/s
// of the f32 CUDA cores since this first version does not use the tensor
// cores.  The design keeps every logit and probability on chip (registers
// and shared memory), reads q/k/v once per block through strides with no
// relayout pass, and masks the ragged edge of S (neither 289 nor 545 is a
// multiple of a tile).  Tensor-core (wgmma/TF32 or bf16) tiles are later
// work.
#include "attention_common.cuh"

namespace {

struct SeqRows {
  int64_t qkv_base;
  int64_t out_base;
  int qkv_stride;
  int out_stride;
  __device__ __forceinline__ int64_t qkv(int t) const {
    return qkv_base + (int64_t)t * qkv_stride;
  }
  __device__ __forceinline__ int64_t out(int t) const {
    return out_base + (int64_t)t * out_stride;
  }
};

// grid: x = query tile, y = head, z = sequence
__global__ void __launch_bounds__(sic::kThreads)
    seq_attention_kernel(const float* __restrict__ qkv,
                         float* __restrict__ out, int S, int C, float scale) {
  const int b = blockIdx.z;
  const SeqRows rows{(int64_t)b * S * 3 * C, (int64_t)b * S * C, 3 * C, C};
  sic::attend_tile(qkv, qkv + C, qkv + 2 * C, out, rows, S, blockIdx.y,
                   scale, nullptr, blockIdx.x * sic::kQueryTile);
}

}  // namespace

extern "C" int sic_seq_attention(const void* qkv, void* out, int B, int S,
                                 int C, int heads, float scale,
                                 void* stream) {
  if (C != heads * sic::kHeadDim || B <= 0 || S <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((S + sic::kQueryTile - 1) / sic::kQueryTile, heads, B);
  seq_attention_kernel<<<grid, sic::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)qkv, (float*)out, S, C, scale);
  return (int)cudaGetLastError();
}
