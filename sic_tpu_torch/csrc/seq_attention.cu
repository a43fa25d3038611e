// Sequence self-attention over a packed qkv projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel sic_tpu/ops/seq_attention.py::_seq_attn_kernel
// (launcher _seq_attn_pallas): unmasked multi-head attention from
// (B, S, 3C) packed [q | k | v] to (B, S, C) head-major, f32 logits and
// softmax, in f32 or bf16.  S is 289 in the ViT trunks, 545 in the cross-attention blocks
// and 50 in the CLIP image tower; head dim 64.
//
// What bounds it on the H100: 4*S*d flops per (query, head) against
// 16*C bytes read and written per token make it bound by operations (S/4
// flops a byte, far above the ridge).  At fp32 accuracy on the tensor
// cores that is 3 TF32 products per product: 3 * 4 * B * heads * S^2 * d
// over 495 TFLOP/s (the f32 CUDA cores' 67 TFLOP/s bound is kept beside it
// for comparison with the first version, whose every product was an f32
// FMA reading shared memory, a quarter of that peak at best).
//
// Design (the body is attention_tc.cuh): split-TF32 wgmma for both
// products, both operands K-major as tf32 wgmma requires (q and k as they
// lie, head dim contiguous; v staged transposed with its key rows permuted
// so that the probabilities go to wgmma as the register A operand straight
// from the logits accumulator, never through shared memory).  One 3-D
// tensor map (3C, S, B) serves q, k and v at channels h*64, C + h*64 and
// 2C + h*64; rows past S come zero-filled, so a tile never reads the next
// sequence, and their keys are masked to -inf.
//
// Block shape, from ptxas and the wave count (132 SMs):
//   * two consumer warpgroups (128 query rows) share each 64-key tile, so
//     the split of k and v into hi and lo (the shared-memory pass that the
//     tensor cores wait on) is paid once for 128 rows; one warpgroup (64
//     rows) where S <= 64 (the CLIP tower: 12 blocks either way);
//   * 251-253 registers a thread, no spills (ptxas; q's hi and lo
//     fragments are 64 of them, the logits, the tile's P v and the output
//     32 each) and 115,776 bytes of shared memory (two ring stages of k
//     and v, 32 KB each, 48 KB of split buffers, alignment slack) give
//     one 256-thread block an SM;
//   * trunk (4, 289, 3072): 3 tiles x 16 heads x 4 = 192 blocks, 1.45
//     waves; cross (4, 545, 2304): 5 x 12 x 4 = 240 blocks, 1.82 waves;
//     64-row tiles would give 320 and 432 blocks at two an SM by shared
//     memory but not by registers.
//
// The bf16 entry (sic_seq_attention_bf16; the JAX package's bf16 serving
// mode): bf16 qkv and out, one bf16 wgmma per product on the tensor cores
// with f32 accumulation, f32 logits and softmax (attention_tc.cuh's bf16
// body).  Its bound is 4 * B * heads * S^2 * d over 989 TFLOP/s, with
// 2-byte elements; the same grid, 48 KB of ring and 16 KB of q tile.
#include "attention_tc.cuh"

namespace {

template <typename T>
struct SeqGeo {
  const CUtensorMap* map;
  T* out;
  int S, C, head, b;
  __device__ __forceinline__ void load(void* dst, uint64_t* bar, int which,
                                       int half, int row0) const {
    sic_tc::tma_load_3d(dst, map, bar,
                        which * C + head * sic_tc::kHeadDim + half * 32, row0,
                        b);
  }
  __device__ __forceinline__ T* out_row(int t) const {
    return out + ((int64_t)b * S + t) * C + head * sic_tc::kHeadDim;
  }
};

// grid: x = query tile, y = head, z = sequence
template <typename T, int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
    seq_attention_kernel(const __grid_constant__ CUtensorMap map,
                         T* __restrict__ out, int S, int C, float scale) {
  extern __shared__ uint8_t smem[];
  const SeqGeo<T> geo{&map, out, S, C, (int)blockIdx.y, (int)blockIdx.z};
  sic_tc::attend<T, NWG, false>(geo, S, scale,
                                blockIdx.x * NWG * sic_tc::kWgRows, smem);
}

template <typename T, int NWG>
int launch(const CUtensorMap& map, T* out, int B, int S, int C, int heads,
           float scale, cudaStream_t stream) {
  constexpr int bytes = sic_tc::alloc_bytes<T, NWG, false>();
  const int rc = sic_tc::allow_smem<seq_attention_kernel<T, NWG>>(bytes);
  if (rc != 0) return rc;
  const int rows = NWG * sic_tc::kWgRows;
  const dim3 grid((S + rows - 1) / rows, heads, B);
  seq_attention_kernel<T, NWG><<<grid, NWG * 128, bytes, stream>>>(
      map, out, S, C, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* qkv, void* out, int B, int S, int C, int heads,
        float scale, void* stream) {
  if (C != heads * sic_tc::kHeadDim || B <= 0 || S <= 0 ||
      reinterpret_cast<uintptr_t>(qkv) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)3 * C, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)3 * C * e,
                                 (cuuint64_t)S * 3 * C * e};
  const cuuint32_t box[3] = {(cuuint32_t)sic_tc::atom_elems<T>(),
                             sic_tc::kBoxRows, 1};
  const int rc = sic_tc::encode_map<T>(&map, qkv, 3, dims, strides, box);
  if (rc != 0) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  return S <= sic_tc::kWgRows
             ? launch<T, 1>(map, (T*)out, B, S, C, heads, scale, s)
             : launch<T, 2>(map, (T*)out, B, S, C, heads, scale, s);
}

}  // namespace

// f32 qkv and out (split TF32)
extern "C" int sic_seq_attention(const void* qkv, void* out, int B, int S,
                                 int C, int heads, float scale,
                                 void* stream) {
  return run<float>(qkv, out, B, S, C, heads, scale, stream);
}

// bf16 qkv and out (bf16 tensor cores, f32 accumulation and softmax)
extern "C" int sic_seq_attention_bf16(const void* qkv, void* out, int B, int S,
                                      int C, int heads, float scale,
                                      void* stream) {
  return run<__nv_bfloat16>(qkv, out, B, S, C, heads, scale, stream);
}
