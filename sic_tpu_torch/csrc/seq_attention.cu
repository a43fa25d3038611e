// Sequence self-attention over a packed qkv projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel sic_tpu/ops/seq_attention.py::_seq_attn_kernel
// (launcher _seq_attn_pallas): unmasked multi-head attention from
// (B, S, 3C) packed [q | k | v] to (B, S, C) head-major, f32 logits and
// softmax, in f32 or bf16.  S is 289 in the ViT trunks (TiTok-L's
// encoder and decoder included), 545 in the cross-attention blocks, 50 in
// the CLIP image tower, head dim 64; and 33 in the MaskGIT generator, head
// dim 48 (32 in its test-scale spec).  Any head dim d <= 64 whose row of d
// elements is a multiple of 16 bytes (the tensor map's stride rule) runs:
// 32, 48 and 64 in f32 and bf16.
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
// from the logits accumulator, never through shared memory).  One 4-D
// tensor map (d, 3 heads, S, B) serves q, k and v of head h at (0 or 32,
// h), (.., heads + h) and (.., 2 heads + h); rows past S come zero-filled,
// so a tile never reads the next sequence, and their keys are masked to
// -inf.  The body stays 64 columns wide: columns d..63 lie past the map's
// innermost extent, so TMA fills them with zeros as well, they add nothing
// to q k^T and their output columns (zeros) are not stored.  At d = 48 a
// quarter of the products multiply those zeros; at d = 32 half (the f32
// entry's second 32-float box is then all zeros).
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
// body).  Its bound is the larger of 4 * B * heads * S^2 * d over 989
// TFLOP/s and its bytes at 2 bytes an element: bytes at every flagship
// shape.  What holds it above that bound is latency: each block walks its
// key tiles in turn, and the softmax's instructions take longer than the
// tile's products.  So the design fills the SM with independent
// warpgroups: one warpgroup a block (64 query rows) at every length, a
// two-stage ring of k and v (40 KB with the q tile) on full and empty
// mbarriers, at most 128 registers a thread (ptxas: 109, no spills), four
// blocks an SM; trunk (4, 289, 3072): 5 x 16 x 4 = 320 blocks, cross (4,
// 545, 2304): 9 x 12 x 4 = 432, both one wave of the card's 528 slots
// (the f32 grid, 128-row blocks one an SM, takes 1.45 and 1.82 waves).
// The softmax takes exp as one FFMA and one ex2.approx a logit,
// the scale folded into the exponent, and masks keys only in a ragged
// last tile.
#include "attention_tc.cuh"

namespace {

template <typename T>
struct SeqGeo {
  const CUtensorMap* map;
  T* out;
  int S, C, heads, head, b;
  int cols;  // the head dim d: only these columns of a row are stored
  __device__ __forceinline__ void load(void* dst, uint64_t* bar, int which,
                                       int half, int row0) const {
    sic_tc::tma_load_4d(dst, map, bar, half * 32, which * heads + head, row0,
                        b);
  }
  __device__ __forceinline__ T* out_row(int t) const {
    return out + ((int64_t)b * S + t) * C + head * cols;
  }
};

}  // namespace

// kernel 1's heads may be narrower than the body: store `cols` columns
namespace sic_tc {
template <typename T>
struct NarrowHead<SeqGeo<T>> : std::true_type {};
}  // namespace sic_tc

namespace {

// grid: x = query tile, y = head, z = sequence
template <typename T, int NWG>
__global__ void __launch_bounds__(NWG * 128,
                      sic_tc::min_blocks<T, false>())
    seq_attention_kernel(const __grid_constant__ CUtensorMap map,
                         T* __restrict__ out, int S, int C, int d,
                         float scale) {
  extern __shared__ uint8_t smem[];
  const SeqGeo<T> geo{&map, out, S, C, (int)gridDim.y, (int)blockIdx.y,
                      (int)blockIdx.z, d};
  sic_tc::attend<T, NWG, false>(geo, S, scale,
                                blockIdx.x * NWG * sic_tc::kWgRows, smem);
}

template <typename T, int NWG>
int launch(const CUtensorMap& map, T* out, int B, int S, int C, int heads,
           int d, float scale, cudaStream_t stream) {
  constexpr int bytes = sic_tc::alloc_bytes<T, NWG, false>();
  const int rc = sic_tc::allow_smem<seq_attention_kernel<T, NWG>>(
      bytes, sic_tc::is_bf16<T>());
  if (rc != 0) return rc;
  const int rows = NWG * sic_tc::kWgRows;
  const dim3 grid((S + rows - 1) / rows, heads, B);
  seq_attention_kernel<T, NWG><<<grid, NWG * 128,
                                     bytes, stream>>>(
      map, out, S, C, d, scale);
  return (int)cudaGetLastError();
}

// The head dims the kernel takes: d <= 64 (the body's width), d elements
// a multiple of 16 bytes (a tensor-map stride).
template <typename T>
bool head_dim_ok(int C, int heads) {
  if (heads <= 0 || C % heads) return false;
  const int d = C / heads;
  return d > 0 && d <= sic_tc::kHeadDim && (d * (int)sizeof(T)) % 16 == 0;
}

template <typename T>
int run(const void* qkv, void* out, int B, int S, int C, int heads,
        float scale, void* stream) {
  if (!head_dim_ok<T>(C, heads) || B <= 0 || S <= 0 ||
      reinterpret_cast<uintptr_t>(qkv) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int d = C / heads;
  CUtensorMap map;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)3 * heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)d * e, (cuuint64_t)3 * C * e,
                                 (cuuint64_t)S * 3 * C * e};
  const cuuint32_t box[4] = {(cuuint32_t)sic_tc::atom_elems<T>(), 1,
                             sic_tc::kBoxRows, 1};
  const int rc = sic_tc::encode_map<T>(&map, qkv, 4, dims, strides, box);
  if (rc != 0) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (sic_tc::is_bf16<T>()) {  // 64-row blocks, four an SM
    return launch<T, 1>(map, (T*)out, B, S, C, heads, d, scale, s);
  } else {
    return S <= sic_tc::kWgRows
               ? launch<T, 1>(map, (T*)out, B, S, C, heads, d, scale, s)
               : launch<T, 2>(map, (T*)out, B, S, C, heads, d, scale, s);
  }
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
