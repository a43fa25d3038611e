// Window attention over separate (G, s, d) q, k, v tensors, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel sic_tpu/ops/window_attention.py::_attention_kernel
// (launcher _pallas_forward): for every window-head g of G,
// softmax(q[g] * scale . k[g]^T + bias[g % nW]) v[g], written into (G, s, d).
// bias is f32 (nW, s, s): the relative-position bias plus any -inf shift
// mask, with the windows innermost in g (the (G // nW, nW) order).  Head dim
// 64; s is any token count (256 for the shipped 16x16 window).
//
// What bounds it on the H100: 4*s*d flops per query against 16 bytes per
// token read and written make it bound by operations (s/4 = 64 flops a
// byte at s = 256): at fp32 accuracy on the tensor cores, 3 TF32 products
// per product over 495 TFLOP/s (the f32 CUDA cores' 67 TFLOP/s bound is
// kept beside it: the first version ran every product as an f32 FMA
// reading shared memory, at 8-17% of that bound).
//
// Design: the body of kernels 1 and 2 (attention_tc.cuh): split-TF32
// wgmma for both products, TMA loads into a two-stage ring, online softmax
// on the accumulator fragments, each key tile's P v in a fresh
// accumulator.  GsdGeo supplies the tiles: three 3-D tensor maps (64, s,
// G), one each for q, k and v, whose (32, 64, 1) box is half a head row of
// 64 tokens of one window-head, and the bias as a 3-D map (s, s, nW) read
// at window g % nW.  Rows past s arrive zero-filled from the TMA and their
// keys are masked to -inf, so any s is taken: ragged (289) and small (49,
// 1) too.  The TMA needs the bias's row stride (s floats) to be a multiple
// of 16 bytes: where s % 4 != 0 the wrapper hands over the bias padded
// with zero columns to a multiple of 4 (`row_floats`); the padded columns
// lie past s, are masked and change nothing.
//
// Block shape, as kernel 2 chooses: two consumer warpgroups (128 queries
// of one window-head) where s is a multiple of 128, else one.  The
// flagship layer's (48, 256, 64) gives 48 x 2 = 96 blocks of 256 threads
// (0.73 of a wave on 132 SMs), kernel 2's grid on the same layer.
//
// The bf16 entry (sic_window_attention_gsd_bf16, as the JAX op takes bf16
// q, k, v): bf16 operands and output, f32 bias, attention_tc.cuh's bf16
// body (one warpgroup on 64 queries a block, three an SM: 192 blocks on
// the flagship layer); the maps' box is one whole 64-wide bf16 head row.  Its bound is 4 * s * d flops a query over 989 TFLOP/s
// against its bytes.
#include "attention_tc.cuh"

namespace {

template <typename T>
struct GsdGeo {
  const CUtensorMap* q_map;
  const CUtensorMap* k_map;
  const CUtensorMap* v_map;
  const CUtensorMap* bias_map;
  T* out;
  int s, g, win;
  __device__ __forceinline__ void load(void* dst, uint64_t* bar, int which,
                                       int half, int row0) const {
    const CUtensorMap* m = which == 0 ? q_map : which == 1 ? k_map : v_map;
    sic_tc::tma_load_3d(dst, m, bar, half * 32, row0, g);
  }
  __device__ __forceinline__ void load_bias(void* dst, uint64_t* bar, int half,
                                            int qrow0, int k0) const {
    sic_tc::tma_load_3d(dst, bias_map, bar, k0 + half * 32, qrow0, win);
  }
  __device__ __forceinline__ T* out_row(int t) const {
    return out + ((int64_t)g * s + t) * sic_tc::kHeadDim;
  }
};

// grid: x = g * ntiles + query tile
template <typename T, int NWG>
__global__ void __launch_bounds__(NWG * 128,
                      sic_tc::min_blocks<T, true>())
    window_attention_gsd_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap bias_map,
                                T* __restrict__ out, int s, int nW,
                                float scale) {
  extern __shared__ uint8_t smem[];
  constexpr int rows = NWG * sic_tc::kWgRows;
  const int ntiles = (s + rows - 1) / rows;
  const int g = blockIdx.x / ntiles;
  const GsdGeo<T> geo{&q_map, &k_map, &v_map, &bias_map, out, s, g, g % nW};
  sic_tc::attend<T, NWG, true>(geo, s, scale,
                               ((int)blockIdx.x % ntiles) * rows, smem);
}

template <typename T, int NWG>
int launch(const CUtensorMap (&maps)[4], T* out, int G, int s, int nW,
           float scale, cudaStream_t stream) {
  constexpr int bytes = sic_tc::alloc_bytes<T, NWG, true>();
  const int rc =
      sic_tc::allow_smem<window_attention_gsd_kernel<T, NWG>>(
      bytes, sic_tc::is_bf16<T>());
  if (rc != 0) return rc;
  constexpr int rows = NWG * sic_tc::kWgRows;
  const long long blocks = (long long)G * ((s + rows - 1) / rows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  window_attention_gsd_kernel<T, NWG><<<(unsigned)blocks,
                                        NWG * 128, bytes,
                                        stream>>>(maps[0], maps[1], maps[2],
                                                  maps[3], out, s, nW, scale);
  return (int)cudaGetLastError();
}

// bias rows are `row_floats` apart (s rounded up to a multiple of 4 by the
// caller, zero columns past s)
template <typename T>
int run(const void* q, const void* k, const void* v, const void* bias,
        void* out, int G, int s, int d, int nW, int row_floats, float scale,
        void* stream) {
  if (d != sic_tc::kHeadDim || G <= 0 || s <= 0 || nW <= 0 || G % nW ||
      row_floats < s || row_floats % 4) {
    return (int)cudaErrorInvalidValue;
  }
  const void* bases[4] = {q, k, v, bias};
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)d * e, (cuuint64_t)s * d * e};
  const cuuint32_t box[3] = {(cuuint32_t)sic_tc::atom_elems<T>(),
                             sic_tc::kBoxRows, 1};
  for (int i = 0; i < 3; ++i) {
    const int rc =
        sic_tc::encode_map<T>(&maps[i], bases[i], 3, dims, strides, box);
    if (rc != 0) return rc;
  }
  const int rc = sic_tc::encode_square_map(&maps[3], bias, s, row_floats, nW);
  if (rc != 0) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (sic_tc::is_bf16<T>()) {  // 64-row blocks, three an SM
    return launch<T, 1>(maps, (T*)out, G, s, nW, scale, st);
  } else {
    return s % (2 * sic_tc::kWgRows) == 0
               ? launch<T, 2>(maps, (T*)out, G, s, nW, scale, st)
               : launch<T, 1>(maps, (T*)out, G, s, nW, scale, st);
  }
}

}  // namespace

// f32 q, k, v and out (split TF32); the bias is f32 in both entries
extern "C" int sic_window_attention_gsd(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        void* out, int G, int s, int d,
                                        int nW, int row_floats, float scale,
                                        void* stream) {
  return run<float>(q, k, v, bias, out, G, s, d, nW, row_floats, scale,
                    stream);
}

// bf16 q, k, v and out (bf16 tensor cores, f32 accumulation and softmax)
extern "C" int sic_window_attention_gsd_bf16(const void* q, const void* k,
                                             const void* v, const void* bias,
                                             void* out, int G, int s, int d,
                                             int nW, int row_floats,
                                             float scale, void* stream) {
  return run<__nv_bfloat16>(q, k, v, bias, out, G, s, d, nW, row_floats,
                            scale, stream);
}
