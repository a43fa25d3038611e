// rANS plane decode for many independent substreams, for Hopper (sm_90a).
//
// Replaces the TPU kernel sic_tpu/ops/rans_decode.py::_decode_kernel
// (launcher _decode_call): decodes one four-part-prior symbol plane for S
// substreams, bit-exact to the native decoder (cpp/sic_rans.cc:146-229):
// 16-bit probabilities, L = 2^23, byte renormalisation, an index < 0 emits
// 0 and reads nothing, out-of-range symbols escape to 2-bit bypass chunks,
// and the (x, pos) state carries over from plane to plane.
//
// What bounds it on the H100: neither bytes nor flops.  rANS is serial
// within a substream, so one plane costs npos dependent steps (a CDF
// search, a multiply and a renormalisation each) on one thread per
// substream, and S = 4 per image gives only a few active threads.  The
// design keeps that chain short: the whole CDF table (256 rows of at most
// 126 int32, plus sizes and offsets) sits in shared memory, the slot
// search is a binary search (rows are strictly increasing, so it finds the
// slot of the C++ linear scan), and the state update is native 32-bit
// integer multiply, shift and compare (decoding needs no division).  The
// TPU kernel's one-hot matmul gather,
// bf16 byte-split table and 8-lane lockstep only dodged TPU limits and are
// not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kMask = (1u << kProbBits) - 1;
constexpr uint32_t kRansL = 1u << 23;
constexpr uint32_t kBypassBits = 2;
constexpr uint32_t kBypassMax = (1u << kBypassBits) - 1;

struct Stream {
  const uint32_t* words;
  uint32_t len;
  uint32_t x;
  uint32_t pos;

  __device__ __forceinline__ uint32_t byte_at(uint32_t p) const {
    return (words[p >> 2] >> (8 * (p & 3))) & 0xffu;
  }
  // sic_rans.cc advance(): consume (start, freq), refill while x < L
  __device__ __forceinline__ void advance(uint32_t start, uint32_t freq) {
    x = freq * (x >> kProbBits) + (x & kMask) - start;
    while (x < kRansL && pos < len) x = (x << 8) | byte_at(pos++);
  }
  // sic_rans.cc get_raw_bits(): kBypassBits raw bits, at most one refill
  __device__ __forceinline__ uint32_t raw_bits() {
    const uint32_t val = x & kBypassMax;
    x >>= kBypassBits;
    if (x < kRansL && pos < len) x = (x << 8) | byte_at(pos++);
    return val;
  }
};

// one thread per substream; blockDim.x threads per block
__global__ void rans_decode_kernel(
    const int32_t* __restrict__ idx, const uint32_t* __restrict__ words,
    const int32_t* __restrict__ lengths, const int64_t* __restrict__ state_in,
    const int32_t* __restrict__ cdf, const int32_t* __restrict__ sizes,
    const int32_t* __restrict__ offsets, int32_t* __restrict__ sym,
    int64_t* __restrict__ state_out, int S, int npos, int nwords, int ncdf,
    int width) {
  extern __shared__ int32_t smem[];
  int32_t* s_cdf = smem;
  int32_t* s_size = s_cdf + ncdf * width;
  int32_t* s_off = s_size + ncdf;
  for (int e = threadIdx.x; e < ncdf * width; e += blockDim.x) s_cdf[e] = cdf[e];
  for (int e = threadIdx.x; e < ncdf; e += blockDim.x) {
    s_size[e] = sizes[e];
    s_off[e] = offsets[e];
  }
  __syncthreads();

  const int sid = blockIdx.x * blockDim.x + threadIdx.x;
  if (sid >= S) return;
  Stream st{words + (int64_t)sid * nwords, (uint32_t)lengths[sid],
            (uint32_t)state_in[2 * sid], (uint32_t)state_in[2 * sid + 1]};
  const int32_t* ix = idx + (int64_t)sid * npos;
  int32_t* out = sym + (int64_t)sid * npos;

  for (int i = 0; i < npos; ++i) {
    const int32_t ci = ix[i];
    if (ci < 0 || ci >= ncdf) {  // skipped position: emit 0, read nothing
      out[i] = 0;
      continue;
    }
    const int32_t* row = s_cdf + ci * width;
    const int32_t size = s_size[ci];
    const int32_t max_value = size - 2;
    const uint32_t cum = st.x & kMask;

    // s = #{k in [1, size-1] : row[k] <= cum}  (upper bound over a sorted row)
    int first = 1;
    int count = size - 1;
    while (count > 0) {
      const int step = count >> 1;
      if ((uint32_t)row[first + step] <= cum) {
        first += step + 1;
        count -= step + 1;
      } else {
        count = step;
      }
    }
    const int32_t s = first - 1;
    st.advance((uint32_t)row[s], (uint32_t)(row[s + 1] - row[s]));

    int32_t value = s;
    if (value == max_value) {
      uint32_t val = st.raw_bits();
      uint32_t n_bypass = val;
      while (val == kBypassMax) {
        val = st.raw_bits();
        n_bypass += val;
      }
      uint32_t raw_val = 0;
      for (uint32_t j = 0; j < n_bypass; ++j) {
        const uint32_t bits = st.raw_bits();
        if (j < 32 / kBypassBits) raw_val |= bits << (j * kBypassBits);
      }
      value = (int32_t)(raw_val >> 1);
      value = (raw_val & 1) ? -value - 1 : value + max_value;
    }
    out[i] = value + s_off[ci];
  }
  state_out[2 * sid] = st.x;
  state_out[2 * sid + 1] = st.pos;
}

}  // namespace

extern "C" int sic_rans_decode_plane(
    const void* idx, const void* words, const void* lengths,
    const void* state_in, const void* cdf, const void* sizes,
    const void* offsets, void* sym, void* state_out, int S, int npos,
    int nwords, int ncdf, int width, void* stream) {
  if (S <= 0 || npos < 0 || ncdf <= 0 || width < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(int32_t) * ((size_t)ncdf * width + 2 * (size_t)ncdf);
  cudaError_t err = cudaFuncSetAttribute(
      rans_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = S < 128 ? ((S + 31) / 32) * 32 : 128;
  const int blocks = (S + threads - 1) / threads;
  rans_decode_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const uint32_t*)words, (const int32_t*)lengths,
      (const int64_t*)state_in, (const int32_t*)cdf, (const int32_t*)sizes,
      (const int32_t*)offsets, (int32_t*)sym, (int64_t*)state_out, S, npos,
      nwords, ncdf, width);
  return (int)cudaGetLastError();
}
