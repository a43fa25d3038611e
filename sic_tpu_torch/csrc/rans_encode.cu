// rANS plane encode for many independent substreams, for Hopper (sm_90a).
//
// Replaces the TPU kernel sic_tpu/ops/rans_encode.py::_encode_kernel
// (launcher _encode_call): encodes one four-part-prior symbol plane for S
// substreams, byte-exact to the native encoder (cpp/sic_rans.cc:40-135).
// rANS encodes last in, first out: the native coder buffers every position
// of the four planes and flush() walks them backwards.  Here the caller
// launches once per plane, last plane first, and each launch walks its
// forward-order row from the end, carrying the state (x, byte cursor,
// overflow) from launch to launch.  Per position, in that reverse order:
// the escape's 2-bit bypass chunks high to low, its remainder count entry,
// its saturating kBypassMax count entries, then the symbol itself, as
// uint16 (start, range) pairs where a range of 0 means raw bits
// (sic_rans.cc:116-120).  An index < 0 is skipped.  Emitted bytes go to
// the substream's own row in emission order; the host reverses them and
// prepends the final state (ops/rans_encode.py finalize_streams).
//
// What bounds it on the H100: neither bytes nor operations.  Within a
// substream every position depends on the state the previous one left, so
// one plane costs npos dependent steps (a division, a few shifts and up to
// two byte stores each) on one thread per substream, and a request has
// only 4 substreams per image (4*B live threads on a card that runs
// 270,000).  The design keeps that chain short: the CDF table (256 rows of
// at most 103 int32, plus sizes and offsets) sits in shared memory, the
// next position's symbol and index are loaded before the current one is
// coded so their latency hides behind the dependent arithmetic, and the
// division is native 32-bit x / freq and x % freq.  The TPU kernel's
// one-hot MXU gather, packed-row scratch, f32-reciprocal division with its
// correction steps and 8-lane lockstep only dodged TPU limits and are not
// carried over; the escape loops have no chunk cap.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kBypassBits = 2;
constexpr uint32_t kBypassMax = (1u << kBypassBits) - 1;

struct Encoder {
  uint8_t* out;   // this substream's emission row
  uint32_t cap;   // its length in bytes
  uint32_t x;
  uint32_t pos;
  bool overflow;

  __device__ __forceinline__ void emit(uint32_t byte) {
    if (pos >= cap) {
      overflow = true;
      return;
    }
    out[pos++] = (uint8_t)byte;
  }
  // sic_rans.cc put_symbol
  __device__ __forceinline__ void put_symbol(uint32_t start, uint32_t freq) {
    const uint32_t x_max = freq << 15;
    while (x >= x_max) {
      emit(x & 0xffu);
      x >>= 8;
    }
    x = ((x / freq) << kProbBits) + (x % freq) + start;
  }
  // sic_rans.cc put_raw_bits with nbits = kBypassBits
  __device__ __forceinline__ void put_raw(uint32_t val) {
    const uint32_t x_max = (1u << (kProbBits - kBypassBits)) << 15;
    while (x >= x_max) {
      emit(x & 0xffu);
      x >>= 8;
    }
    x = (x << kBypassBits) | val;
  }
  // one buffered Sym of sic_rans.cc flush()
  __device__ __forceinline__ void put(uint32_t start16, uint32_t range16) {
    if (range16 != 0) {
      put_symbol(start16, range16);
    } else {
      put_raw(start16);
    }
  }
};

// one thread per substream; blockDim.x threads per block
__global__ void rans_encode_kernel(
    const int32_t* __restrict__ sym, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ cdf, const int32_t* __restrict__ sizes,
    const int32_t* __restrict__ offsets, uint8_t* __restrict__ words,
    const int64_t* __restrict__ state_in, int64_t* __restrict__ state_out,
    int S, int npos, int nbytes, int ncdf, int width) {
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
  Encoder enc{words + (int64_t)sid * nbytes, (uint32_t)nbytes,
              (uint32_t)state_in[4 * sid], (uint32_t)state_in[4 * sid + 1],
              state_in[4 * sid + 2] != 0};
  const int32_t* sy = sym + (int64_t)sid * npos;
  const int32_t* ix = idx + (int64_t)sid * npos;

  int32_t ci_next = npos > 0 ? ix[npos - 1] : -1;
  int32_t sv_next = npos > 0 ? sy[npos - 1] : 0;
  for (int i = npos - 1; i >= 0 && !enc.overflow; --i) {
    const int32_t ci = ci_next;
    const int32_t sv = sv_next;
    if (i > 0) {
      ci_next = ix[i - 1];
      sv_next = sy[i - 1];
    }
    if (ci < 0 || ci >= ncdf) continue;  // skipped position
    const int32_t max_value = s_size[ci] - 2;
    int32_t value = sv - s_off[ci];
    uint32_t raw_val = 0;
    bool escape = false;
    if (value < 0) {
      raw_val = (uint32_t)(-2 * value - 1);
      value = max_value;
      escape = true;
    } else if (value >= max_value) {
      raw_val = (uint32_t)(2 * (value - max_value));
      value = max_value;
      escape = true;
    }
    if (escape) {
      int n_bypass = 0;
      while (n_bypass < 16 && (raw_val >> (n_bypass * kBypassBits)) != 0) ++n_bypass;
      for (int j = n_bypass - 1; j >= 0; --j) {
        enc.put_raw((raw_val >> (j * kBypassBits)) & kBypassMax);
      }
      enc.put_raw((uint32_t)(n_bypass % (int)kBypassMax));
      for (int t = 0; t < n_bypass / (int)kBypassMax; ++t) enc.put_raw(kBypassMax);
    }
    const int32_t* row = s_cdf + ci * width;
    enc.put((uint32_t)row[value] & 0xffffu,
            (uint32_t)(row[value + 1] - row[value]) & 0xffffu);
  }
  state_out[4 * sid] = enc.x;
  state_out[4 * sid + 1] = enc.pos;
  state_out[4 * sid + 2] = enc.overflow ? 1 : 0;
  state_out[4 * sid + 3] = 0;
}

}  // namespace

extern "C" int sic_rans_encode_plane(
    const void* sym, const void* idx, const void* cdf, const void* sizes,
    const void* offsets, void* words, const void* state_in, void* state_out,
    int S, int npos, int nbytes, int ncdf, int width, void* stream) {
  if (S <= 0 || npos < 0 || nbytes <= 0 || ncdf <= 0 || width < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(int32_t) * ((size_t)ncdf * width + 2 * (size_t)ncdf);
  cudaError_t err = cudaFuncSetAttribute(
      rans_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // at least 128 threads per block, so the table fill is quick even when
  // only a few of them own a substream
  const int threads = 128;
  const int blocks = (S + threads - 1) / threads;
  rans_encode_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)sym, (const int32_t*)idx, (const int32_t*)cdf,
      (const int32_t*)sizes, (const int32_t*)offsets, (uint8_t*)words,
      (const int64_t*)state_in, (int64_t*)state_out, S, npos, nbytes, ncdf,
      width);
  return (int)cudaGetLastError();
}
