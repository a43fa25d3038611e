// Dependent-chain latency probe for the rANS kernels' chain bound.
//
// Not a kernel of any model path: chip_smoke.py builds it beside the
// kernels and reads, in SM clock cycles, the least latency of one step of
// each rANS chain on this card:
//   * decode: a shared-memory load whose address is the state, then one
//     integer multiply-add on what it loaded (the slot's row entry taken
//     by the state, then x = freq * (x >> 16) + ...);
//   * encode: one high multiply, then one multiply-add
//     (x + bias + umulhi(x, rcp) * cmpl).
// One warp runs `iters` steps of each back to back, unrolled, timed with
// clock64(); the loop's own counter and branch are independent of the
// chain and overlap it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTable = 256;

__global__ void chain_probe_kernel(long long* out, int iters, uint32_t mul,
                                   uint32_t add, uint32_t rcp) {
  __shared__ uint32_t chase[kTable];
  // chase[i] holds the byte offset of the next entry: a cycle through all
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) {
    chase[i] = ((i * 97 + 1) % kTable) * 4;
  }
  __syncthreads();
  const char* base = reinterpret_cast<const char*>(chase);

  uint32_t p = 0;
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < iters; i += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      p = *reinterpret_cast<const volatile uint32_t*>(base + p) * mul + add;
    }
  }
  const long long t1 = clock64();

  uint32_t x = 0x12345678u;
  const long long t2 = clock64();
#pragma unroll 1
  for (int i = 0; i < iters; i += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) x = __umulhi(x, rcp) * mul + add;
  }
  const long long t3 = clock64();

  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = t3 - t2;
    out[2] = iters;
    out[3] = p + x;  // keeps the chains live
  }
}

}  // namespace

// `out`: 4 int64 on the device (decode-step cycles, encode-step cycles,
// steps, a sink).  mul = 1, add = 0, rcp = 0xffffffff keep the values in
// range without the compiler knowing them.
extern "C" int sic_chain_probe(void* out, int iters, void* stream) {
  if (iters <= 0 || iters % 8) return (int)cudaErrorInvalidValue;
  chain_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (long long*)out, iters, 1u, 0u, 0xffffffffu);
  return (int)cudaGetLastError();
}
