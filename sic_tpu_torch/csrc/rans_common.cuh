// Shared pieces of the rANS plane kernels (rans_decode.cu, rans_encode.cu)
// for Hopper (sm_90a): the coder's constants, the asynchronous copies they
// stage their inputs with (on mbarrier.cuh's barriers), and the one-time
// opt-in to large dynamic shared memory.
//
// Both kernels hold the CDF table in shared memory as one packed block
// (ops/rans_tables.py): `ncdf` rows of `stride` int32 (the row width
// rounded up to 4, so one lane reads 4 entries with one 16-byte load),
// then the `ncdf` row sizes, then the `ncdf` offsets, padded to 16 bytes.
// It arrives in one bulk copy (cp.async.bulk) completed on an mbarrier.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace rans {

using namespace sic_mbar;

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kMask = (1u << kProbBits) - 1;
constexpr uint32_t kRansL = 1u << 23;
constexpr uint32_t kBypassBits = 2;
constexpr uint32_t kBypassMax = (1u << kBypassBits) - 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxStride = 128;  // 32 lanes x 4 entries

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// -- asynchronous copies -----------------------------------------------------

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory in one bulk copy; the arriving thread also announces
// the bytes to `bar`, whose phase completes when they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One 4-byte word from global to shared memory, asynchronously; a word
// that is not `valid` is filled with zeros and nothing is read.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed cp.async groups are
// still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Arrives on `bar` once every cp.async this thread issued so far has
// landed (the barrier counts this arrival among those it was set up for).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

}  // namespace rans

// Host side: lets `kernel` use the device's whole opt-in shared memory,
// once per device and process; returns that size in bytes, or 0 with the
// CUDA error in `err`.
template <typename Kernel>
static int rans_smem_optin(Kernel kernel, cudaError_t* err) {
  static int optin[64] = {0};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess || dev < 0 || dev >= 64) {
    if (*err == cudaSuccess) *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (optin[dev] == 0) {
    int bytes = 0;
    *err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (*err != cudaSuccess) return 0;
    *err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (*err != cudaSuccess) return 0;
    optin[dev] = bytes;
  }
  return optin[dev];
}

// The packed table's layout check: rows of `stride` int32 (a multiple of
// 4, at most kMaxStride), then sizes, then offsets, back to back from a
// 16-byte-aligned start.  Returns the bytes one bulk copy moves, or 0.
static uint32_t rans_table_bytes(const void* cdf, const void* sizes,
                                 const void* offsets, int ncdf, int stride) {
  if (ncdf <= 0 || stride < 4 || stride > rans::kMaxStride || stride % 4 ||
      reinterpret_cast<uintptr_t>(cdf) % 16) {
    return 0;
  }
  const char* base = static_cast<const char*>(cdf);
  if (static_cast<const char*>(sizes) != base + 4ll * ncdf * stride ||
      static_cast<const char*>(offsets) != base + 4ll * ncdf * (stride + 1)) {
    return 0;
  }
  const long long bytes = 4ll * ncdf * (stride + 2);
  return static_cast<uint32_t>((bytes + 15) / 16 * 16);
}
