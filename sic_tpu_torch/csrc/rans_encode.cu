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
// prepends the final state (ops/rans_encode.py finalize_streams).  A row
// that fills stops at its end (the state out is the one before the byte
// that did not fit) and raises the overflow flag.
//
// What bounds it on the H100: neither bytes nor operations but one warp's
// dependent instruction stream: each coding operation needs the state the
// one before left, and a request has only 4 substreams an image.  A lone
// warp waits out the latency of each dependent instruction, a branch
// around a rare block costs it several times an integer operation, and a
// branch its lanes take apart costs more again (PERF.md), so the chain is
// made short and straight and everything else is moved off it.
// One block per substream, in chunks of 64 positions walked from the
// row's end:
//   * producers (warps 1 and 2, one position a thread) stage the symbols
//     and indexes two chunks ahead (cp.async into a shared ring of four
//     chunks, each thread its own position), look the rows up in the CDF
//     table (in shared memory from one bulk copy on an mbarrier), expand
//     each position into its coding operations, and lay the chunk's
//     operations out in shared memory with a block scan.  Every operation
//     is one formula, x' = x + bias + (umulhi(x, rcp) >> rshift) * cmpl:
//     a coded symbol carries what an exact division by reciprocal needs
//     (the rANS byte coder's precomputed encode symbol), a 2-bit raw chunk
//     and freq = 1 the constants that turn it into x' = (x << n) | val
//     (symbol_op below);
//   * the chain (warp 0, its lanes in lockstep) walks the operations.  A
//     chunk that starts with x in [L, 2^31), where every state a stream
//     reaches lies, and whose bytes fit in the row takes at most two emits
//     an operation, predicated, and the formula: no branch, no integer
//     division and no global load, four operations to a loop trip.  Any
//     other chunk (a state no stream reaches, a row about to fill) takes
//     sic_rans.cc's emit loop and a plain shift, with the cap check;
//   * two slots of operations and mbarriers (full, empty) let the
//     producers build chunk k + 1 while the chain consumes chunk k;
//   * bytes go to a shared-memory ring that the producers flush to the
//     row, in emission order, once the chain is two chunks on.
// The TPU kernel's one-hot MXU gather, packed-row scratch, f32-reciprocal
// division with its correction steps and 8-lane lockstep only dodged TPU
// limits and are not carried over.
#include "rans_common.cuh"

namespace {

using namespace rans;

constexpr int kChunk = 64;      // positions of a chunk, one a producer thread
constexpr int kProducers = 64;  // warps 1 and 2
constexpr int kThreads = 32 + kProducers;
// operations of one position at most: 16 chunks of 2 bits, the
// remainder count, 5 saturating count entries, the symbol
constexpr int kMaxOps = 16 + 1 + 16 / 3 + 1;
constexpr int kSlotOps = kChunk * kMaxOps;
constexpr int kRing = 8192;  // emission ring bytes (two chunks emit < 6 KB)
constexpr uint32_t kShiftRcp = 0xffffffffu;  // marks a shift operation

// Shared memory: the emission ring first (at a fixed address), the staged
// (symbol, index) pairs of 4 chunks, int32 count[2], posend[2],
// wtot[2][2], flushed, fin[3], the barriers; then the table, then two slots
// of operations (and 8 operations of read-ahead past the last).
constexpr size_t kInBytes = 4 * kChunk * 8;
constexpr size_t kMiscBytes = 16 * 4 + 8 * 8;
constexpr size_t kHeadBytes = kRing + kInBytes + kMiscBytes;
constexpr size_t kOpsBytes = (2 * (size_t)kSlotOps + 8) * 16;

// An operation is {x_max, rcp, bias, (cmpl << 16) | rshift}: renormalise
// against x_max, then x' = x + bias + (umulhi(x, rcp) >> rshift) * cmpl.
// A coded symbol (freq >= 2) takes the rANS byte coder's precomputed
// encode symbol: x_max = freq << 15, shift = ceil(log2 freq),
// rcp = ceil(2^(shift + 31) / freq), rshift = shift - 1, bias = start,
// cmpl = 65536 - freq; umulhi(x, rcp) >> rshift is x / freq for every
// x < 2^31.  A shift operation, x' = (x << n) | val (2-bit raw chunks, n =
// 2, x_max = 2^29; freq = 1, n = 16, x_max = 2^15), is the same formula
// with rcp = 2^32 - 1, rshift = 0, cmpl = 2^n - 1 and bias = val + cmpl:
// umulhi(x, 2^32 - 1) = x - 1 for x >= 1, so x' = x 2^n + val.  Every
// state a stream reaches is at least L = 2^23, so x >= 1 holds.
__device__ __forceinline__ uint4 shift_op(uint32_t val, uint32_t n) {
  const uint32_t cmpl = (1u << n) - 1;
  return make_uint4(1u << (31 - n), kShiftRcp, val + cmpl, cmpl << 16);
}

__device__ __forceinline__ uint4 symbol_op(uint32_t start, uint32_t freq) {
  if (freq == 0) return shift_op(start, kBypassBits);  // a range of 0: raw
  if (freq == 1) return shift_op(start, kProbBits);    // x / 1 = x
  const uint32_t shift = 32 - __clz(freq - 1);
  const uint32_t rcp =
      (uint32_t)(((1ull << (shift + 31)) + freq - 1) / freq);
  return make_uint4(freq << 15, rcp, start,
                    (((1u << kProbBits) - freq) << 16) | (shift - 1));
}

__global__ void __launch_bounds__(kThreads)
    rans_encode_kernel(const int32_t* __restrict__ sym,
                       const int32_t* __restrict__ idx,
                       const int32_t* __restrict__ table,
                       uint8_t* __restrict__ words,
                       const int64_t* __restrict__ state_in,
                       int64_t* __restrict__ state_out, int npos, int nbytes,
                       int ncdf, int stride, uint32_t table_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_ring = smem;
  int2* s_in = reinterpret_cast<int2*>(smem + kRing);  // [4][kChunk]
  int32_t* s_count = reinterpret_cast<int32_t*>(s_in + 4 * kChunk);
  uint32_t* s_posend = reinterpret_cast<uint32_t*>(s_count + 2);
  int32_t* s_wtot = s_count + 4;  // [slot][producer warp]
  uint32_t* s_flushed = reinterpret_cast<uint32_t*>(s_count + 8);
  uint32_t* s_fin = s_flushed + 1;  // x, pos, overflow
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_count + 16);
  uint64_t* bar_table = bars;
  uint64_t* bar_full = bars + 1;   // [2], producers -> chain
  uint64_t* bar_empty = bars + 3;  // [2], chain -> producers
  const int32_t* s_cdf = reinterpret_cast<const int32_t*>(smem + kHeadBytes);
  const int32_t* s_size = s_cdf + ncdf * stride;
  const int32_t* s_off = s_size + ncdf;
  uint4* s_ops = reinterpret_cast<uint4*>(smem + kHeadBytes + table_bytes);

  const int tid = threadIdx.x;
  const int sid = blockIdx.x;
  const uint32_t x_in = (uint32_t)state_in[4 * sid];
  const uint32_t pos_in = (uint32_t)state_in[4 * sid + 1];
  if (state_in[4 * sid + 2] != 0 || npos == 0) {  // nothing to code
    if (tid == 0) {
      state_out[4 * sid] = x_in;
      state_out[4 * sid + 1] = pos_in;
      state_out[4 * sid + 2] = state_in[4 * sid + 2] != 0 ? 1 : 0;
      state_out[4 * sid + 3] = 0;
    }
    return;
  }
  uint8_t* row_out = words + (int64_t)sid * nbytes;
  const uint32_t cap = (uint32_t)nbytes;
  const int nchunks = (npos + kChunk - 1) / kChunk;

  if (tid == 0) {
    mbar_init(bar_table, 1);
    mbar_init(&bar_full[0], kProducers);
    mbar_init(&bar_full[1], kProducers);
    mbar_init(&bar_empty[0], 1);
    mbar_init(&bar_empty[1], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 32) {
    // -- the chain ------------------------------------------------------------
    const int lane = tid;
    uint32_t x = x_in, pos = pos_in;
    bool overflow = false;
    for (int k = 0; k < nchunks; ++k) {
      const int slot = k & 1;
      mbar_wait(&bar_full[slot], (k >> 1) & 1);
      const int n = overflow ? 0 : s_count[slot];
      const uint4* ops = s_ops + slot * kSlotOps;
      if (x >= kRansL && x < (1u << 31) && pos + 2u * n <= cap) {
        // The common case: x in [L, 2^31) stays there, so the emit loop
        // runs at most twice, and the chunk's bytes fit.  Every lane
        // stores the same bytes (no branch on the lane).  Four operations
        // at a time, the next four read before this group's byte stores
        // (reads past n fall in the read-ahead and go unused).
        auto code = [&](const uint4& o) {
          const uint32_t a = x >> 8;
          const bool e1 = x >= o.x, e2 = a >= o.x;  // e2 implies e1
          if (e1) s_ring[pos & (kRing - 1)] = (uint8_t)x;
          if (e2) s_ring[(pos + 1) & (kRing - 1)] = (uint8_t)a;
          pos += (uint32_t)e1 + (uint32_t)e2;
          const uint32_t xr = e2 ? x >> 16 : e1 ? a : x;
          const uint32_t q = __funnelshift_r(__umulhi(xr, o.y), 0u, o.w);
          x = xr + o.z + q * (o.w >> 16);
        };
        uint4 op[4], next[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) op[u] = ops[u];
        int j = 0;
        for (; j + 4 <= n; j += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) next[u] = ops[j + 4 + u];
#pragma unroll
          for (int u = 0; u < 4; ++u) code(op[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u) op[u] = next[u];
        }
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          if (j + u < n) code(op[u]);
        }
      } else {
        // Any state, and a row about to fill: sic_rans.cc put_symbol /
        // put_raw_bits as written, stopping at the first byte that does
        // not fit (the state before it is the state out).
        for (int j = 0; j < n; ++j) {
          const uint4 o = ops[j];
          while (x >= o.x) {
            if (pos >= cap) {
              overflow = true;
              break;
            }
            s_ring[pos & (kRing - 1)] = (uint8_t)x;
            ++pos;
            x >>= 8;
          }
          if (overflow) break;
          const uint32_t cmpl = o.w >> 16;
          if (o.y == kShiftRcp) {
            x = (x << (32 - __clz(cmpl))) | (o.z - cmpl);
          } else {
            x = x + o.z + (__umulhi(x, o.y) >> (o.w & 31)) * cmpl;
          }
        }
      }
      if (lane == 0) {
        s_posend[slot] = pos;
        mbar_arrive(&bar_empty[slot]);  // releases the bytes and the slot
      }
    }
    if (lane == 0) {
      s_fin[0] = x;
      s_fin[1] = pos;
      s_fin[2] = overflow ? 1 : 0;
    }
  } else {
    // -- the producers --------------------------------------------------------
    const int t = tid - 32;  // position npos - 1 - k * kChunk - t of chunk k
    const int pw = t >> 5, lane = t & 31;
    const int32_t* sy = sym + (int64_t)sid * npos;
    const int32_t* ix = idx + (int64_t)sid * npos;
    if (t == 0) bulk_load(smem + kHeadBytes, table, table_bytes, bar_table);
    // this thread's (symbol, index) of chunk k -> s_in[k & 3][t], one
    // cp.async group a chunk (empty past the row)
    auto stage = [&](int k) {
      const int p = npos - 1 - k * kChunk - t;
      if (p >= 0) {
        int2* dst = s_in + (k & 3) * kChunk + t;
        cp_async4(&dst->x, sy + p, true);
        cp_async4(&dst->y, ix + p, true);
      }
      cp_async_commit();
    };
    stage(0);
    stage(1);
    mbar_wait(bar_table, 0);
    uint32_t flushed = pos_in;
    for (int k = 0; k < nchunks; ++k) {
      stage(k + 2);
      cp_async_wait<2>();  // chunk k has landed
      const int slot = k & 1;
      // expand this thread's position (sic_rans.cc PartEncoder::encode)
      const bool in_row = npos - 1 - k * kChunk - t >= 0;
      const int2 in = s_in[(k & 3) * kChunk + t];
      const int32_t c = in_row ? in.y : -1;
      const bool live = c >= 0 && c < ncdf;
      int nops = 0, n_bypass = 0;
      bool escape = false;
      uint32_t raw_val = 0;
      uint4 coded = make_uint4(0, 0, 0, 0);
      if (live) {
        const int32_t max_value = s_size[c] - 2;
        int32_t value = in.x - s_off[c];
        if (value < 0) {
          raw_val = (uint32_t)(-2 * (int64_t)value - 1);
          value = max_value;
          escape = true;
        } else if (value >= max_value) {
          raw_val = (uint32_t)(2 * ((int64_t)value - max_value));
          value = max_value;
          escape = true;
        }
        if (escape) n_bypass = raw_val ? (33 - __clz(raw_val)) >> 1 : 0;
        const int32_t* row = s_cdf + c * stride;
        coded = symbol_op((uint32_t)row[value] & 0xffffu,
                          (uint32_t)(row[value + 1] - row[value]) & 0xffffu);
        nops = (escape ? n_bypass + 1 + n_bypass / (int)kBypassMax : 0) + 1;
      }
      // block scan over the 64 producers: warp scans, then warp totals
      int incl = nops;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      if (lane == 31) s_wtot[2 * slot + pw] = incl;
      // one thread waits until the chain is done with chunk k - 2 (its
      // slot is free, its bytes up to posend are final); the others sleep
      // in the named barrier
      if (k >= 2 && t == 0) mbar_wait(&bar_empty[slot], ((k - 2) >> 1) & 1);
      asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
      if (k >= 2) {
        const uint32_t end = s_posend[slot];
        for (uint32_t p = flushed + t; p < end; p += kProducers) {
          row_out[p] = s_ring[p & (kRing - 1)];
        }
        flushed = end;
      }
      const int first = s_wtot[2 * slot];
      int at = incl - nops + (pw == 1 ? first : 0);
      uint4* o = s_ops + slot * kSlotOps;
      if (escape) {
        for (int j = n_bypass - 1; j >= 0; --j) {
          o[at++] = shift_op((raw_val >> (j * kBypassBits)) & kBypassMax,
                             kBypassBits);
        }
        o[at++] = shift_op(n_bypass % kBypassMax, kBypassBits);
        for (int j = 0; j < n_bypass / (int)kBypassMax; ++j) {
          o[at++] = shift_op(kBypassMax, kBypassBits);
        }
      }
      if (live) o[at++] = coded;
      if (t == kProducers - 1) s_count[slot] = first + incl;
      mbar_arrive(&bar_full[slot]);
    }
    cp_async_wait<0>();
    if (t == 0) *s_flushed = flushed;
  }
  __syncthreads();
  // the bytes the producers have not flushed yet, then the state
  const uint32_t end = s_fin[1];
  for (uint32_t p = *s_flushed + tid; p < end; p += kThreads) {
    row_out[p] = s_ring[p & (kRing - 1)];
  }
  if (tid == 0) {
    state_out[4 * sid] = s_fin[0];
    state_out[4 * sid + 1] = end;
    state_out[4 * sid + 2] = s_fin[2];
    state_out[4 * sid + 3] = 0;
  }
}

}  // namespace

extern "C" int sic_rans_encode_plane(
    const void* sym, const void* idx, const void* cdf, const void* sizes,
    const void* offsets, void* words, const void* state_in, void* state_out,
    int S, int npos, int nbytes, int ncdf, int width, void* stream) {
  const uint32_t table_bytes =
      rans_table_bytes(cdf, sizes, offsets, ncdf, width);
  if (S <= 0 || npos < 0 || nbytes <= 0 || table_bytes == 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  const int optin = rans_smem_optin(rans_encode_kernel, &err);
  if (optin == 0) return (int)err;
  const size_t smem = kHeadBytes + table_bytes + kOpsBytes;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  rans_encode_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)sym, (const int32_t*)idx, (const int32_t*)cdf,
      (uint8_t*)words, (const int64_t*)state_in, (int64_t*)state_out, npos,
      nbytes, ncdf, width, table_bytes);
  return (int)cudaGetLastError();
}
