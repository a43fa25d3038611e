// rANS plane decode for many independent substreams, for Hopper (sm_90a).
//
// Replaces the TPU kernel sic_tpu/ops/rans_decode.py::_decode_kernel
// (launcher _decode_call): decodes one four-part-prior symbol plane for S
// substreams, bit-exact to the native decoder (cpp/sic_rans.cc:146-229):
// 16-bit probabilities, L = 2^23, byte renormalisation, an index < 0 emits
// 0 and reads nothing, out-of-range symbols escape to 2-bit bypass chunks,
// and the (x, pos) state carries over from plane to plane.
//
// What bounds it on the H100: neither bytes nor operations but one warp's
// dependent instruction stream.  Within a substream every position needs
// the state the previous one left, so a plane costs one step (slot search,
// multiply-add, renormalisation) per coded position back to back, and a
// request has only 4 substreams an image.  A lone warp waits out the
// latency of each dependent instruction, and a branch around a rare block
// costs it several times an integer operation (the rANS findings in
// PERF.md), so the design keeps the step short and straight:
//   * one warp owns one substream (S blocks of 32 threads).  Substreams
//     never share a warp, so one substream's escape loops never stall
//     another's, and the warp's 32 lanes search a row together;
//   * the CDF table lands in shared memory in one bulk copy on an
//     mbarrier, packed by ops/rans_tables.py: rows at a stride of 104
//     entries, those past a row's size above every cum.  The substream's
//     index row (chunks of 256) and stream bytes (segments of 1 KB) are
//     staged in shared-memory rings by cp.async, completed on mbarriers, a
//     chunk or a segment ahead of the cursor.  No global load is left on
//     the chain;
//   * skipped positions cost almost nothing: a window of 32 indexes is read
//     at once, a ballot marks the live ones and their (position, index)
//     pairs go to a list; a window with none is written out as zeros;
//   * the slot search is one step, not a binary search: each lane holds 4
//     of the row's entries (one 16-byte shared load, issued a position
//     ahead, before the state is known), one ballot per entry marks those
//     <= cum = x & 0xffff, and the popcounts less one give the slot (rows
//     are strictly increasing from row[0] = 0, so the count is the C++
//     linear scan's slot); start and the next entry are two shared loads
//     at the slot;
//   * the next two stream bytes are read from the ring before the state
//     is known and the usual renormalisation (at most two bytes) is
//     predicated;
//   * the common step (no escape, at most two refill bytes, the same
//     window and stream segment) is one straight block ending in the
//     back-edge; escapes, longer refills, window flushes, new segments and
//     new index windows share one branch to a rare block;
//   * symbols collect in the lanes' registers, lane l holding position
//     32 w + l, and leave a window at a time in one coalesced store.
// The TPU kernel's one-hot matmul gather, bf16 byte-split table and 8-lane
// lockstep only dodged TPU limits and are not carried over.
#include "rans_common.cuh"

namespace {

using namespace rans;

constexpr int kChunk = 256;  // positions of an index chunk (2 in the ring)
constexpr int kSeg = 1024;   // bytes of a stream segment (4 in the ring)
constexpr int kSegs = 4;
constexpr uint32_t kRingMask = kSeg * kSegs - 1;
constexpr int kBars = 1 + 2 + kSegs;  // table, index chunks, segments
// shared memory: the byte ring, the index ring, a window's list of live
// positions and the barriers first (at fixed addresses), then the table
constexpr size_t kStageBytes = kSeg * kSegs + 2 * kChunk * 4 + 32 * 8 + 64;
static_assert(kBars * 8 <= 64, "barriers");
// Every lane reads its 4 entries of a row, those past the row too (the
// ballots mask them), so the last row's loads reach kMaxStride entries
// past its base: the allocation ends at least that far past it.
constexpr size_t kRowSlack = 4 * kMaxStride;

// A live position's row as the warp holds it: this lane's 4 entries (those
// past the row are 0xffffffff, above every cum: ops/rans_tables.py), the
// row's offset in the table, its escape slot and its symbol offset.
struct Row {
  uint4 v;
  int32_t base;
  int32_t max_value;
  int32_t off;
};

__global__ void __launch_bounds__(32)
    rans_decode_kernel(const int32_t* __restrict__ idx,
                       const uint32_t* __restrict__ words,
                       const int32_t* __restrict__ lengths,
                       const int64_t* __restrict__ state_in,
                       const int32_t* __restrict__ table,
                       int32_t* __restrict__ sym,
                       int64_t* __restrict__ state_out, int npos, int nwords,
                       int ncdf, int stride, uint32_t table_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_bytes = smem;
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem + kSeg * kSegs);
  int2* s_list = reinterpret_cast<int2*>(s_idx + 2 * kChunk);
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_list + 32);
  uint64_t* bar_table = bars;
  uint64_t* bar_idx = bars + 1;
  uint64_t* bar_seg = bars + 3;
  const int32_t* s_cdf = reinterpret_cast<const int32_t*>(smem + kStageBytes);
  const int32_t* s_size = s_cdf + ncdf * stride;
  const int32_t* s_off = s_size + ncdf;

  const int lane = threadIdx.x;
  const int sid = blockIdx.x;
  const int32_t* ix = idx + (int64_t)sid * npos;
  const uint32_t* wrow = words + (int64_t)sid * nwords;
  int32_t* out = sym + (int64_t)sid * npos;
  uint32_t x = (uint32_t)state_in[2 * sid];
  uint32_t pos = (uint32_t)state_in[2 * sid + 1];
  const uint32_t len = (uint32_t)lengths[sid];
  if (npos == 0) {
    if (lane == 0) {
      state_out[2 * sid] = x;
      state_out[2 * sid + 1] = pos;
    }
    return;
  }

  if (lane == 0) {
    mbar_init(bar_table, 1);
    for (int i = 1; i < kBars; ++i) mbar_init(&bars[i], 32);
    mbar_fence_init();
  }
  __syncwarp();
  if (lane == 0) {
    bulk_load(smem + kStageBytes, table, table_bytes, bar_table);
  }

  // index chunk k -> ring slot k & 1; every lane copies 8 words and then
  // arrives when they have landed
  auto load_chunk = [&](int k) {
    int32_t* dst = s_idx + (k & 1) * kChunk;
    for (int e = lane; e < kChunk; e += 32) {
      const int p = k * kChunk + e;
      const bool ok = p < npos;
      cp_async4(dst + e, ix + (ok ? p : 0), ok);
    }
    cp_async_arrive(&bar_idx[k & 1]);
  };
  // stream segment c -> ring slot c & 3 (zeros past the row)
  auto load_seg = [&](uint32_t c) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(s_bytes + (c & 3) * kSeg);
    for (int e = lane; e < kSeg / 4; e += 32) {
      const int64_t w = (int64_t)c * (kSeg / 4) + e;
      const bool ok = w < nwords;
      cp_async4(dst + e, wrow + (ok ? w : 0), ok);
    }
    cp_async_arrive(&bar_seg[c & 3]);
  };
  uint32_t seg_parity = 0;  // bit s: parity of slot s's next phase
  auto wait_seg = [&](uint32_t c) {
    mbar_wait(&bar_seg[c & 3], (seg_parity >> (c & 3)) & 1);
    seg_parity ^= 1u << (c & 3);
  };

  // Segments cur and cur + 1 are in shared memory, cur + 2 is on its way;
  // the byte cursor lies in segment cur.
  uint32_t cur = pos / kSeg;
  const int nchunks = (npos + kChunk - 1) / kChunk;
  load_chunk(0);
  if (nchunks > 1) load_chunk(1);
  load_seg(cur);
  load_seg(cur + 1);
  load_seg(cur + 2);
  mbar_wait(bar_table, 0);
  mbar_wait(&bar_idx[0], 0);
  wait_seg(cur);
  wait_seg(cur + 1);

  // Keeps the byte at `p` (the cursor or just past it) and the next one
  // in shared memory: on entering a new segment, waits for the one after
  // it and sends for the one after that into the slot of the dead one.
  auto ensure = [&](uint32_t p) {
    while (p >= (cur + 1) * kSeg) {
      ++cur;
      wait_seg(cur + 1);
      load_seg(cur + 2);
    }
  };
  auto byte_at = [&](uint32_t p) -> uint32_t {
    return s_bytes[p & kRingMask];
  };
  // sic_rans.cc get_raw_bits(): kBypassBits raw bits, at most one refill
  // byte, read without a branch.  The caller keeps that byte in shared
  // memory: after ensure(pos) at least kSeg bytes past pos are, so the
  // escape's loops call ensure again every kSeg reads.
  auto raw_bits = [&]() -> uint32_t {
    const uint32_t val = x & kBypassMax;
    x >>= kBypassBits;
    const bool need = x < kRansL && pos < len;
    const uint32_t b = byte_at(pos);
    x = need ? (x << 8) | b : x;
    pos += need;
    return val;
  };

  // The live positions, in order.  A window of 32 positions at a time:
  // each lane reads one index from the ring, a ballot marks the live ones
  // and each live lane writes (position, index) at its rank into a list;
  // a window with none is written out as zeros at once.  The first window
  // of a chunk waits for the chunk and sends for the next one (into the
  // slot of the chunk before, which no one reads any more).  After the
  // last live position, pop() gives npos.
  int gw = -32;  // the window's first position
  int gi = 0;    // the next list entry to hand out
  int gn = 0;    // the window's live positions
  auto refill = [&]() {
    while (gi == gn) {
      gw += 32;
      if (gw >= npos) {
        gw = npos;
        gi = gn = 0;
        return;
      }
      if ((gw & (kChunk - 1)) == 0 && gw > 0) {
        const int k = gw / kChunk;
        mbar_wait(&bar_idx[k & 1], (k >> 1) & 1);
        if (k + 1 < nchunks) load_chunk(k + 1);
      }
      const int q = gw + lane;
      const int32_t c = q < npos ? s_idx[q & (2 * kChunk - 1)] : -1;
      const bool live = c >= 0 && c < ncdf;
      const uint32_t m = __ballot_sync(kFull, live);  // (the last reads of
      // the list are done: a ballot converges the warp)
      if (live) s_list[__popc(m & ((1u << lane) - 1))] = make_int2(q, c);
      __syncwarp();
      gi = 0;
      gn = __popc(m);
      if (gn == 0 && q < npos) out[q] = 0;
    }
  };
  auto pop = [&](int& p, int32_t& ci) {
    const int2 e = s_list[gi & 31];
    const bool ok = gi < gn;
    p = ok ? e.x : npos;
    ci = ok ? e.y : 0;
    gi += ok;
  };

  // a row's loads, issued a position ahead
  const bool lane_in = 4 * lane < stride;
  auto load_row = [&](int32_t ci, Row& r) {
    r.base = ci * stride;
    r.v = *reinterpret_cast<const uint4*>(s_cdf + r.base + 4 * lane);
    r.max_value = s_size[ci] - 2;
    r.off = s_off[ci];
  };

  // The loop over the live positions.  On this card a branch around a
  // rare block costs a lone warp dearly, so the common path
  // (no escape, at most two refill bytes, the same window and stream
  // segment, no new window of indexes) is one straight block that ends in
  // the back-edge; everything else is one branch to the rare block.
  int p, pn;
  int32_t ci;
  refill();
  pop(p, ci);
  if (p < npos) {
    Row r, rn;
    load_row(ci, r);
    if (gi == gn) refill();
    pop(pn, ci);
    // the loop's first pop must find the list non-empty unless no live
    // position is left (as every trip leaves it): pn may have been the last
    // entry of its window
    if (gi == gn) refill();
    int32_t mine = 0;  // lane l: the symbol of position 32 w + l
    for (;;) {
      // position pn's row and the live position after it: loads only
      const uint32_t b0 = byte_at(pos), b1 = byte_at(pos + 1);
      const bool more = pn < npos;
      load_row(ci, rn);
      int pnn;
      int32_t cinn;
      pop(pnn, cinn);
      // slot search: s = #{k in [1, size-1] : row[k] <= cum}; row[0] is 0,
      // so it is the count over the whole row less one, one ballot per
      // entry of the lanes' quadruples
      const uint32_t cum = x & kMask;
      const uint32_t s =
          __popc(__ballot_sync(kFull, lane_in && r.v.x <= cum)) +
          __popc(__ballot_sync(kFull, lane_in && r.v.y <= cum)) +
          __popc(__ballot_sync(kFull, lane_in && r.v.z <= cum)) +
          __popc(__ballot_sync(kFull, lane_in && r.v.w <= cum)) - 1;
      const uint32_t start = (uint32_t)s_cdf[r.base + s];
      const uint32_t freq = (uint32_t)s_cdf[r.base + s + 1] - start;
      // sic_rans.cc advance(): consume (start, freq), refill while x < L;
      // the first two bytes without a branch
      x = freq * (x >> kProbBits) + (cum - start);
      const bool n1 = x < kRansL && pos < len;
      x = n1 ? (x << 8) | b0 : x;
      const bool n2 = n1 && x < kRansL && pos + 1 < len;
      x = n2 ? (x << 8) | b1 : x;
      pos += (uint32_t)n1 + (uint32_t)n2;
      if (lane == (p & 31)) mine = (int32_t)s + r.off;
      const bool slow = n2 && x < kRansL && pos < len;
      const bool escape = (int32_t)s == r.max_value;
      // the window is done when the next live position lies past it
      const bool flush = !more || ((pn ^ p) >> 5) != 0;
      if (!(slow || escape || flush || pos >= (cur + 1) * kSeg || gi == gn)) {
        r = rn;
        p = pn;
        pn = pnn;
        ci = cinn;
        continue;
      }
      if (slow) {  // more refill bytes
        do {
          ensure(pos);
          x = (x << 8) | byte_at(pos++);
        } while (x < kRansL && pos < len);
      }
      if (escape) {  // warp-uniform bypass loops
        ensure(pos);
        uint32_t val, n_bypass = 0;
        for (;;) {
          int k = 0;
          do {
            val = raw_bits();
            n_bypass += val;
          } while (val == kBypassMax && ++k < kSeg);
          if (val != kBypassMax) break;
          ensure(pos);
        }
        uint32_t raw_val = 0;
        for (uint32_t j = 0; j < n_bypass;) {
          ensure(pos);
          for (const uint32_t stop = min(n_bypass, j + kSeg); j < stop; ++j) {
            const uint32_t bits = raw_bits();
            if (j < 32 / kBypassBits) raw_val |= bits << (j * kBypassBits);
          }
        }
        int32_t value = (int32_t)(raw_val >> 1);
        value = (raw_val & 1) ? -value - 1 : value + r.max_value;
        if (lane == (p & 31)) mine = value + r.off;
      }
      if (flush) {  // 32 symbols (zeros where skipped), one coalesced store
        const int q = (p & ~31) + lane;
        if (q < npos) out[q] = mine;
        mine = 0;
      }
      ensure(pos);
      if (gi == gn) refill();
      if (!more) break;
      r = rn;
      p = pn;
      pn = pnn;
      ci = cinn;
    }
  }

  // Every index chunk sent for was waited for (refill reads every window);
  // segment cur + 2 is still in flight: let it land before the block's
  // shared memory goes.
  wait_seg(cur + 2);
  if (lane == 0) {
    state_out[2 * sid] = x;
    state_out[2 * sid + 1] = pos;
  }
}

}  // namespace

extern "C" int sic_rans_decode_plane(
    const void* idx, const void* words, const void* lengths,
    const void* state_in, const void* cdf, const void* sizes,
    const void* offsets, void* sym, void* state_out, int S, int npos,
    int nwords, int ncdf, int width, void* stream) {
  const uint32_t table_bytes =
      rans_table_bytes(cdf, sizes, offsets, ncdf, width);
  if (S <= 0 || npos < 0 || nwords <= 0 || table_bytes == 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  const int optin = rans_smem_optin(rans_decode_kernel, &err);
  if (optin == 0) return (int)err;
  const size_t smem = table_bytes + kStageBytes + kRowSlack;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  rans_decode_kernel<<<S, 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const uint32_t*)words, (const int32_t*)lengths,
      (const int64_t*)state_in, (const int32_t*)cdf, (int32_t*)sym,
      (int64_t*)state_out, npos, nwords, ncdf, width, table_bytes);
  return (int)cudaGetLastError();
}
