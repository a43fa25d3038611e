"""rANS in NumPy and plain Python: the quantized CDFs and the decoder of
the port's wire format (a flag byte, the first substreams' sizes, then
each substream; 16-bit probabilities, a 32-bit state renormalised a byte
at a time above 2**23, 2-bit bypass chunks for values past a table's
last regular symbol).  Written from that format, for the benchmark's
check: slow, and exact."""
from __future__ import annotations

import struct

import numpy as np

PROB_BITS = 16
RANS_L = 1 << 23
BYPASS_BITS = 2
BYPASS_MAX = (1 << BYPASS_BITS) - 1


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    """A float PMF -> an integer CDF summing to 2**precision; a slot of
    zero frequency takes a count from the lowest-frequency symbol above 1
    (the reference's integer repair, src/cpp/ops/ops.cpp:24-82)."""
    p = np.asarray(pmf, dtype=np.float64).reshape(-1).astype(np.float32)
    n = p.size
    # std::round (halves away from zero) of the exact float32 product, then
    # + 0.5 and a truncation, which leave the integer as it is
    c = np.zeros(n + 1, np.uint64)
    c[1:] = np.floor(p.astype(np.float64) * (1 << precision) + 0.5).astype(np.uint64)
    total = int(c.sum()) & 0xFFFFFFFF            # a uint32 accumulate
    c = ((np.uint64(1 << precision) * c) // np.uint64(total)).astype(np.int64)
    c = np.cumsum(c)
    c[-1] = 1 << precision
    c = [int(v) for v in c]
    for i in range(n):
        if c[i] == c[i + 1]:
            best_freq, best_steal = None, -1
            for j in range(n):
                f = c[j + 1] - c[j]
                if f > 1 and (best_freq is None or f < best_freq):
                    best_freq, best_steal = f, j
            if best_steal < i:
                for j in range(best_steal + 1, i + 1):
                    c[j] -= 1
            else:
                for j in range(i + 1, best_steal + 1):
                    c[j] += 1
    return np.asarray(c, np.int32)


def split_stream(data: bytes) -> list:
    """A framed stream -> its substreams' bytes."""
    flag = data[0]
    n = (flag >> 4) + 1
    width = 2 if (flag & 0x0F) == 1 else 4
    off = 1
    sizes = []
    for _ in range(n - 1):
        (sz,) = struct.unpack_from("<H" if width == 2 else "<I", data, off)
        off += width
        sizes.append(sz)
    sizes.append(len(data) - off - sum(sizes))
    parts = []
    for sz in sizes:
        if sz < 4 or off + sz > len(data):
            raise ValueError("truncated substream")
        parts.append(data[off:off + sz])
        off += sz
    return parts


class PartDecoder:
    """One substream's decoder, kept across the calls of a stream."""

    def __init__(self, data: bytes):
        self.data = data
        self.x = int.from_bytes(data[:4], "little")
        self.pos = 4

    def _advance(self, start: int, freq: int) -> None:
        x = freq * (self.x >> PROB_BITS) + (self.x & 0xFFFF) - start
        while x < RANS_L and self.pos < len(self.data):
            x = (x << 8) | self.data[self.pos]
            self.pos += 1
        self.x = x

    def _raw(self) -> int:
        val = self.x & BYPASS_MAX
        x = self.x >> BYPASS_BITS
        if x < RANS_L and self.pos < len(self.data):
            x = (x << 8) | self.data[self.pos]
            self.pos += 1
        self.x = x
        return val

    def decode(self, indexes, cdfs, sizes, offsets) -> np.ndarray:
        out = np.zeros(len(indexes), np.int64)
        for i, ci in enumerate(indexes.tolist()):
            if ci < 0:
                continue
            cdf, size = cdfs[ci], sizes[ci]
            max_value = size - 2
            cum = self.x & 0xFFFF
            s = int(np.searchsorted(cdf[1:size], cum, side="right"))
            s = min(s, size - 2)
            self._advance(int(cdf[s]), int(cdf[s + 1] - cdf[s]))
            value = s
            if value == max_value:
                val = self._raw()
                n_bypass = val
                while val == BYPASS_MAX:
                    val = self._raw()
                    n_bypass += val
                raw = 0
                for j in range(n_bypass):
                    raw |= self._raw() << (j * BYPASS_BITS)
                value = raw >> 1
                value = -value - 1 if raw & 1 else value + max_value
            out[i] = value + offsets[ci]
        return out


class StreamDecoder:
    """A framed stream's substreams; :meth:`decode` takes the next
    ``len(indexes)`` positions, split into contiguous parts, one a
    substream (the last takes the remainder)."""

    def __init__(self, data: bytes, cdfs, sizes, offsets):
        self.parts = [PartDecoder(p) for p in split_stream(data)]
        self.cdfs = [np.asarray(r, np.int64) for r in cdfs]
        self.sizes = [int(s) for s in sizes]
        self.offsets = [int(o) for o in offsets]

    def decode(self, indexes) -> np.ndarray:
        idx = np.asarray(indexes).reshape(-1)
        n, k = idx.size, len(self.parts)
        each = n // k
        out = np.zeros(n, np.int64)
        for i, part in enumerate(self.parts):
            lo = each * i
            hi = n if i == k - 1 else lo + each
            out[lo:hi] = part.decode(idx[lo:hi], self.cdfs, self.sizes,
                                     self.offsets)
        return out

    def unfinished(self) -> int:
        """Substreams that did not end where their encoder began: every
        byte read and the state back at 2**23.  A decode that read the
        encoder's CDF rows at every position ends so."""
        return sum(p.pos != len(p.data) or p.x != RANS_L for p in self.parts)
