"""torchac-compatible binary arithmetic coder (pure Python/numpy).

The port's own copy of the JAX package's ``entropy/torchac_compat.py``,
with the same functions and names.  The reference codes its semantic-token
(z) stream with the external ``torchac`` package using a uniform CDF over
the TiTok codebook (reference: codec_sq_fixbpp.py:841-846, 861-864,
886-887).  The runtime's own format is a rANS group; this coder lets files
the reference wrote decode in the port, and lets the runtime write that
format on request (``CodecRuntime(z_format="torchac")``).

Wire format (the public torchac algorithm, itself based on nayuki's
reference arithmetic coding): 32-bit low/high state, 16-bit probability
precision, MSB-first bit packing, pending-bit (E3) carry resolution, final
``pending+1`` disambiguation bits, zero-padded tail byte.  CDFs are
quantized as ``torchac._convert_to_int_and_normalize`` does: scale by
``2**16 - (Lp-1)`` in float32, round, then add ``arange(Lp)`` so every
symbol keeps nonzero mass.

A host coder: the z stream is small (32 tokens a 256-px tile, about 0.5 KB
an image), so a Python loop costs little beside the model pass, and no
kernel is warranted.
"""
from __future__ import annotations

import numpy as np

PRECISION = 16
_TOP = 0x1_0000_0000          # 2**32
_MASK = 0xFFFF_FFFF
_HALF = 0x8000_0000
_QUARTER = 0x4000_0000
_THREEQ = 0xC000_0000
_FULL = 0x10000               # 2**PRECISION


def quantize_cdf(cdf_float: np.ndarray, needs_normalization: bool = True) -> np.ndarray:
    """Float CDF row(s) in [0, 1] -> uint16 integer CDF, exactly as
    ``torchac._convert_to_int_and_normalize`` (float32 multiply, round,
    add ``arange`` renormalization; the implicit final 2**16 wraps to 0)."""
    cdf = np.asarray(cdf_float, dtype=np.float32)
    Lp = cdf.shape[-1]
    new_max = float(_FULL - (Lp - 1)) if needs_normalization else float(_FULL)
    out = np.round(cdf * np.float32(new_max)).astype(np.int64)
    if needs_normalization:
        out = out + np.arange(Lp, dtype=np.int64)
    return out.astype(np.uint16)


def uniform_cdf(num_codes: int) -> np.ndarray:
    """The reference's z-stream CDF: ones/K cumsum (codec_sq_fixbpp.py:843-846)."""
    row = np.zeros(num_codes + 1, np.float32)
    row[1:] = np.cumsum(np.full(num_codes, 1.0 / num_codes, np.float32))
    return quantize_cdf(row)


class _BitWriter:
    __slots__ = ("bytes_", "cache", "count")

    def __init__(self):
        self.bytes_ = bytearray()
        self.cache = 0
        self.count = 0

    def append(self, bit: int):
        self.cache = ((self.cache << 1) | bit) & 0xFF
        self.count += 1
        if self.count == 8:
            self.bytes_.append(self.cache)
            self.cache = 0
            self.count = 0

    def append_with_pending(self, bit: int, pending: int) -> int:
        self.append(bit)
        inv = bit ^ 1
        for _ in range(pending):
            self.append(inv)
        return 0

    def flush(self):
        while self.count != 0:
            self.append(0)


class _BitReader:
    __slots__ = ("data", "pos", "cache", "count")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.cache = 0
        self.count = 0

    def get(self, value: int) -> int:
        """value <<= 1 | next_bit (past-the-end reads shift in zeros)."""
        if self.count == 0:
            if self.pos == len(self.data):
                return (value << 1) & _MASK
            self.cache = self.data[self.pos]
            self.pos += 1
            self.count = 8
        self.count -= 1
        return ((value << 1) | ((self.cache >> self.count) & 1)) & _MASK


def _cdf_rows(cdf_int: np.ndarray, n_sym: int):
    """Yield per-symbol CDF rows; a single row broadcasts to all symbols."""
    cdf_int = np.asarray(cdf_int, dtype=np.uint16)
    if cdf_int.ndim == 1:
        return [cdf_int] * n_sym, cdf_int.shape[-1]
    assert cdf_int.shape[0] == n_sym
    return list(cdf_int), cdf_int.shape[-1]


def encode_int16_normalized_cdf(cdf_int: np.ndarray, sym) -> bytes:
    """Symbols + quantized CDF -> torchac byte stream."""
    sym = np.asarray(sym).reshape(-1).astype(np.int64)
    rows, Lp = _cdf_rows(cdf_int, sym.size)
    max_symbol = Lp - 2
    low, high, pending = 0, _MASK, 0
    w = _BitWriter()
    for i, s in enumerate(sym):
        s = int(s)
        row = rows[i]
        c_low = int(row[s])
        c_high = _FULL if s == max_symbol else int(row[s + 1])
        span = high - low + 1
        high = (low - 1 + ((span * c_high) >> PRECISION)) & _MASK
        low = (low + ((span * c_low) >> PRECISION)) & _MASK
        while True:
            if high < _HALF:
                pending = w.append_with_pending(0, pending)
            elif low >= _HALF:
                pending = w.append_with_pending(1, pending)
            elif low >= _QUARTER and high < _THREEQ:
                pending += 1
                low = (low << 1) & 0x7FFF_FFFF
                high = ((high << 1) | 0x8000_0001) & _MASK
                continue
            else:
                break
            low = (low << 1) & _MASK
            high = ((high << 1) | 1) & _MASK
    pending += 1
    if low < _QUARTER:
        w.append_with_pending(0, pending)
    else:
        w.append_with_pending(1, pending)
    w.flush()
    return bytes(w.bytes_)


def decode_int16_normalized_cdf(cdf_int: np.ndarray, stream: bytes,
                                n_sym: int) -> np.ndarray:
    """torchac byte stream -> int16 symbols (n_sym of them)."""
    rows, Lp = _cdf_rows(cdf_int, n_sym)
    max_symbol = Lp - 2
    out = np.empty(n_sym, np.int16)
    low, high, value = 0, _MASK, 0
    r = _BitReader(stream)
    for _ in range(32):
        value = r.get(value)
    for i in range(n_sym):
        row = rows[i]
        span = high - low + 1
        count = ((value - low + 1) * _FULL - 1) // span
        # largest s with cdf[s] <= count (cdf strictly increasing after
        # the arange renormalization; row[0] == 0)
        s = int(np.searchsorted(row[:max_symbol + 1], count, side="right")) - 1
        out[i] = s
        if i == n_sym - 1:
            break
        c_low = int(row[s])
        c_high = _FULL if s == max_symbol else int(row[s + 1])
        high = (low - 1 + ((span * c_high) >> PRECISION)) & _MASK
        low = (low + ((span * c_low) >> PRECISION)) & _MASK
        while True:
            if high < _HALF or low >= _HALF:
                pass
            elif low >= _QUARTER and high < _THREEQ:
                value = (value - _QUARTER) & _MASK
                low -= _QUARTER
                high -= _QUARTER
            else:
                break
            low = (low << 1) & _MASK
            high = ((high << 1) | 1) & _MASK
            value = r.get(value)
    return out


def encode_float_cdf(cdf_float: np.ndarray, sym,
                     needs_normalization: bool = True) -> bytes:
    """torchac.encode_float_cdf equivalent (row broadcast supported)."""
    return encode_int16_normalized_cdf(
        quantize_cdf(cdf_float, needs_normalization), sym)


def decode_float_cdf(cdf_float: np.ndarray, stream: bytes, n_sym: int,
                     needs_normalization: bool = True) -> np.ndarray:
    """torchac.decode_float_cdf equivalent."""
    return decode_int16_normalized_cdf(
        quantize_cdf(cdf_float, needs_normalization), stream, n_sym)


class UniformTorchacCodec:
    """The z-stream compat coder: uniform CDF over ``num_codes`` tokens."""

    def __init__(self, num_codes: int):
        self.num_codes = num_codes
        self._cdf = uniform_cdf(num_codes)

    def encode(self, indices) -> bytes:
        return encode_int16_normalized_cdf(self._cdf, indices)

    def decode(self, stream: bytes, n_sym: int) -> np.ndarray:
        return decode_int16_normalized_cdf(self._cdf, stream, n_sym)
