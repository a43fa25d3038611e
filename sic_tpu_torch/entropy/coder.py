"""Host-side rANS entropy coder (numpy-facing ctypes wrapper).

The device computes symbols, scales and CDF-table indexes; this module only
moves int16 planes across the host boundary and into the native coder.  Wire format matches the reference coder so ``.c2df`` streams
interoperate (reference: src/entropy/entropy_models.py:32-94).
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..cpp.build import load_library

_SYMBOL_CLIP = 30000  # int16 guard band (reference: entropy_models.py:67)


def _i16(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).reshape(-1)).astype(np.int16, copy=False)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    """Quantize a float PMF to an integer CDF summing to 2**precision.

    Zero-frequency slots are repaired by stealing counts from the
    lowest-frequency symbol (native implementation; integer-identical to the
    reference, src/cpp/ops/ops.cpp:24-82).
    """
    lib = load_library()
    p = np.ascontiguousarray(np.asarray(pmf, dtype=np.float64).reshape(-1))
    out = np.empty(p.size + 1, dtype=np.uint32)
    lib.sic_pmf_to_quantized_cdf(
        _ptr(p, ctypes.c_double), np.int32(p.size), np.int32(precision),
        _ptr(out, ctypes.c_uint32))
    return out.astype(np.int32)


class RansEncoder:
    """Buffering rANS encoder over ``stream_part`` parallel substreams."""

    def __init__(self, stream_part: int = 1):
        self._lib = load_library()
        self._h = self._lib.sic_enc_new(int(stream_part))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sic_enc_free(self._h)
            self._h = None

    def add_cdf(self, cdfs: np.ndarray, cdf_sizes: np.ndarray, offsets: np.ndarray) -> int:
        cdfs = np.ascontiguousarray(np.asarray(cdfs, dtype=np.int32))
        sizes = np.ascontiguousarray(np.asarray(cdf_sizes, dtype=np.int32).reshape(-1))
        offs = np.ascontiguousarray(np.asarray(offsets, dtype=np.int32).reshape(-1))
        ncdf, width = cdfs.shape
        return self._lib.sic_enc_add_cdf(
            self._h, _ptr(cdfs, ctypes.c_int32), np.int32(ncdf), np.int32(width),
            _ptr(sizes, ctypes.c_int32), _ptr(offs, ctypes.c_int32))

    def encode_with_indexes(self, symbols, indexes, cdf_group_index: int) -> None:
        s = _i16(np.clip(np.asarray(symbols).reshape(-1), -_SYMBOL_CLIP, _SYMBOL_CLIP))
        i = _i16(indexes)
        assert s.size == i.size
        self._lib.sic_enc_encode_with_indexes(
            self._h, _ptr(s, ctypes.c_int16), _ptr(i, ctypes.c_int16),
            np.int64(s.size), int(cdf_group_index))

    def flush(self) -> None:
        self._lib.sic_enc_flush(self._h)

    def get_encoded_stream(self) -> bytes:
        n = self._lib.sic_enc_stream_size(self._h)
        out = np.empty(n, dtype=np.uint8)
        if n:
            self._lib.sic_enc_get_stream(self._h, _ptr(out, ctypes.c_uint8))
        return out.tobytes()

    def reset(self) -> None:
        self._lib.sic_enc_reset(self._h)


class RansDecoder:
    def __init__(self, stream_part: int = 1):
        self._lib = load_library()
        self._h = self._lib.sic_dec_new(int(stream_part))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sic_dec_free(self._h)
            self._h = None

    def add_cdf(self, cdfs: np.ndarray, cdf_sizes: np.ndarray, offsets: np.ndarray) -> int:
        cdfs = np.ascontiguousarray(np.asarray(cdfs, dtype=np.int32))
        sizes = np.ascontiguousarray(np.asarray(cdf_sizes, dtype=np.int32).reshape(-1))
        offs = np.ascontiguousarray(np.asarray(offsets, dtype=np.int32).reshape(-1))
        ncdf, width = cdfs.shape
        return self._lib.sic_dec_add_cdf(
            self._h, _ptr(cdfs, ctypes.c_int32), np.int32(ncdf), np.int32(width),
            _ptr(sizes, ctypes.c_int32), _ptr(offs, ctypes.c_int32))

    def set_stream(self, stream: bytes) -> None:
        data = np.frombuffer(stream, dtype=np.uint8)
        data = np.ascontiguousarray(data)
        rc = self._lib.sic_dec_set_stream(self._h, _ptr(data, ctypes.c_uint8),
                                          np.int64(data.size))
        if rc < 0:
            raise ValueError("invalid rANS stream")

    def decode_stream(self, indexes, cdf_group_index: int) -> np.ndarray:
        i = _i16(indexes)
        out = np.empty(i.size, dtype=np.int16)
        self._lib.sic_dec_decode_stream(
            self._h, _ptr(i, ctypes.c_int16), np.int64(i.size),
            int(cdf_group_index), _ptr(out, ctypes.c_int16))
        return out


class EntropyCoder:
    """Paired encoder/decoder sharing registered CDF groups.

    Mirrors the reference session object (reference: entropy_models.py:32-94)
    but is numpy-native and torch-free.
    """

    def __init__(self, stream_part: int = 1):
        self.encoder = RansEncoder(stream_part)
        self.decoder = RansDecoder(stream_part)

    def add_cdf(self, cdf, cdf_length, offset) -> int:
        enc_idx = self.encoder.add_cdf(cdf, cdf_length, offset)
        dec_idx = self.decoder.add_cdf(cdf, cdf_length, offset)
        assert enc_idx == dec_idx
        return enc_idx

    def reset(self) -> None:
        self.encoder.reset()

    def encode_with_indexes(self, symbols, indexes, cdf_group_index: int) -> None:
        self.encoder.encode_with_indexes(symbols, indexes, cdf_group_index)

    def flush(self) -> None:
        self.encoder.flush()

    def get_encoded_stream(self) -> bytes:
        return self.encoder.get_encoded_stream()

    def set_stream(self, stream: bytes) -> None:
        self.decoder.set_stream(stream)

    def decode_stream(self, indexes, cdf_group_index: int) -> np.ndarray:
        return self.decoder.decode_stream(indexes, cdf_group_index)
