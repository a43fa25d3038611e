"""zstd frames through the system's libzstd (ctypes).

The CLIP payload of a ``.c2df`` is a zstd frame at level 19.  The JAX
package writes it with the ``zstandard`` package; the port calls the
shared library that package wraps, which every machine it runs on carries
(``libzstd.so.1``), through its simple API: ``ZSTD_compress`` writes the
content size and no checksum, the frame ``zstandard``'s default compressor
writes, byte for byte (``tests/test_torch_compress.py`` compares them).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import threading

_lock = threading.Lock()
_lib = None
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2


def _load():
    global _lib
    with _lock:
        if _lib is None:
            name = ctypes.util.find_library("zstd") or "libzstd.so.1"
            lib = ctypes.CDLL(name)
            size_t = ctypes.c_size_t
            lib.ZSTD_compressBound.argtypes = [size_t]
            lib.ZSTD_compressBound.restype = size_t
            lib.ZSTD_compress.argtypes = [ctypes.c_void_p, size_t, ctypes.c_char_p,
                                          size_t, ctypes.c_int]
            lib.ZSTD_compress.restype = size_t
            lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, size_t,
                                            ctypes.c_char_p, size_t]
            lib.ZSTD_decompress.restype = size_t
            lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p, size_t]
            lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            lib.ZSTD_isError.argtypes = [size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_getErrorName.argtypes = [size_t]
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(lib, n: int) -> int:
    if lib.ZSTD_isError(n):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(n).decode()}")
    return n


def compress(data: bytes, level: int = 19) -> bytes:
    """One zstd frame holding ``data``, with its content size."""
    lib = _load()
    cap = lib.ZSTD_compressBound(len(data))
    buf = ctypes.create_string_buffer(cap)
    n = _check(lib, lib.ZSTD_compress(buf, cap, data, len(data), level))
    return buf.raw[:n]


def decompress(frame: bytes) -> bytes:
    """The content of one zstd frame that records its content size."""
    lib = _load()
    size = lib.ZSTD_getFrameContentSize(frame, len(frame))
    if size in (_CONTENTSIZE_UNKNOWN, _CONTENTSIZE_ERROR):
        raise ValueError("zstd: not a frame with a known content size")
    buf = ctypes.create_string_buffer(max(int(size), 1))
    n = _check(lib, lib.ZSTD_decompress(buf, size, frame, len(frame)))
    return buf.raw[:n]
