"""Build + load the native rANS library.

Compiles ``sic_rans.cc`` into a shared object with the host toolchain on
first use and caches it next to the source keyed by a content hash, so tests
and CLIs never pay the compile twice.  No pybind11: the library exposes a
plain C ABI consumed through ctypes (see ``sic_tpu_torch/entropy/coder.py``).
The source is the port's own copy of the JAX package's coder; the build
directory ``_build/`` is git-ignored.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).parent / "sic_rans.cc"
_BUILD_DIR = Path(__file__).parent / "_build"
_lock = threading.Lock()
_cached_lib = None

_CXX_FLAGS = [
    "-O3",
    "-std=c++17",
    "-shared",
    "-fPIC",
    "-pthread",
    "-Wall",
    "-Wextra",
]


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libsic_rans_{digest}.so"


def _compile(out: Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX", "g++")
    tmp = out.with_suffix(".so.tmp")
    cmd = [cxx, *(_CXX_FLAGS), str(_SRC), "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    tmp.replace(out)


def load_library() -> ctypes.CDLL:
    """Return the (lazily compiled) native library with typed signatures."""
    global _cached_lib
    if _cached_lib is not None:
        return _cached_lib
    with _lock:
        if _cached_lib is not None:
            return _cached_lib
        path = _lib_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))

        c = ctypes
        i16p = c.POINTER(c.c_int16)
        i32p = c.POINTER(c.c_int32)
        u8p = c.POINTER(c.c_uint8)
        u32p = c.POINTER(c.c_uint32)
        f64p = c.POINTER(c.c_double)

        lib.sic_enc_new.restype = c.c_void_p
        lib.sic_enc_new.argtypes = [c.c_int]
        lib.sic_enc_free.argtypes = [c.c_void_p]
        lib.sic_enc_add_cdf.restype = c.c_int
        lib.sic_enc_add_cdf.argtypes = [c.c_void_p, i32p, c.c_int32, c.c_int32, i32p, i32p]
        lib.sic_enc_encode_with_indexes.argtypes = [c.c_void_p, i16p, i16p, c.c_int64, c.c_int]
        lib.sic_enc_flush.argtypes = [c.c_void_p]
        lib.sic_enc_stream_size.restype = c.c_int64
        lib.sic_enc_stream_size.argtypes = [c.c_void_p]
        lib.sic_enc_get_stream.argtypes = [c.c_void_p, u8p]
        lib.sic_enc_reset.argtypes = [c.c_void_p]

        lib.sic_dec_new.restype = c.c_void_p
        lib.sic_dec_new.argtypes = [c.c_int]
        lib.sic_dec_free.argtypes = [c.c_void_p]
        lib.sic_dec_add_cdf.restype = c.c_int
        lib.sic_dec_add_cdf.argtypes = [c.c_void_p, i32p, c.c_int32, c.c_int32, i32p, i32p]
        lib.sic_dec_set_stream.restype = c.c_int
        lib.sic_dec_set_stream.argtypes = [c.c_void_p, u8p, c.c_int64]
        lib.sic_dec_decode_stream.argtypes = [c.c_void_p, i16p, c.c_int64, c.c_int, i16p]

        lib.sic_pmf_to_quantized_cdf.argtypes = [f64p, c.c_int32, c.c_int32, u32p]

        _cached_lib = lib
        return lib
