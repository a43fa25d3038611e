"""The ``.c2df`` searchable-bitstream container (binary TLV format).

Byte-compatible with the reference format (reference: src/filemaker.py:75-173).
A file is laid out as::

    b"C2DF" | u16 version | u32 header_json_len | header JSON (utf-8)
    | u32 item_count
    | repeat: u16 key_len | key | u8 type_tag | [u32 payload_len] | payload

Fixed-size scalar tags (INT / FLOAT / BOOL / NONE) omit the u32 payload-length
word; everything else carries it.  Numpy payloads embed their own
``dtype-str | ndim | u32 dims... | u32 nbytes | raw bytes`` sub-header.

Keys ending in ``_shape`` are canonicalised to int32 ndarrays and keys ending
in ``_length`` (plus a few aliases) to i64 scalars, mirroring the reference's
special-casing so that round-tripping a reference file is byte-identical.

This module needs only numpy: values may be numpy arrays, CPU tensors, python
scalars, bytes, strings, lists or dicts.  It is the PyTorch port's own copy
of the JAX package's container module; the two write identical bytes.
"""
from __future__ import annotations

import io
import json
import struct
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

from ..utils.profiling import timed_stage

T_BYTES = 0
T_STR = 1
T_INT = 2
T_FLOAT = 3
T_JSON = 4
T_NP = 5
T_NONE = 6
T_BOOL = 7

# Keys forced to canonical numeric encodings (reference: src/filemaker.py:22, 35).
_SHAPE_KEYS = {"z_indeices_shape", "h_indices_shape", "y_shape", "x_shape"}
_LENGTH_KEYS = {"token_length", "num_tokens", "n_tokens"}

MAGIC = b"C2DF"
DEFAULT_VERSION = 2


def _to_numpy(x: Any):
    if isinstance(x, np.ndarray):
        return x
    # CPU tensors (and anything else exposing __array__).
    if hasattr(x, "__array__") and not isinstance(x, (list, tuple, dict, str, bytes)):
        try:
            return np.asarray(x)
        except Exception:
            return None
    return None


def _pack_ndarray(arr: np.ndarray) -> bytes:
    dtype_s = arr.dtype.str.encode("utf-8")
    data_b = arr.tobytes(order="C")
    parts = [struct.pack("<B", len(dtype_s)), dtype_s, struct.pack("<B", arr.ndim)]
    for d in arr.shape:
        parts.append(struct.pack("<I", int(d)))
    parts.append(struct.pack("<I", len(data_b)))
    parts.append(data_b)
    return b"".join(parts)


def _dump_entry(key: str, val: Any) -> Tuple[bytes, int, bytes]:
    k = key.encode("utf-8")
    if key in _SHAPE_KEYS or key.endswith("_shape"):
        arr = np.asarray(val, dtype=np.int32)
        return k, T_NP, _pack_ndarray(arr)
    if key in _LENGTH_KEYS or key.endswith("_length"):
        return k, T_INT, struct.pack("<q", int(val))

    if val is None:
        return k, T_NONE, b""
    if isinstance(val, (bool, np.bool_)):
        return k, T_BOOL, struct.pack("<B", 1 if val else 0)
    if isinstance(val, (int, np.integer)):
        return k, T_INT, struct.pack("<q", int(val))
    if isinstance(val, (float, np.floating)):
        return k, T_FLOAT, struct.pack("<d", float(val))
    if isinstance(val, (bytes, bytearray, memoryview)):
        b = bytes(val)
        return k, T_BYTES, struct.pack("<I", len(b)) + b
    if isinstance(val, str):
        b = val.encode("utf-8")
        return k, T_STR, struct.pack("<I", len(b)) + b

    arr = _to_numpy(val)
    if arr is not None:
        return k, T_NP, _pack_ndarray(arr)

    if isinstance(val, (list, dict)):
        jb = json.dumps(val, ensure_ascii=False).encode("utf-8")
        return k, T_JSON, struct.pack("<I", len(jb)) + jb

    s = str(val).encode("utf-8")
    return k, T_STR, struct.pack("<I", len(s)) + s


def pack_c2df(enc_result: Dict[str, Any], header: Dict[str, Any]) -> bytes:
    """Serialize an encode-result dict + header dict into a ``.c2df`` blob."""
    with timed_stage(None, "c2df.pack"):
        return _pack(enc_result, header)


def _pack(enc_result: Dict[str, Any], header: Dict[str, Any]) -> bytes:
    blob = io.BytesIO()
    ver = int(header.get("version", DEFAULT_VERSION))
    blob.write(MAGIC)
    blob.write(struct.pack("<H", ver))

    hb = json.dumps(header, ensure_ascii=False).encode("utf-8")
    blob.write(struct.pack("<I", len(hb)))
    blob.write(hb)

    items = list(enc_result.items())
    blob.write(struct.pack("<I", len(items)))
    for key, val in items:
        k_b, tag, payload = _dump_entry(key, val)
        blob.write(struct.pack("<H", len(k_b)))
        blob.write(k_b)
        blob.write(struct.pack("<B", tag))
        if tag in (T_INT, T_FLOAT, T_BOOL, T_NONE):
            blob.write(payload)
        else:
            blob.write(struct.pack("<I", len(payload)))
            blob.write(payload)
    return blob.getvalue()


def _load_entry(tag: int, payload: bytes) -> Any:
    if tag == T_NONE:
        return None
    if tag == T_BOOL:
        return bool(payload[0])
    if tag == T_INT:
        return struct.unpack_from("<q", payload, 0)[0]
    if tag == T_FLOAT:
        return struct.unpack_from("<d", payload, 0)[0]
    if tag == T_BYTES:
        (length,) = struct.unpack_from("<I", payload, 0)
        return payload[4 : 4 + length]
    if tag == T_STR:
        (length,) = struct.unpack_from("<I", payload, 0)
        return payload[4 : 4 + length].decode("utf-8")
    if tag == T_JSON:
        (length,) = struct.unpack_from("<I", payload, 0)
        return json.loads(payload[4 : 4 + length].decode("utf-8"))
    if tag == T_NP:
        off = 0
        dt_len = payload[off]
        off += 1
        dt = payload[off : off + dt_len].decode("utf-8")
        off += dt_len
        ndim = payload[off]
        off += 1
        shape = []
        for _ in range(ndim):
            (d,) = struct.unpack_from("<I", payload, off)
            off += 4
            shape.append(int(d))
        (data_len,) = struct.unpack_from("<I", payload, off)
        off += 4
        data = payload[off : off + data_len]
        return np.frombuffer(data, dtype=np.dtype(dt)).reshape(shape)
    raise ValueError(f"unknown c2df type tag: {tag}")


def unpack_c2df(src) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Parse a ``.c2df`` path/bytes into ``(enc_result, header)`` dicts."""
    with timed_stage(None, "c2df.unpack"):
        return _unpack(src)


def _unpack(src) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    if isinstance(src, (str, Path)):
        data = Path(src).read_bytes()
    else:
        data = bytes(src)

    if data[:4] != MAGIC:
        raise ValueError("bad c2df magic")
    off = 4
    (_ver,) = struct.unpack_from("<H", data, off)
    off += 2
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    header = json.loads(data[off : off + hlen].decode("utf-8")) if hlen > 0 else {}
    off += hlen

    (n_items,) = struct.unpack_from("<I", data, off)
    off += 4
    enc_result: Dict[str, Any] = {}
    for _ in range(n_items):
        (klen,) = struct.unpack_from("<H", data, off)
        off += 2
        key = data[off : off + klen].decode("utf-8")
        off += klen
        tag = data[off]
        off += 1
        if tag in (T_INT, T_FLOAT):
            payload = data[off : off + 8]
            off += 8
        elif tag == T_BOOL:
            payload = data[off : off + 1]
            off += 1
        elif tag == T_NONE:
            payload = b""
        else:
            (length,) = struct.unpack_from("<I", data, off)
            off += 4
            payload = data[off : off + length]
            off += length
        enc_result[key] = _load_entry(tag, payload)
    return enc_result, header


def _as_int_list(x) -> list:
    if isinstance(x, np.ndarray):
        return [int(v) for v in x.tolist()]
    if isinstance(x, (list, tuple)):
        return [int(v) for v in x]
    if isinstance(x, (np.integer, int)):
        return [int(x)]
    return [int(x)]


def sanitize_enc_result_types(enc: Dict[str, Any]) -> Dict[str, Any]:
    """Coerce unpacked shape/length fields back to python tuples/ints.

    Mirrors the CLI-side canonicalisation of the reference
    (reference: src/decompress.py:68-77).
    """
    shape_keys = {"z_indices_shape", "h_indices_shape", "y_shape", "x_shape"}
    len_keys = {"token_length", "num_tokens", "n_tokens", "length"}
    out = dict(enc)
    for k, v in list(out.items()):
        if k.endswith("_shape") or k in shape_keys:
            out[k] = tuple(_as_int_list(v))
        elif k.endswith("_length") or k in len_keys:
            out[k] = int(_as_int_list(v)[0])
    return out
