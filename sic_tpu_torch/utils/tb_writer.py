"""TensorBoard-compatible metrics writer (and reader) with zero deps.

The port's own copy of the JAX package's ``utils/tb_writer.py`` (numpy
only; the port imports nothing of the JAX package).  The reference logs
training scalars/images through Lightning's TensorBoard logger (reference:
codec_sq_fixbpp.py:724-735, 806-819, 832-838); this module writes genuine
TensorBoard event files by hand-encoding the two protos involved (Event,
Summary) and the TFRecord framing (length + masked CRC32C), so
``tensorboard --logdir`` reads them, without tensorflow or tensorboard.

A JSONL mirror (``scalars.jsonl``) is written alongside for dependency-free
consumption (tests, quick plotting, dashboards).
"""
from __future__ import annotations

import json
import os
import socket
import struct
import time
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

# -- CRC32C (Castagnoli, reflected poly 0x82F63B78) — TFRecord checksums ---------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf wire encoding ----------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


# -- proto builders (tensorboard event.proto / summary.proto field numbers) ------

def _summary_value_scalar(tag: str, value: float) -> bytes:
    value_msg = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
    return _f_bytes(1, value_msg)            # Summary.value (repeated)


def _summary_value_image(tag: str, png: bytes, h: int, w: int) -> bytes:
    img = (_f_varint(1, h) + _f_varint(2, w) + _f_varint(3, 3) +
           _f_bytes(4, png))
    value_msg = _f_bytes(1, tag.encode()) + _f_bytes(4, img)
    return _f_bytes(1, value_msg)            # Summary.value (repeated)


def _event(wall_time: float, step: int, summary: Optional[bytes] = None,
           file_version: Optional[str] = None) -> bytes:
    out = _f_double(1, wall_time) + _f_varint(2, step)
    if file_version is not None:
        out += _f_bytes(3, file_version.encode())
    if summary is not None:
        out += _f_bytes(5, summary)
    return out


class MetricsWriter:
    """Scalar/image logger writing TensorBoard event files + a JSONL mirror.

    Usage::

        w = MetricsWriter(log_dir)
        w.scalar("train/loss", 0.5, step=10)
        w.image("val/recon", x_hat[0], step=10)   # (H, W, 3) in [-1, 1]
        trainer.log_fn = w.as_log_fn()
    """

    def __init__(self, log_dir, filename_suffix: str = ""):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        stamp = int(time.time())
        host = socket.gethostname() or "host"
        self._path = (self.log_dir /
                      f"events.out.tfevents.{stamp}.{host}{filename_suffix}")
        self._f = open(self._path, "ab")
        self._jsonl = open(self.log_dir / "scalars.jsonl", "a")
        self._auto_step = 0
        self._write(_event(time.time(), 0, file_version="brain.Event:2"))

    # -- core record IO -----------------------------------------------------------
    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    # -- public API ---------------------------------------------------------------
    def scalar(self, tag: str, value: float, step: int) -> None:
        v = float(value)
        self._write(_event(time.time(), int(step),
                           summary=_summary_value_scalar(tag, v)))
        self._jsonl.write(json.dumps({"tag": tag, "value": v,
                                      "step": int(step)}) + "\n")

    def scalars(self, logs: Dict[str, float], step: int) -> None:
        for k, v in logs.items():
            try:
                self.scalar(k, float(v), step)
            except (TypeError, ValueError):
                continue  # non-numeric entries (stage names etc.)

    def image(self, tag: str, array, step: int) -> None:
        """(H, W, 3) float in [-1, 1] (or [0, 1]) or uint8 -> PNG summary."""
        from PIL import Image
        import io
        a = np.asarray(array)
        if a.dtype != np.uint8:
            lo = float(a.min())
            a = (a + 1.0) * 127.5 if lo < -0.01 else a * 255.0
            a = np.clip(a, 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="PNG")
        h, w = a.shape[:2]
        self._write(_event(time.time(), int(step),
                           summary=_summary_value_image(tag, buf.getvalue(),
                                                        h, w)))

    def as_log_fn(self, step_key: str = "step"):
        """Adapter for ``Trainer.log_fn``: logs every numeric entry, using
        ``logs[step_key]`` when present (else an internal counter)."""
        def log_fn(logs: Dict) -> None:
            step = int(logs.get(step_key, self._auto_step))
            self._auto_step = max(self._auto_step + 1, step + 1)
            self.scalars(logs, step)
            self.flush()
        return log_fn

    def flush(self) -> None:
        self._f.flush()
        self._jsonl.flush()

    def close(self) -> None:
        self._f.close()
        self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- reader (for tests / dependency-free inspection) ------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _parse_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    pos = 0
    while pos < len(buf):
        k, pos = _read_varint(buf, pos)
        field, wire = k >> 3, k & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
            yield field, wire, v
        elif wire == 1:
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        elif wire == 5:
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + n]
            pos += n
        else:
            raise ValueError(f"unsupported wire type {wire}")


def read_events(path) -> Iterator[Dict]:
    """Parse a TensorBoard event file -> dicts with step/wall_time and
    scalar values (images yield tag + png bytes).  Verifies CRCs."""
    data = Path(path).read_bytes()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        header = data[pos:pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        assert _masked_crc(header) == hcrc, "corrupt record header"
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        assert _masked_crc(payload) == pcrc, "corrupt record payload"
        pos += 12 + length + 4

        ev: Dict = {}
        for field, wire, v in _parse_fields(payload):
            if field == 1 and wire == 1:
                ev["wall_time"] = struct.unpack("<d", v)[0]
            elif field == 2 and wire == 0:
                ev["step"] = v
            elif field == 3 and wire == 2:
                ev["file_version"] = v.decode()
            elif field == 5 and wire == 2:
                for f2, w2, v2 in _parse_fields(v):
                    if f2 == 1 and w2 == 2:  # Summary.Value
                        val: Dict = {}
                        for f3, w3, v3 in _parse_fields(v2):
                            if f3 == 1:
                                val["tag"] = v3.decode()
                            elif f3 == 2 and w3 == 5:
                                val["simple_value"] = struct.unpack("<f", v3)[0]
                            elif f3 == 4 and w3 == 2:
                                for f4, w4, v4 in _parse_fields(v3):
                                    if f4 == 4:
                                        val["image_png"] = v4
                        ev.setdefault("values", []).append(val)
        yield ev
