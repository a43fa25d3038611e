"""Flat inner-product vector index and its FAISS files.

The port's copy of the building and file side of the JAX package's
``retrieval/index.py`` (reference: src/compress.py:89-114,
src/build.py:71-103).  On-disk formats (both written, both readable, as
the reference does, build.py:95-100):

- new:    ``faiss.index`` + ``paths.json`` + ``meta.json``
- legacy: ``index.faiss`` + ``ids.txt``

The ``.faiss`` / ``.index`` payload is the FAISS ``IndexFlatIP``
serialization (fourcc ``IxFI``).  Search is not ported yet.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_FOURCC_IP = b"IxFI"
_FOURCC_L2 = b"IxF2"
_DUMMY = 1 << 20


def write_flat_index(path, vectors: np.ndarray, metric: str = "ip") -> None:
    """Serialize (N, D) f32 as a FAISS IndexFlat file."""
    v = np.ascontiguousarray(vectors, np.float32)
    n, d = v.shape
    with open(path, "wb") as f:
        f.write(_FOURCC_IP if metric == "ip" else _FOURCC_L2)
        f.write(struct.pack("<i", d))
        f.write(struct.pack("<q", n))
        f.write(struct.pack("<qq", _DUMMY, _DUMMY))
        f.write(struct.pack("<B", 1))                      # is_trained
        f.write(struct.pack("<i", 0 if metric == "ip" else 1))
        f.write(struct.pack("<Q", n * d))                  # float count
        f.write(v.tobytes())


def read_flat_index(path) -> Tuple[np.ndarray, str]:
    """Parse a FAISS IndexFlat file -> ((N, D) f32, metric)."""
    data = Path(path).read_bytes()
    fourcc = data[:4]
    if fourcc not in (_FOURCC_IP, _FOURCC_L2):
        raise ValueError(f"unsupported faiss index type {fourcc!r}")
    off = 4
    (d,) = struct.unpack_from("<i", data, off)
    off += 4
    (n,) = struct.unpack_from("<q", data, off)
    off += 8 + 16 + 1                                      # dummies, is_trained
    (metric_i,) = struct.unpack_from("<i", data, off)
    off += 4
    (count,) = struct.unpack_from("<Q", data, off)
    off += 8
    if count == n * d:            # old layout: vector<float>
        v = np.frombuffer(data, np.float32, count=n * d, offset=off)
    elif count == n * d * 4:      # new layout: vector<uint8> codes
        v = np.frombuffer(data, np.uint8, count=count, offset=off).view(np.float32)
    else:
        raise ValueError(f"flat index size mismatch: {count} vs n*d={n*d}")
    return v.reshape(n, d).copy(), ("ip" if metric_i == 0 else "l2")


class VectorIndex:
    """Incremental flat-IP index with a doc-id list (FaissDB counterpart)."""

    def __init__(self, dim: int, vectors: Optional[np.ndarray] = None,
                 ids: Optional[List[str]] = None):
        self.dim = dim
        self._vecs: List[np.ndarray] = (
            [np.ascontiguousarray(vectors, np.float32)]
            if vectors is not None and len(vectors) else [])
        self.ids: List[str] = list(ids or [])

    def add(self, vec: np.ndarray, doc_id: str) -> None:
        v = np.asarray(vec, np.float32).reshape(1, -1)
        v = v / (np.linalg.norm(v, axis=1, keepdims=True) + 1e-12)
        self._vecs.append(v)
        self.ids.append(doc_id)

    def add_batch(self, vecs: np.ndarray, doc_ids: Sequence[str]) -> None:
        v = np.asarray(vecs, np.float32)
        v = v / (np.linalg.norm(v, axis=1, keepdims=True) + 1e-12)
        self._vecs.append(v)
        self.ids.extend(doc_ids)

    @property
    def ntotal(self) -> int:
        return len(self.ids)

    def vectors(self) -> np.ndarray:
        if not self._vecs:
            return np.zeros((0, self.dim), np.float32)
        if len(self._vecs) > 1:
            self._vecs = [np.concatenate(self._vecs, axis=0)]
        return self._vecs[0]

    def persist(self, index_dir, meta: Optional[dict] = None) -> None:
        """Write both layouts (reference: build.py:95-100)."""
        p = Path(index_dir)
        p.mkdir(parents=True, exist_ok=True)
        v = self.vectors()
        write_flat_index(p / "faiss.index", v)
        (p / "paths.json").write_text(json.dumps(self.ids, ensure_ascii=False))
        (p / "meta.json").write_text(json.dumps(
            meta or {"dim": self.dim, "metric": "ip",
                     "model_id": "ViT-B-32:laion2b_s34b_b79k"},
            ensure_ascii=False))
        write_flat_index(p / "index.faiss", v)
        (p / "ids.txt").write_text("".join(i + "\n" for i in self.ids),
                                   encoding="utf-8")

    @classmethod
    def load(cls, index_dir) -> Tuple["VectorIndex", dict]:
        """Load either layout, the new one first (reference:
        search.py:65-88)."""
        p = Path(index_dir)
        meta = {}
        if (p / "faiss.index").exists():
            v, _ = read_flat_index(p / "faiss.index")
            ids = json.loads((p / "paths.json").read_text()) \
                if (p / "paths.json").exists() else []
            if (p / "meta.json").exists():
                meta = json.loads((p / "meta.json").read_text())
        elif (p / "index.faiss").exists():
            v, _ = read_flat_index(p / "index.faiss")
            ids = [l.strip() for l in (p / "ids.txt").read_text().splitlines()
                   if l.strip()] if (p / "ids.txt").exists() else []
        else:
            raise FileNotFoundError(f"no index found in {index_dir}")
        idx = cls(v.shape[1] if v.size else int(meta.get("dim", 512)),
                  vectors=v, ids=ids)
        return idx, meta
