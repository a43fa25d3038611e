"""Flat inner-product vector index: device-resident search and FAISS files.

The port of the JAX package's ``retrieval/index.py`` (reference:
src/compress.py:89-114, src/build.py:71-103, src/search.py:65-120).  Search
scores every query against every vector in one product on the index's
device, with both sides rounded to bfloat16 as the JAX package scores them,
and takes the top k, ties to the lower index.  On-disk formats (both
written, both readable, as the reference does, build.py:95-100):

- new:    ``faiss.index`` + ``paths.json`` + ``meta.json``
- legacy: ``index.faiss`` + ``ids.txt``

The ``.faiss`` / ``.index`` payload is the FAISS ``IndexFlatIP``
serialization (fourcc ``IxFI``).
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.codec import resolve_device

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


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the same values rounded to bfloat16 (to nearest even, as the
    JAX package's ``astype(bfloat16)``), held in f64."""
    return x.to(torch.bfloat16).double()


def _topk_ip(db: torch.Tensor, q: torch.Tensor, k: int):
    """Inner-product top k of the queries q (B, D) f32 over db (N, D), the
    database already through :func:`_round_bf16`, on one device ->
    (scores (B, k) f32, indices (B, k) int64).

    The scores are those of the JAX package's bf16 product with f32
    accumulation.  A product of two bf16 values is exact in f32; the port
    sums the products in f64 and rounds the sum to f32 once, so the card
    and the CPU give the same scores whatever order each sums in.  Ties go
    to the lower index, as ``lax.top_k``'s do: one top k over int64 keys,
    the score's order-preserving bits above the complement of the index."""
    scores = torch.matmul(_round_bf16(q), db.T).float()
    bits = scores.view(torch.int32).long()
    order = torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)
    index = torch.arange(scores.shape[1], device=scores.device)
    keys = order * (1 << 32) + ((1 << 32) - 1 - index)
    top = torch.topk(keys, k, dim=-1).values
    idx = (1 << 32) - 1 - (top & 0xFFFFFFFF)
    return scores.gather(1, idx), idx


class VectorIndex:
    """Incremental flat-IP index with a doc-id list (FaissDB counterpart).

    ``device``: where search runs and the vectors live once searched
    (copied there once, rounded to bfloat16 and held in f64, 8 bytes a
    value; again only after an add); CUDA unless named."""

    def __init__(self, dim: int, vectors: Optional[np.ndarray] = None,
                 ids: Optional[List[str]] = None, device=None):
        self.dim = dim
        self._vecs: List[np.ndarray] = (
            [np.ascontiguousarray(vectors, np.float32)]
            if vectors is not None and len(vectors) else [])
        self.ids: List[str] = list(ids or [])
        self.device = device
        self._device_db: Optional[torch.Tensor] = None

    # -- building -----------------------------------------------------------
    def add(self, vec: np.ndarray, doc_id: str) -> None:
        v = np.asarray(vec, np.float32).reshape(1, -1)
        v = v / (np.linalg.norm(v, axis=1, keepdims=True) + 1e-12)
        self._vecs.append(v)
        self.ids.append(doc_id)
        self._device_db = None

    def add_batch(self, vecs: np.ndarray, doc_ids: Sequence[str]) -> None:
        v = np.asarray(vecs, np.float32)
        v = v / (np.linalg.norm(v, axis=1, keepdims=True) + 1e-12)
        self._vecs.append(v)
        self.ids.extend(doc_ids)
        self._device_db = None

    @property
    def ntotal(self) -> int:
        return len(self.ids)

    def vectors(self) -> np.ndarray:
        if not self._vecs:
            return np.zeros((0, self.dim), np.float32)
        if len(self._vecs) > 1:
            self._vecs = [np.concatenate(self._vecs, axis=0)]
        return self._vecs[0]

    # -- search ---------------------------------------------------------------
    def _db(self) -> torch.Tensor:
        if self._device_db is None:
            self.device = resolve_device(self.device)
            self._device_db = _round_bf16(
                torch.from_numpy(self.vectors()).to(self.device))
        return self._device_db

    def search_device(self, query, k: int = 5):
        """(scores, indices) of the top ``min(k, ntotal)`` as tensors on the
        index's device, not copied to the host."""
        db = self._db()
        q = torch.as_tensor(np.asarray(query, np.float32)).to(db.device)
        if q.dim() == 1:
            q = q[None]
        return _topk_ip(db, q, min(k, self.ntotal))

    def search(self, query, k: int = 5) -> Tuple[np.ndarray, np.ndarray]:
        """query (B, D) or (D,) -> (scores (B, k), indices (B, k)); missing
        slots get score 0 and index -1 (the FAISS convention)."""
        q = np.asarray(query, np.float32)
        if q.ndim == 1:
            q = q[None]
        scores = np.zeros((q.shape[0], k), np.float32)
        idx = -np.ones((q.shape[0], k), np.int64)
        if self.ntotal == 0:
            return scores, idx
        s, i = self.search_device(q, k)
        kk = s.shape[1]
        scores[:, :kk] = s.cpu().numpy()
        idx[:, :kk] = i.cpu().numpy()
        return scores, idx

    def search_many(self, queries, k: int = 5, depth: int = 4):
        """Each wave of queries searched on a small thread pool, so one
        wave's upload overlaps another's product and top k; the vectors go
        to the device once, first.  Returns ``[(scores, indices), ...]`` in
        wave order."""
        from concurrent.futures import ThreadPoolExecutor
        if self._vecs:
            self._db()
        with ThreadPoolExecutor(max_workers=depth,
                                thread_name_prefix="sic-search") as ex:
            futs = [ex.submit(self.search, q, k) for q in queries]
            return [f.result() for f in futs]

    # -- persistence ------------------------------------------------------------
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
    def load(cls, index_dir, device=None) -> Tuple["VectorIndex", dict]:
        """Load either layout, the new one first (reference:
        search.py:65-88); ``device`` is where it will search."""
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
                  vectors=v, ids=ids, device=device)
        return idx, meta
