"""CLIP embedding codec: unit vector <-> u8+zstd searchable payload.

Byte-identical quantization and zstd-19 payload to the reference
(reference: src/compress.py:76-86 encode; src/search.py:14-22 decode) and
to the JAX package's ``retrieval/codec.py``; image and text queries.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import zstd
from ..models.codec import resolve_device
from ..utils.profiling import timed_stage
from ..weights import init_seeded
from .clip_model import CLIPModel, CLIPSpec, SimpleTokenizer, preprocess_image


def l2n(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, eps)


def quantize_clip_u8(z_unit: np.ndarray) -> np.ndarray:
    return np.clip(np.round((z_unit * 0.5 + 0.5) * 255.0), 0, 255).astype(np.uint8)


def dequantize_clip_u8(q: np.ndarray) -> np.ndarray:
    z = (q.astype(np.float32) / 255.0) * 2.0 - 1.0
    return l2n(z.astype(np.float32))


class ClipCodec:
    """Image or text -> unit CLIP vector; image vector -> zstd-19 u8
    payload (+meta).

    ``state_dict``: weights of :class:`CLIPModel` (for example from
    :func:`port_open_clip_weights`); without it both towers take the
    seeded initialisation and ``calibrated`` is False.  ``bpe_path``: the
    BPE merges ``.gz`` of :class:`SimpleTokenizer` (without it, the hashed
    fallback)."""

    def __init__(self, state_dict: Optional[dict] = None,
                 spec: CLIPSpec = CLIPSpec(), device=None, seed: int = 0,
                 bpe_path: Optional[str] = None):
        self.spec = spec
        self.device = resolve_device(device)
        self.tokenizer = SimpleTokenizer(bpe_path, spec.context_length)
        with torch.device(self.device):
            self.model = CLIPModel(spec)
        if state_dict is None:
            init_seeded(self.model, seed)
            self.calibrated = False
        else:
            self.model.load_state_dict(state_dict)
            self.calibrated = True
        self.model.eval().requires_grad_(False)

    @property
    def model_id(self) -> str:
        return self.spec.model_id

    @torch.no_grad()
    def _embed(self, batch) -> np.ndarray:
        x = torch.as_tensor(np.asarray(batch, np.float32)).to(self.device)
        return self.model.encode_image(x).cpu().numpy()

    def images_to_unit_vecs(self, batch) -> np.ndarray:
        """(B, 224, 224, 3) pre-normalized array -> (B, D) unit f32."""
        with timed_stage(None, "clip.embed"):
            return self._embed(batch)

    def image_to_unit_vec(self, img) -> np.ndarray:
        """PIL image or HWC array ([-1,1], [0,1] or u8) -> (D,) unit f32."""
        with timed_stage(None, "clip.embed"):
            with timed_stage(None, "clip.preprocess"):
                x = preprocess_image(img, self.spec.image_size)
            return self._embed(x[None])[0]

    @torch.no_grad()
    def text_to_unit_vec(self, text) -> np.ndarray:
        """A string or a list of them -> (B, D) unit f32."""
        tokens = torch.from_numpy(self.tokenizer(text)).to(self.device)
        return self.model.encode_text(tokens).cpu().numpy()

    def quantize_u8_and_compress(self, z_unit: np.ndarray) -> Tuple[bytes, Dict]:
        with timed_stage(None, "clip.zstd"):
            q = quantize_clip_u8(z_unit)
            meta = {"model_id": self.model_id, "dim": int(z_unit.shape[0]),
                    "quant": "u8_symmetric_-1_1", "codec": "zstd",
                    "zstd_level": 19}
            return zstd.compress(q.tobytes(), level=19), meta


def decode_clip_stream(clip_stream: bytes, clip_meta: Dict) -> np.ndarray:
    """zstd u8 payload -> unit vector (reference: search.py:24-41)."""
    dim = int((clip_meta or {}).get("dim", 0))
    if dim <= 0:
        raise ValueError("invalid clip_meta.dim")
    raw = zstd.decompress(clip_stream)
    q = np.frombuffer(raw, dtype=np.uint8)
    if q.size != dim:
        raise ValueError(f"clip dim mismatch: {q.size} != {dim}")
    return dequantize_clip_u8(q)
