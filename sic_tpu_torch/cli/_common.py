"""Shared CLI plumbing: runtime construction and PNG output."""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from ..config import CodecSpec, flagship_spec
from ..models import Codec, CodecRuntime, resolve_device
from ..weights import ENCODER_PREFIXES, init_seeded, load_npz


def build_model(spec: CodecSpec, device,
                ckpt_path: Optional[str] = None) -> Codec:
    """The decode model on ``device``, from a flat ``params/...`` npz or,
    without one, from the seeded initialisation."""
    with torch.device(device):
        model = Codec(spec)
    if ckpt_path:
        unused = load_npz(model, ckpt_path)
        stray = sorted(k for k in unused if not k.startswith(ENCODER_PREFIXES))
        if stray:
            raise ValueError(f"{len(stray)} checkpoint leaves fit no parameter "
                             f"of the decoder, e.g. {stray[:3]}")
    else:
        init_seeded(model)
    return model.eval().requires_grad_(False)


def load_runtime(ckpt_path: Optional[str] = None, spec: Optional[CodecSpec] = None,
                 device=None, stream_part: int = 4) -> CodecRuntime:
    """A fp32 CodecRuntime on ``device`` (CUDA unless named).

    ``stream_part``: rANS substreams per stream this runtime writes;
    decoding reads the count from each stream.  Without ``ckpt_path`` it
    warns and uses the seeded initialisation, as the JAX CLI does."""
    dev = resolve_device(device)
    spec = spec or flagship_spec()
    if not ckpt_path:
        print("[WARN] no --ckpt_path given; running with random weights",
              file=sys.stderr)
    model = build_model(spec, dev, ckpt_path)
    return CodecRuntime(spec, model, stream_part=stream_part)


def save_png(path, img) -> None:
    """(H, W, 3) uint8 pixels, or floats in [-1, 1], -> PNG file."""
    from PIL import Image
    a = img.cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    u8 = a if a.dtype == np.uint8 else \
        np.clip((a + 1.0) * 127.5, 0, 255).astype(np.uint8)
    Image.fromarray(u8).save(path)
