"""Image listing and loading for the CLIs (host side, numpy and PIL).

The port's own copy of the parts of the JAX package's ``data.py`` (and of
``parallel/multihost.shard_list``) that the compress path needs.
"""
from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


def list_images(root) -> List[Path]:
    """Every image file under ``root``, recursively, sorted by path."""
    return sorted(p for p in Path(root).rglob("*")
                  if p.suffix.lower() in IMG_EXTS)


def load_image(path) -> np.ndarray:
    """-> (H, W, 3) float32 in [-1, 1]."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 127.5 - 1.0


def shard_list(items, rank: int, world: int):
    """Round-robin shard, the DistributedSampler split (reference:
    compress.py:210-215)."""
    return list(items)[rank::world]
