"""Seeded images: tiles of the eight 256x256 held-out pictures under
``portbench/data/heldout`` (copied into the benchmark, so its inputs do
not move with the repository), each tile rolled, flipped, turned and
colour-jittered, from a NumPy generator of the run's seed."""
from __future__ import annotations

from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent.parent / "data" / "heldout"
TILE = 256


def sources() -> np.ndarray:
    """The held-out pictures, (8, 256, 256, 3) float32 in [0, 1]."""
    from PIL import Image
    files = sorted(DATA.glob("*.png"))
    if not files:
        raise FileNotFoundError(f"no images under {DATA}")
    return np.stack([np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
                     for f in files])


def tile(rng: np.random.Generator, src: np.ndarray) -> np.ndarray:
    t = src[int(rng.integers(len(src)))]
    t = np.roll(t, (int(rng.integers(TILE)), int(rng.integers(TILE))), axis=(0, 1))
    if rng.random() < 0.5:
        t = t[:, ::-1]
    t = np.rot90(t, int(rng.integers(4)))
    gain = rng.uniform(0.75, 1.25, 3).astype(np.float32)
    shift = rng.uniform(-0.1, 0.1, 3).astype(np.float32)
    return np.clip(t * gain + shift, 0.0, 1.0)


def make_images(rng: np.random.Generator, n: int, hw) -> np.ndarray:
    """``n`` images of ``hw`` (multiples of 256), (n, H, W, 3) float32 in
    [-1, 1], quantized to 8 bits as a decoded file would be."""
    src = sources()
    H, W = hw
    out = np.empty((n, H, W, 3), np.float32)
    for i in range(n):
        for y in range(0, H, TILE):
            for x in range(0, W, TILE):
                out[i, y:y + TILE, x:x + TILE] = tile(rng, src)
    return np.round(out * 255.0) / 127.5 - 1.0
