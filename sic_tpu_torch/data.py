"""Image data for the CLIs and training (host side, numpy and PIL).

The port's own copy of the JAX package's ``data.py`` (and of
``parallel/multihost.shard_list``): listing and loading, and the training
dataset (reference: src/taming/data/custom_crop.py:23-99).  Train:
smallest-side resize + random crop; eval: smallest-side resize + center
crop; both in [-1, 1].  The crops use the JAX package's numpy seeds, so both
packages crop the same pixels.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


def list_images(root) -> List[Path]:
    """Every image file under ``root``, recursively, sorted by path."""
    return sorted(p for p in Path(root).rglob("*")
                  if p.suffix.lower() in IMG_EXTS)


def read_paths_file(list_file) -> List[Path]:
    """One image path per line (the reference's *_images_list_file)."""
    lines = Path(list_file).read_text().splitlines()
    return [Path(ln.strip()) for ln in lines if ln.strip()]


def load_image(path) -> np.ndarray:
    """-> (H, W, 3) float32 in [-1, 1]."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 127.5 - 1.0


def shard_list(items, rank: int, world: int):
    """Round-robin shard, the DistributedSampler split (reference:
    compress.py:210-215)."""
    return list(items)[rank::world]


def smallest_max_size(img: np.ndarray, size: int) -> np.ndarray:
    """Resize so the SHORTER side == size (bicubic), as SmallestMaxSize."""
    from PIL import Image
    h, w = img.shape[:2]
    if min(h, w) == size:
        return img
    scale = size / min(h, w)
    nh, nw = max(size, round(h * scale)), max(size, round(w * scale))
    u8 = np.clip((img + 1.0) * 127.5, 0, 255).astype(np.uint8)
    out = Image.fromarray(u8).resize((nw, nh), Image.BICUBIC)
    return np.asarray(out, np.float32) / 127.5 - 1.0


def random_crop(img: np.ndarray, size: int, rng: np.random.Generator):
    h, w = img.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return img[top:top + size, left:left + size]


def center_crop(img: np.ndarray, size: int):
    h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return img[top:top + size, left:left + size]


@dataclasses.dataclass
class ImageDataset:
    """Crop dataset over a path list; ``train`` toggles random vs center crop."""
    paths: List[Path]
    size: int = 256
    train: bool = True
    seed: int = 0

    @classmethod
    def from_list_file(cls, list_file, size=256, train=True, seed=0):
        return cls(read_paths_file(list_file), size, train, seed)

    @classmethod
    def from_dir(cls, root, size=256, train=True, seed=0):
        return cls(list_images(root), size, train, seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i) -> np.ndarray:
        rng = np.random.default_rng((self.seed, i))
        img = smallest_max_size(load_image(self.paths[i]), self.size)
        return (random_crop(img, self.size, rng) if self.train
                else center_crop(img, self.size))

    def batches(self, batch_size: int, shuffle: Optional[bool] = None,
                epoch: int = 0, drop_last: Optional[bool] = None
                ) -> Iterator[np.ndarray]:
        """Yield (B, size, size, 3) float32 batches.  The epoch shuffle is
        the JAX package's expression; its tuple holds a string, whose hash
        changes from process to process, so orders are not compared."""
        n = len(self.paths)
        order = np.arange(n)
        shuffle = self.train if shuffle is None else shuffle
        drop_last = self.train if drop_last is None else drop_last
        if shuffle:
            np.random.default_rng((self.seed, "epoch", epoch).__hash__()
                                  & 0x7FFFFFFF).shuffle(order)
        for s in range(0, n, batch_size):
            idx = order[s:s + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            yield np.stack([self[int(i)] for i in idx])
