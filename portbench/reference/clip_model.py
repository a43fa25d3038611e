"""CLIP ViT-B-32's image and text towers (NHWC) and the image
preprocessing (a copy of the port's ``retrieval/clip_model.py`` without
its tokenizer and checkpoint reader; the text tower stays so that the
seeded weights are drawn over the same parameters in the same order).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .layers import Conv2d, Embed, LayerNorm, ResidualAttentionBlock

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPSpec:
    """ViT-B-32 by default (the reference's model)."""
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    embed_dim: int = 512
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    context_length: int = 77
    vocab_size: int = 49408

    @property
    def model_id(self) -> str:
        return "ViT-B-32:laion2b_s34b_b79k"


class CLIPVisionTower(nn.Module):
    """Parameter names follow the JAX package's ``visual`` subtree
    (``block.<i>`` is its ``block_<i>``)."""

    def __init__(self, spec: CLIPSpec = CLIPSpec()):
        super().__init__()
        s = spec
        self.spec = spec
        grid = s.image_size // s.patch_size
        scale = s.vision_width ** -0.5
        self.patch_embed = Conv2d(3, s.vision_width, s.patch_size,
                                  stride=s.patch_size, bias=False)
        self.class_embedding = nn.Parameter(scale * torch.randn(s.vision_width))
        self.positional_embedding = nn.Parameter(
            scale * torch.randn(grid * grid + 1, s.vision_width))
        self.ln_pre = LayerNorm(s.vision_width)
        self.block = nn.ModuleList(ResidualAttentionBlock(s.vision_width, s.vision_heads)
                                   for _ in range(s.vision_layers))
        self.ln_post = LayerNorm(s.vision_width)
        self.proj = nn.Parameter(scale * torch.randn(s.vision_width, s.embed_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 224, 224, 3), already CLIP-normalized -> (B, embed_dim)."""
        s = self.spec
        x = self.patch_embed(x)
        B = x.shape[0]
        x = x.reshape(B, -1, s.vision_width)
        cls = self.class_embedding.expand(B, 1, s.vision_width)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding)
        for blk in self.block:
            x = blk(x)
        return self.ln_post(x[:, 0]) @ self.proj


class CLIPTextTower(nn.Module):
    """Causal text transformer; parameter names follow the JAX package's
    ``text`` subtree."""

    def __init__(self, spec: CLIPSpec = CLIPSpec()):
        super().__init__()
        s = spec
        self.spec = spec
        self.token_embedding = Embed(s.vocab_size, s.text_width)
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(s.context_length, s.text_width))
        self.block = nn.ModuleList(ResidualAttentionBlock(s.text_width, s.text_heads)
                                   for _ in range(s.text_layers))
        self.ln_final = LayerNorm(s.text_width)
        self.text_projection = nn.Parameter(
            s.text_width ** -0.5 * torch.randn(s.text_width, s.embed_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, context_length) int -> (B, embed_dim)."""
        tokens = tokens.long()
        n = self.spec.context_length
        x = self.token_embedding(tokens) + self.positional_embedding
        causal = torch.full((n, n), float("-inf"), device=x.device).triu(1)
        for blk in self.block:
            x = blk(x, causal)
        x = self.ln_final(x)
        # features at the EOT token (the highest token id of each row)
        eot = tokens.argmax(dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return x @ self.text_projection


class CLIPModel(nn.Module):
    """Both towers; ``visual`` and ``text`` are the JAX package's
    subtrees."""

    def __init__(self, spec: CLIPSpec = CLIPSpec()):
        super().__init__()
        self.spec = spec
        self.visual = CLIPVisionTower(spec)
        self.text = CLIPTextTower(spec)

    @staticmethod
    def _unit(z: torch.Tensor) -> torch.Tensor:
        z = z.float()
        return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        return self._unit(self.visual(x))

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._unit(self.text(tokens))

    def forward(self, x: torch.Tensor, tokens: torch.Tensor):
        return self.encode_image(x), self.encode_text(tokens)


def preprocess_image(img, image_size: int = 224) -> np.ndarray:
    """PIL image / HWC uint8 or float array -> (224, 224, 3) CLIP-normalized.

    Resize the shorter side (bicubic), center crop, normalize, as
    open_clip's eval transform (reference: compress.py:69-74)."""
    from PIL import Image
    if not isinstance(img, Image.Image):
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = np.clip((arr + 1.0) * 127.5 if arr.min() < 0 else arr * 255.0,
                          0, 255).astype(np.uint8)
        img = Image.fromarray(arr)
    img = img.convert("RGB")
    w, h = img.size
    scale = image_size / min(w, h)
    img = img.resize((max(image_size, round(w * scale)),
                      max(image_size, round(h * scale))), Image.BICUBIC)
    w, h = img.size
    left, top = (w - image_size) // 2, (h - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    x = np.asarray(img, np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD
