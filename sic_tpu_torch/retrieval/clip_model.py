"""CLIP image tower (NHWC) with open_clip weight loading.

Counterpart of the image half of the JAX package's
``retrieval/clip_model.py`` (reference: src/compress.py:58-74 - ViT-B-32,
``laion2b_s34b_b79k``).  The tower runs its attention through the sequence
attention kernel (S = 50 at 224 px).  Pretrained weights are an external
artifact: :func:`port_open_clip_weights` reads an open_clip checkpoint when
one is given.  The text tower and its BPE tokenizer are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..models.layers import Conv2d, LayerNorm, ResidualAttentionBlock

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


def port_open_clip_weights(ckpt_path, spec: CLIPSpec = CLIPSpec()) -> dict:
    """An open_clip ViT-B-32 checkpoint -> a state dict of
    :class:`CLIPVisionTower` (torch layouts carry over; only names
    change)."""
    sd = torch.load(ckpt_path, map_location="cpu")
    if "state_dict" in sd:
        sd = sd["state_dict"]
    out = {"patch_embed.weight": sd["visual.conv1.weight"]}
    for k in ("class_embedding", "positional_embedding", "proj",
              "ln_pre.weight", "ln_pre.bias", "ln_post.weight", "ln_post.bias"):
        out[k] = sd[f"visual.{k}"]
    for i in range(spec.vision_layers):
        src, dst = f"visual.transformer.resblocks.{i}.", f"block.{i}."
        out[dst + "attn.in_proj.weight"] = sd[src + "attn.in_proj_weight"]
        out[dst + "attn.in_proj.bias"] = sd[src + "attn.in_proj_bias"]
        for k in ("ln_1.weight", "ln_1.bias", "ln_2.weight", "ln_2.bias",
                  "attn.out_proj.weight", "attn.out_proj.bias",
                  "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight",
                  "mlp.c_proj.bias"):
            out[dst + k] = sd[src + k]
    return {k: v.float() for k, v in out.items()}
