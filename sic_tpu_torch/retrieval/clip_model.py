"""CLIP image and text towers (NHWC) with open_clip weight loading and the
byte-BPE tokenizer.

Counterpart of the JAX package's ``retrieval/clip_model.py`` (reference:
src/compress.py:58-74, src/search.py:48-63 - ViT-B-32,
``laion2b_s34b_b79k``).  The image tower runs its attention through the
sequence attention kernel (S = 50 at 224 px); the text tower's causal
attention is the masked branch of ``MultiheadSelfAttention`` (plain
einsums, as in the JAX package).  Pretrained weights and the BPE merges
file are external artifacts: :func:`port_open_clip_weights` reads an
open_clip checkpoint and :class:`SimpleTokenizer` the standard
``bpe_simple_vocab_16e6.txt.gz`` when they are given.  Without them the
towers take the seeded initialisation and the tokenizer a hashed fallback
(for tests; not retrieval-compatible with real CLIP).
"""
from __future__ import annotations

import dataclasses
import gzip
import html
import re
from functools import lru_cache
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..models.layers import Conv2d, Embed, LayerNorm, ResidualAttentionBlock

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


# -- tokenizer -------------------------------------------------------------------

@lru_cache()
def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class SimpleTokenizer:
    """CLIP byte-BPE tokenizer over the standard merges file.

    Without one it falls back to a hash tokenizer (not CLIP-compatible; for
    offline tests).  The fallback hashes with Python's ``hash()``, which is
    salted per process, as the JAX package's does: its ids agree between
    the two packages only within one process."""

    def __init__(self, bpe_path: Optional[str] = None,
                 context_length: int = 77):
        self.context_length = context_length
        self.byte_encoder = _bytes_to_unicode()
        # stdlib `re` lacks \p{L}/\p{N}; \w/\d cover the unicode classes
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[^\W\d_]+|\d|[^\s\w]+", re.IGNORECASE | re.UNICODE)
        self.fallback = bpe_path is None or not Path(bpe_path).exists()
        if self.fallback:
            self.sot, self.eot = 49406, 49407
            return
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab = list(_bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def _bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1e10))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_ids(self, text: str):
        text = html.unescape(html.unescape(text)).strip().lower()
        text = re.sub(r"\s+", " ", text)
        ids = []
        for token in re.findall(self.pat, text):
            if self.fallback:
                ids.append(hash(token) % 49000 + 300)
                continue
            t = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[bp] for bp in self._bpe(t).split(" "))
        return ids

    def __call__(self, texts) -> np.ndarray:
        """A string or a list of them -> (B, context_length) int32: start
        token, ids cut to fit, end token, zeros."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode_ids(t)[: self.context_length - 2] \
                + [self.eot]
            out[i, :len(ids)] = ids
        return out


# -- weight porting ----------------------------------------------------------------

_BLOCK_LEAVES = ("ln_1.weight", "ln_1.bias", "ln_2.weight", "ln_2.bias",
                 "attn.out_proj.weight", "attn.out_proj.bias", "mlp.c_fc.weight",
                 "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias")


def _port_block(sd, src: str, dst: str, out: dict) -> None:
    out[dst + "attn.in_proj.weight"] = sd[src + "attn.in_proj_weight"]
    out[dst + "attn.in_proj.bias"] = sd[src + "attn.in_proj_bias"]
    for k in _BLOCK_LEAVES:
        out[dst + k] = sd[src + k]


def port_open_clip_weights(ckpt_path, spec: CLIPSpec = CLIPSpec()) -> dict:
    """An open_clip ViT-B-32 checkpoint -> a state dict of
    :class:`CLIPModel`, both towers (torch layouts carry over; only names
    change)."""
    sd = torch.load(ckpt_path, map_location="cpu")
    if "state_dict" in sd:
        sd = sd["state_dict"]
    out = {"visual.patch_embed.weight": sd["visual.conv1.weight"]}
    for k in ("class_embedding", "positional_embedding", "proj",
              "ln_pre.weight", "ln_pre.bias", "ln_post.weight", "ln_post.bias"):
        out[f"visual.{k}"] = sd[f"visual.{k}"]
    for i in range(spec.vision_layers):
        _port_block(sd, f"visual.transformer.resblocks.{i}.", f"visual.block.{i}.", out)
    out["text.token_embedding.embedding"] = sd["token_embedding.weight"]
    for k in ("positional_embedding", "text_projection", "ln_final.weight",
              "ln_final.bias"):
        out[f"text.{k}"] = sd[k]
    for i in range(spec.text_layers):
        _port_block(sd, f"transformer.resblocks.{i}.", f"text.block.{i}.", out)
    return {k: v.float() for k, v in out.items()}
