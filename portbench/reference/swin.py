"""Swin window attention blocks (NHWC).

Counterpart of the JAX package's ``models/swin.py`` (reference:
src/blocks/swin_transformer.py:64-156): cyclic shift by ``torch.roll``, a
relative position bias in block 0 only, shift masks folded into a
per-window additive bias, and the NHWC window-attention kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .attention import window_attention_nhwc
from .layers import LayerNorm, Linear


def _relative_index(window_size: int) -> np.ndarray:
    """(S, S, 2) table of pairwise offsets shifted to [0, 2*ws-2]."""
    coords = np.stack(np.meshgrid(np.arange(window_size),
                                  np.arange(window_size), indexing="ij"),
                      axis=-1).reshape(-1, 2)
    rel = coords[None, :, :] - coords[:, None, :]
    return rel + window_size - 1


def _relative_flat(window_size: int) -> np.ndarray:
    """(S*S,): each (query, key) pair's bin of the flattened (2ws-1, 2ws-1)
    relative position table."""
    idx = _relative_index(window_size)
    nb = 2 * window_size - 1
    return (idx[..., 0] * nb + idx[..., 1]).reshape(-1)


def _shift_masks(window_size: int) -> tuple:
    """Additive -inf masks for the shifted layout
    (reference: swin_transformer.py:42-55)."""
    d = window_size // 2
    s = window_size * window_size
    ul = np.zeros((s, s), np.float32)
    ul[-d * window_size:, :-d * window_size] = -np.inf
    ul[:-d * window_size, -d * window_size:] = -np.inf
    lr = np.zeros((window_size,) * 4, np.float32)
    lr[:, -d:, :, :-d] = -np.inf
    lr[:, :-d, :, -d:] = -np.inf
    return ul, lr.reshape(s, s)


def _full_shift_mask(nwh: int, nww: int, window_size: int) -> np.ndarray:
    """Per-window additive mask (nwh*nww, S, S)."""
    ul, lr = _shift_masks(window_size)
    s = window_size * window_size
    mask = np.zeros((nwh, nww, s, s), np.float32)
    mask[-1, :, :, :] += ul          # last window row
    mask[:, -1, :, :] += lr          # last window column
    return mask.reshape(nwh * nww, s, s)


class WindowAttention(nn.Module):
    """Windowed MHSA with optional cyclic shift + relative position bias."""

    def __init__(self, dim: int, heads: int, head_dim: int, window_size: int,
                 shifted: bool, relative_pos_embedding: bool):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        self.window_size, self.shifted = window_size, shifted
        self.relative = relative_pos_embedding
        inner = heads * head_dim
        ws = window_size
        self.to_qkv = Linear(dim, inner * 3, bias=False)
        if relative_pos_embedding:
            self.pos_embedding = nn.Parameter(torch.randn(2 * ws - 1, 2 * ws - 1))
            self.register_buffer("rel_flat", torch.from_numpy(_relative_flat(ws)),
                                 persistent=False)
        else:
            self.pos_embedding = nn.Parameter(torch.randn(ws * ws, ws * ws))
        self.to_out = Linear(inner, dim)
        self._masks: dict = {}

    def _shift_mask(self, nwh: int, nww: int, device) -> torch.Tensor:
        key = (nwh, nww, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                _full_shift_mask(nwh, nww, self.window_size)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        ws = self.window_size
        if H % ws or W % ws:
            raise ValueError(f"feature map {H}x{W} is not a multiple of {ws}")
        d = ws // 2
        if self.shifted:
            x = torch.roll(x, shifts=(-d, -d), dims=(1, 2))
        qkv = self.to_qkv(x)
        if self.relative:
            ws2 = self.window_size ** 2
            bias = self.pos_embedding.reshape(-1)[self.rel_flat].reshape(ws2, ws2)
        else:
            bias = self.pos_embedding
        bias = bias.float()[None]      # f32 in every compute dtype
        if self.shifted:
            bias = bias + self._shift_mask(H // ws, W // ws, x.device)
        out = window_attention_nhwc(qkv, bias.contiguous(),
                                    self.head_dim ** -0.5, self.heads)
        out = self.to_out(out)
        if self.shifted:
            out = torch.roll(out, shifts=(d, d), dims=(1, 2))
        return out


class SwinBlock(nn.Module):
    """Pre-LN window-attention block (reference: swin_transformer.py:131-156)."""

    def __init__(self, dim: int, heads: int, head_dim: int, mlp_dim: int,
                 window_size: int, shifted: bool, relative_pos_embedding: bool):
        super().__init__()
        self.norm_attn = LayerNorm(dim)
        self.attention_block = WindowAttention(
            dim, heads, head_dim, window_size, shifted, relative_pos_embedding)
        self.norm_mlp = LayerNorm(dim)
        self.mlp_fc1 = Linear(dim, mlp_dim)
        self.mlp_fc2 = Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention_block(self.norm_attn(x))
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm_mlp(x))))


class SwinStack(nn.Module):
    """Alternating-shift Swin layers at head dim 64
    (reference: codec_sq_fixbpp.py:33-45).  ``block.<i>`` maps onto the
    JAX package's ``block_<i>``."""

    def __init__(self, width: int, num_layers: int, mlp_ratio: float = 4.0,
                 window_size: int = 16, inverse_shifted: bool = False):
        super().__init__()
        if width % 64:
            raise ValueError(f"Swin width {width} is not a multiple of 64")
        blocks = []
        for i in range(num_layers):
            shifted = (not bool(i % 2)) if inverse_shifted else bool(i % 2)
            rel = False if inverse_shifted else (i == 0)
            blocks.append(SwinBlock(width, width // 64, 64,
                                    int(width * mlp_ratio), window_size,
                                    shifted, rel))
        self.block = nn.ModuleList(blocks)
        self.window_size = window_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.block:
            x = blk(x)
        return x
