"""Bidirectional titok <-> detail-feature exchange block (NHWC).

Counterpart of ``Interactive_crossAttn_type4`` (reference:
src/models/cross_blocks.py:39-98): per 256-px tile the detail feature's
16x16 patch tokens and the ViT tile tokens form one sequence (S = 289 + 256
at the shipped geometry) through ``num_attns`` self-attention blocks.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm, Linear, ResidualAttentionBlock


def tile_nhwc_to_tokens(x: torch.Tensor, tile: int):
    """(B, nH*t, nW*t, C) -> ((B*nH*nW), t*t, C), plus (nH, nW)."""
    B, H, W, C = x.shape
    nH, nW = H // tile, W // tile
    x = x.reshape(B, nH, tile, nW, tile, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * nH * nW, tile * tile, C), (nH, nW)


def tokens_to_tile_nhwc(tokens: torch.Tensor, stack_shape: Tuple[int, int],
                        tile: int) -> torch.Tensor:
    """Inverse of :func:`tile_nhwc_to_tokens`."""
    nH, nW = stack_shape
    BT, S, C = tokens.shape
    B = BT // (nH * nW)
    x = tokens.reshape(B, nH, nW, tile, tile, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, nH * tile, nW * tile, C)


class InteractiveCrossAttn(nn.Module):
    def __init__(self, titok_width: int, feat_width: int, num_attns: int = 2,
                 feat_patch_size: int = 16, titok_patch_size: int = 16,
                 extra_titok_tokens: int = 33, mlp_ratio: float = 4.0):
        super().__init__()
        self.fp = feat_patch_size
        s_titok = titok_patch_size ** 2 + extra_titok_tokens
        tw, fw = titok_width, feat_width
        self.titok_pos_emb = nn.Parameter(torch.zeros(s_titok, tw))
        self.feat_pos_emb = nn.Parameter(torch.zeros(feat_patch_size ** 2, fw))
        self.titok_compress_proj = Linear(tw, fw)
        self.attn = nn.ModuleList(ResidualAttentionBlock(fw, fw // 64, mlp_ratio)
                                  for _ in range(num_attns))
        self.feat_add_ln = LayerNorm(fw)
        self.feat_add_fc = Linear(fw, fw)
        self.titok_decompress_fc = Linear(fw, fw * 2)
        self.titok_decompress_ln = LayerNorm(fw * 2)
        self.zero_add = Linear(fw * 2, tw)

    def forward(self, feat: torch.Tensor, titok_tokens: torch.Tensor,
                stack_shape: Tuple[int, int]):
        """feat: (B, H16, W16, feat_width); titok_tokens:
        (B*nTiles, S_titok, titok_width)."""
        fp2 = self.fp * self.fp
        feat_tokens, _ = tile_nhwc_to_tokens(feat, self.fp)
        f_pos = feat_tokens + self.feat_pos_emb.to(feat_tokens.dtype)
        t_pos = self.titok_compress_proj(
            titok_tokens + self.titok_pos_emb.to(titok_tokens.dtype))
        f = torch.cat([t_pos, f_pos], dim=1)
        for blk in self.attn:
            f = blk(f)
        f_feat_new, f_titok_new = f[:, -fp2:], f[:, :-fp2]
        feat_tokens = feat_tokens + self.feat_add_fc(self.feat_add_ln(f_feat_new))
        g = self.titok_decompress_ln(self.titok_decompress_fc(f_titok_new))
        titok_tokens = titok_tokens + self.zero_add(F.silu(g))
        return tokens_to_tile_nhwc(feat_tokens, stack_shape, self.fp), titok_tokens
