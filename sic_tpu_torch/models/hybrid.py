"""Hybrid TiTok + detail-branch codec (NHWC, tile-batched).

Counterpart of the JAX package's ``models/hybrid.py`` (reference:
src/models/codec_sq_fixbpp.py:48-439): the TiTok ViT encoder and decoder,
each interleaved with the detail branch's cross-attention and refiners, and
FeatMerge, the prior fusion into VQGAN codebook logits.  Images are tiled
into 256-px tiles that form one batch axis.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import TiTokSpec
from .bottleneck import CompressiveBottleneck
from .convnext import ConvNeXtBlock
from .cross import (InteractiveCrossAttn, tile_nhwc_to_tokens,
                    tokens_to_tile_nhwc)
from .layers import Conv2d, LayerNorm, ResidualAttentionBlock
from .quantizer import L2VectorQuantizer
from .swin import SwinStack


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NHWC depth-to-space with torch ``nn.PixelShuffle`` channel ordering
    (in channel = c*r*r + i*r + j)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H, W, C // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, C // (r * r))


class FeatBlock(nn.Module):
    """Per-insert-position detail refiner: 2 Swin + 2 ConvNeXt
    (reference: codec_sq_fixbpp.py:75-79)."""

    def __init__(self, feat_width: int):
        super().__init__()
        self.swin = SwinStack(feat_width, 2)
        self.convnext_0 = ConvNeXtBlock(feat_width, feat_width, 2.0, 5)
        self.convnext_1 = ConvNeXtBlock(feat_width, feat_width, 2.0, 5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convnext_1(self.convnext_0(self.swin(x)))


def _scaled_normal(shape, scale: float) -> nn.Parameter:
    return nn.Parameter(scale * torch.randn(shape))


class HybridEncoder(nn.Module):
    """TiTok ViT encoder interleaved with the detail branch
    (reference: codec_sq_fixbpp.py:48-183)."""

    def __init__(self, spec: TiTokSpec, insert_pos: Tuple[int, ...],
                 feat_width: int, num_attns: int = 2):
        super().__init__()
        s = spec
        self.spec = spec
        self.insert_pos = tuple(p for p in insert_pos if p < s.num_layers)
        scale = s.width ** -0.5
        self.patch_embed = Conv2d(3, s.width, s.patch_size, stride=s.patch_size)
        self.class_embedding = _scaled_normal((1, s.width), scale)
        self.positional_embedding = _scaled_normal((s.grid_size ** 2 + 1, s.width), scale)
        self.latent_token_positional_embedding = _scaled_normal(
            (s.num_latent_tokens, s.width), scale)
        self.ln_pre = LayerNorm(s.width)
        self.transformer = nn.ModuleList(
            ResidualAttentionBlock(s.width, s.num_heads) for _ in range(s.num_layers))
        self.ln_post = LayerNorm(s.width)
        self.conv_out = nn.Linear(s.width, s.token_size)
        self.pix_emb_proj = nn.Linear(s.width, feat_width)
        self.feat_in = SwinStack(feat_width, 4)
        self.inter_blocks = nn.ModuleDict({
            str(i): InteractiveCrossAttn(s.width, feat_width, num_attns,
                                         s.grid_size, s.grid_size,
                                         s.num_latent_tokens + 1)
            for i in self.insert_pos})
        self.feat_blocks = nn.ModuleDict({str(i): FeatBlock(feat_width)
                                          for i in self.insert_pos})
        self.feat_out_swin = SwinStack(feat_width, 2)
        self.feat_out_down = Conv2d(feat_width, feat_width, 2, stride=2)
        self.feat_out_ln = LayerNorm(feat_width)
        self.feat_out_fc = nn.Linear(feat_width, feat_width)

    def forward(self, pixel_values, latent_tokens):
        """pixel_values: (B, H, W, 3) in [0, 1], H and W multiples of the
        tile; latent_tokens: (num_latent_tokens, width).  Returns (z (BT,
        n_latent, token_size), feat (B, H/32, W/32, feat_width),
        stack_shape)."""
        s = self.spec
        x_emb = self.patch_embed(pixel_values)            # (B, H/16, W/16, width)
        feat_emb = self.pix_emb_proj(x_emb)
        x, stack_shape = tile_nhwc_to_tokens(x_emb, s.grid_size)
        BT = x.shape[0]
        cls = self.class_embedding.expand(BT, 1, s.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        lat = latent_tokens[None].expand(BT, s.num_latent_tokens, s.width) \
            + self.latent_token_positional_embedding
        x = torch.cat([x, lat], dim=1)                    # (BT, 1+256+n, width)

        feat = self.feat_in(feat_emb)
        x = self.ln_pre(x)
        for i, blk in enumerate(self.transformer):
            x = blk(x)
            if i in self.insert_pos:
                feat, x = self.inter_blocks[str(i)](feat, x, stack_shape)
                feat = self.feat_blocks[str(i)](feat)

        z = self.ln_post(x[:, 1 + s.grid_size ** 2:])
        # TiTok's "fake 2D" projection: the torch original reshapes
        # (BT, N, width) row-major to (BT, width, N, 1) before its 1x1
        # conv_out, a channel scramble that trained weights expect
        # (reference: titok/blocks.py:140-143)
        BT2, N, Wd = z.shape
        z = self.conv_out(z.reshape(BT2, Wd, N).transpose(1, 2))

        feat = self.feat_out_down(self.feat_out_swin(feat))  # stride 16 -> 32
        return z, self.feat_out_fc(self.feat_out_ln(feat)), stack_shape


class HybridDecoder(nn.Module):
    """TiTok ViT decoder + detail-branch upsampler
    (reference: codec_sq_fixbpp.py:186-300)."""

    def __init__(self, spec: TiTokSpec, insert_pos: Tuple[int, ...],
                 feat_width: int, num_attns: int = 2):
        super().__init__()
        s = spec
        self.spec = spec
        # a position past the trunk never fires (flax then creates no
        # parameters for it, e.g. the tiny spec's 2 layers)
        self.insert_pos = tuple(p for p in insert_pos if p < s.num_layers)
        scale = s.width ** -0.5
        self.decoder_embed = nn.Linear(s.token_size, s.width)
        self.class_embedding = _scaled_normal((1, s.width), scale)
        self.positional_embedding = _scaled_normal((s.grid_size ** 2 + 1, s.width), scale)
        self.mask_token = _scaled_normal((1, 1, s.width), scale)
        self.latent_token_positional_embedding = _scaled_normal(
            (s.num_latent_tokens, s.width), scale)
        self.ln_pre = LayerNorm(s.width)
        self.transformer = nn.ModuleList(
            ResidualAttentionBlock(s.width, s.num_heads) for _ in range(s.num_layers))
        self.ln_post = LayerNorm(s.width)
        self.feat_up_conv = Conv2d(feat_width, feat_width * 4)
        self.feat_up_swin = SwinStack(feat_width, 4)
        # keys are the insert positions: ``inter_blocks.<i>`` maps onto the
        # JAX package's ``inter_blocks_<i>``
        self.inter_blocks = nn.ModuleDict({
            str(i): InteractiveCrossAttn(s.width, feat_width, num_attns,
                                         s.grid_size, s.grid_size,
                                         s.num_latent_tokens + 1)
            for i in self.insert_pos})
        self.feat_blocks = nn.ModuleDict({str(i): FeatBlock(feat_width)
                                          for i in self.insert_pos})

    def forward(self, z_quantized, h_quantized, stack_shape: Tuple[int, int]):
        """z_quantized: (BT, n_latent, token_size); h_quantized:
        (B, H/32, W/32, feat_width).  Returns (titok_hat (B, H/16, W/16,
        width), feat (B, H/16, W/16, feat_width))."""
        s = self.spec
        x = self.decoder_embed(z_quantized)
        BT, seq_len, _ = x.shape
        mask = self.mask_token.expand(BT, s.grid_size ** 2, s.width)
        cls = self.class_embedding.expand(BT, 1, s.width)
        mask = torch.cat([cls, mask], dim=1) + self.positional_embedding
        x = x + self.latent_token_positional_embedding[:seq_len]
        x = torch.cat([mask, x], dim=1)                   # (BT, 1+256+n, width)

        feat = pixel_shuffle(self.feat_up_conv(h_quantized), 2)
        feat = self.feat_up_swin(feat)

        x = self.ln_pre(x)
        for i, blk in enumerate(self.transformer):
            x = blk(x)
            if i in self.insert_pos:
                feat, x = self.inter_blocks[str(i)](feat, x, stack_shape)
                feat = self.feat_blocks[str(i)](feat)

        x = self.ln_post(x[:, 1:1 + s.grid_size ** 2])
        return tokens_to_tile_nhwc(x, stack_shape, s.grid_size), feat


class FeatMerge(nn.Module):
    """Prior fusion: titok_hat + feat_hat -> logits over the VQGAN codebook
    (reference: codec_sq_fixbpp.py:395-439)."""

    def __init__(self, titok_width: int = 1024, feat_width: int = 768,
                 n_embed: int = 256, inner_width: int = 1024):
        super().__init__()
        tw = titok_width
        self.titok_in = SwinStack(tw, 2)
        self.feat_in = SwinStack(feat_width, 2)
        self.merge_fc1 = nn.Linear(tw + feat_width, tw * 2)
        self.merge_ln = LayerNorm(tw * 2)
        self.merge_fc2 = nn.Linear(tw * 2, inner_width)
        self.merge_swin = SwinStack(inner_width, 4)
        self.ffn_ln = LayerNorm(inner_width)
        self.ffn_fc1 = nn.Linear(inner_width, inner_width * 2)
        self.ffn_fc2 = nn.Linear(inner_width * 2, n_embed)

    def forward(self, titok: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        h = torch.cat([self.titok_in(titok), self.feat_in(feat)], dim=-1)
        h = self.merge_fc2(F.silu(self.merge_ln(self.merge_fc1(h))))
        h = self.merge_swin(h)
        h = torch.tanh(self.ffn_fc1(self.ffn_ln(h)))
        return self.ffn_fc2(h)


class HybridCodec(nn.Module):
    """Encoder + decoder + semantic quantizer + detail bottleneck
    (reference: codec_sq_fixbpp.py:303-392)."""

    def __init__(self, spec: TiTokSpec, insert_pos_enc: Tuple[int, ...],
                 insert_pos_dec: Tuple[int, ...], feat_width: int,
                 quant_dim: int, num_attns: int = 2):
        super().__init__()
        self.encoder = HybridEncoder(spec, insert_pos_enc, feat_width, num_attns)
        self.decoder = HybridDecoder(spec, insert_pos_dec, feat_width, num_attns)
        self.latent_tokens = _scaled_normal((spec.num_latent_tokens, spec.width),
                                            spec.width ** -0.5)
        self.quantize = L2VectorQuantizer(spec.codebook_size, spec.token_size,
                                          spec.commitment_cost, spec.use_l2_norm)
        self.quantize_feat = CompressiveBottleneck(feat_width, quant_dim)

    def encode(self, x, training: bool = False,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """x: (B, H, W, 3) in [0, 1] -> both quantized latents and their
        result dicts (``noise``/``generator``: the bottleneck's rate noise)."""
        z, h, stack_shape = self.encoder(x, self.latent_tokens)
        z_quantized, z_result = self.quantize(z)
        h_quantized, h_result = self.quantize_feat(
            h, (x.shape[1], x.shape[2]), q_idx=0, training=training,
            noise=noise, generator=generator)
        return {"z_quantized": z_quantized, "z_result_dict": z_result,
                "h_quantized": h_quantized, "h_result_dict": h_result,
                "stack_shape": stack_shape}

    def forward(self, x, training: bool = False,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        out = self.encode(x, training, noise, generator)
        out["titok_hat"], out["feat_hat"] = self.decoder(
            out["z_quantized"], out["h_quantized"], out["stack_shape"])
        return out

    def decode_z_indices(self, indices: torch.Tensor) -> torch.Tensor:
        return self.quantize.decode_indices(indices)
