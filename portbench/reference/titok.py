"""The full TiTok tokenizer (NHWC, batch-major), its decode side: 1-D
tokens -> image through the MaskGIT-VQGAN pixel decoder.  The encoder is
built for its parameters (the seeded weights follow the port's order).

Counterpart of the JAX package's ``models/titok.py`` (reference:
src/titok/titok.py:30-211, titok/blocks.py:71-224).  The hybrid codec
uses only TiTok's trunks; this module is the standalone 1-D tokenizer and
the pixel path that the generate CLI decodes MaskGIT's tokens through.
As in the JAX package, sequences are ``(B, S, D)``, images NHWC, tiling
is a reshape and transpose, and the encoder keeps TiTok's "fake 2D"
``conv_out`` channel scramble, so reference checkpoints port 1:1.
"""
from __future__ import annotations

import torch
from torch import nn

from .config import TiTokSpec
from .layers import Conv2d, LayerNorm, Linear, ResidualAttentionBlock
from .maskgit_vqgan import MaskGITVQGANSpec, PixelDecoder, PixelQuantizer
from .quantizer import L2VectorQuantizer


def _scaled_normal(shape, scale: float) -> nn.Parameter:
    return nn.Parameter(scale * torch.randn(shape))


class TiTokEncoderViT(nn.Module):
    """Plain TiTok ViT encoder, no detail branch
    (reference: titok/blocks.py:71-144)."""

    def __init__(self, spec: TiTokSpec):
        super().__init__()
        s = self.spec = spec
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
        self.conv_out = Linear(s.width, s.token_size)

    def forward(self, pixel_values: torch.Tensor,
                latent_tokens: torch.Tensor) -> torch.Tensor:
        """pixel_values: (B, tile, tile, 3); latent_tokens: (N, width).
        Returns (B, num_latent_tokens, token_size)."""
        s = self.spec
        x = self.patch_embed(pixel_values)                # (B, g, g, width)
        B, dt = x.shape[0], x.dtype
        x = x.reshape(B, s.grid_size ** 2, s.width)
        cls = self.class_embedding.to(dt).expand(B, 1, s.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        lat = latent_tokens.to(dt)[None].expand(B, s.num_latent_tokens, s.width) \
            + self.latent_token_positional_embedding.to(dt)
        x = self.ln_pre(torch.cat([x, lat], dim=1))
        for blk in self.transformer:
            x = blk(x)
        z = self.ln_post(x[:, 1 + s.grid_size ** 2:])
        # TiTok's "fake 2D" conv_out: the torch original reshapes (B, N,
        # width) row-major to (B, width, N, 1) before its 1x1 conv, a
        # channel scramble trained weights expect (titok/blocks.py:140-143)
        B2, N, Wd = z.shape
        return self.conv_out(z.reshape(B2, Wd, N).transpose(1, 2))


class TiTokDecoderViT(nn.Module):
    """Plain TiTok ViT decoder with the pixel ffn head that the hybrid
    codec strips (reference: titok/blocks.py:147-224; the ffn at :192-197)."""

    def __init__(self, spec: TiTokSpec, ffn_out: int = 1024):
        super().__init__()
        s = self.spec = spec
        scale = s.width ** -0.5
        self.decoder_embed = Linear(s.token_size, s.width)
        self.class_embedding = _scaled_normal((1, s.width), scale)
        self.positional_embedding = _scaled_normal((s.grid_size ** 2 + 1, s.width), scale)
        self.mask_token = _scaled_normal((1, 1, s.width), scale)
        self.latent_token_positional_embedding = _scaled_normal(
            (s.num_latent_tokens, s.width), scale)
        self.ln_pre = LayerNorm(s.width)
        self.transformer = nn.ModuleList(
            ResidualAttentionBlock(s.width, s.num_heads) for _ in range(s.num_layers))
        self.ln_post = LayerNorm(s.width)
        # 1x1 convolutions over NHWC: Linear over the channels
        self.ffn_fc1 = Linear(s.width, 2 * s.width)
        self.ffn_fc2 = Linear(2 * s.width, ffn_out)

    def forward(self, z_quantized: torch.Tensor) -> torch.Tensor:
        """z_quantized: (B, N, token_size) -> pixel-codebook logits
        (B, grid, grid, ffn_out)."""
        s = self.spec
        x = self.decoder_embed(z_quantized)
        B, seq_len, _ = x.shape
        dt = x.dtype
        mask = self.mask_token.to(dt).expand(B, s.grid_size ** 2, s.width)
        cls = self.class_embedding.to(dt).expand(B, 1, s.width)
        mask = torch.cat([cls, mask], dim=1) + self.positional_embedding.to(dt)
        x = x + self.latent_token_positional_embedding[:seq_len].to(dt)
        # the image positions first, then the latent tokens
        x = self.ln_pre(torch.cat([mask, x], dim=1))
        for blk in self.transformer:
            x = blk(x)
        x = self.ln_post(x[:, 1:1 + s.grid_size ** 2])
        x = x.reshape(B, s.grid_size, s.grid_size, s.width)
        return self.ffn_fc2(torch.tanh(self.ffn_fc1(x)))


class TiTok(nn.Module):
    """Image -> 1-D tokens -> image, through the MaskGIT-VQGAN pixel
    decoder (reference: titok/titok.py:73-211)."""

    def __init__(self, spec: TiTokSpec = TiTokSpec(),
                 pixel: MaskGITVQGANSpec = MaskGITVQGANSpec()):
        super().__init__()
        s = self.spec = spec
        self.pixel = pixel
        self.encoder = TiTokEncoderViT(s)
        self.decoder = TiTokDecoderViT(s, pixel.num_embeddings)
        self.latent_tokens = _scaled_normal((s.num_latent_tokens, s.width),
                                            s.width ** -0.5)
        self.quantize = L2VectorQuantizer(s.codebook_size, s.token_size,
                                          s.commitment_cost, s.use_l2_norm)
        self.pixel_quantize = PixelQuantizer(pixel.num_embeddings,
                                             pixel.embedding_dim)
        self.pixel_decoder = PixelDecoder(pixel)

    def decode(self, z_quantized: torch.Tensor) -> torch.Tensor:
        """(B, N, token_size) -> (B, tile, tile, 3) (reference: titok.py:126-132)."""
        return self.decode_vqgan_latent(self.decoder(z_quantized))

    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, N) int tokens -> pixels (reference: titok.py:134-143)."""
        return self.decode(self.quantize.decode_indices(tokens))

    def decode_tokens_to_latent(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, N) -> pixel-codebook logits (reference: titok.py:156-167)."""
        return self.decoder(self.quantize.decode_indices(tokens))

    def decode_vqgan_latent(self, logits: torch.Tensor) -> torch.Tensor:
        """(reference: titok.py:169-175)"""
        return self.pixel_decoder(self.pixel_quantize.soft_decode(logits))
