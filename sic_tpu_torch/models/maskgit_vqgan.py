"""MaskGIT-VQGAN pixel tokenizer (NHWC): the CNN VQGAN that TiTok uses as
its pixel-space tokenizer and decoder.

Counterpart of the JAX package's ``models/maskgit_vqgan.py`` (reference:
src/titok/maskgit_vqgan.py:157-381): the ``pixel_quantize`` /
``pixel_decoder`` pair inside the full :class:`~.titok.TiTok` and the
:class:`~.titok.PretrainedTokenizer`.  Submodules carry the JAX package's
names (``down_<i>_block_<j>``, ``mid_<j>``, ``up_<i>_block_<j>``,
``up_<i>_upsample_conv``), so ``weights.load_flax_params`` maps every
parameter with no table.

As in the JAX package:

- every convolution is stride 1 (down and up sampling are a 2x2 average
  pool and a nearest repeat), with SAME padding;
- the resnet block keeps the upstream quirk: where the channel counts
  differ, the 1x1 shortcut reads the block's *output* (maskgit_vqgan.py:
  87-88), so the result is ``h + conv1x1(h)``;
- the quantizer's scores ``2 z.e - |e|^2`` and its argmax, and the soft
  decode's softmax, run in f32.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from .layers import Conv2d, GroupNorm
from .quantizer import nearest_code


@dataclasses.dataclass(frozen=True)
class MaskGITVQGANSpec:
    """Pixel-tokenizer config (reference: titok/titok.py:33-40)."""
    hidden_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    z_channels: int = 256
    num_channels: int = 3
    num_embeddings: int = 1024
    embedding_dim: int = 256
    commitment_cost: float = 0.25

    @property
    def num_resolutions(self) -> int:
        return len(self.channel_mult)


def _gn(ch: int) -> GroupNorm:
    # torch GroupNorm(32, ch, eps=1e-6), as the reference, then swish
    # (every norm here is followed by one)
    return GroupNorm(32, ch, eps=1e-6, silu=True)


class PixelResnetBlock(nn.Module):
    """(reference: maskgit_vqgan.py:54-91)"""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = _gn(in_ch)
        self.conv1 = Conv2d(in_ch, out_ch, 3, bias=False)
        self.norm2 = _gn(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, bias=False)
        if in_ch != out_ch:
            self.nin_shortcut = Conv2d(out_ch, out_ch, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if hasattr(self, "nin_shortcut"):
            # the upstream quirk: the shortcut reads the block's output
            x = self.nin_shortcut(h)
        return h + x


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))


def _repeat2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 as a broadcast (a deterministic backward, as the VQGAN's
    Upsample)."""
    B, H, W, C = x.shape
    x = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
    return x.reshape(B, 2 * H, 2 * W, C)


class PixelEncoder(nn.Module):
    """(reference: maskgit_vqgan.py:159-198)"""

    def __init__(self, spec: MaskGITVQGANSpec = MaskGITVQGANSpec()):
        super().__init__()
        s = self.spec = spec
        self.conv_in = Conv2d(s.num_channels, s.hidden_channels, 3, bias=False)
        ch = s.hidden_channels
        for i, mult in enumerate(s.channel_mult):
            for j in range(s.num_res_blocks):
                self.add_module(f"down_{i}_block_{j}",
                                PixelResnetBlock(ch, s.hidden_channels * mult))
                ch = s.hidden_channels * mult
        for j in range(s.num_res_blocks):
            self.add_module(f"mid_{j}", PixelResnetBlock(ch, ch))
        self.norm_out = _gn(ch)
        self.conv_out = Conv2d(ch, s.z_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.spec
        h = self.conv_in(x)
        for i in range(s.num_resolutions):
            for j in range(s.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}")(h)
            if i != s.num_resolutions - 1:
                h = _avg_pool2(h)
        for j in range(s.num_res_blocks):
            h = getattr(self, f"mid_{j}")(h)
        return self.conv_out(self.norm_out(h))


class PixelDecoder(nn.Module):
    """(reference: maskgit_vqgan.py:201-266, with ``forward_with_latent``)"""

    def __init__(self, spec: MaskGITVQGANSpec = MaskGITVQGANSpec()):
        super().__init__()
        s = self.spec = spec
        ch = s.hidden_channels * s.channel_mult[-1]
        self.conv_in = Conv2d(s.z_channels, ch, 3)
        for j in range(s.num_res_blocks):
            self.add_module(f"mid_{j}", PixelResnetBlock(ch, ch))
        # index i is the state dict's block_idx; the blocks run from the
        # highest multiplier down (maskgit_vqgan.py:225-229)
        for i in reversed(range(s.num_resolutions)):
            block_out = s.hidden_channels * s.channel_mult[i]
            for j in range(s.num_res_blocks):
                self.add_module(f"up_{i}_block_{j}", PixelResnetBlock(ch, block_out))
                ch = block_out
            if i != 0:
                self.add_module(f"up_{i}_upsample_conv", Conv2d(ch, ch, 3))
        self.norm_out = _gn(ch)
        self.conv_out = Conv2d(ch, s.num_channels, 3)

    def forward(self, z: torch.Tensor, return_latent: bool = False):
        s = self.spec
        h = self.conv_in(z)
        for j in range(s.num_res_blocks):
            h = getattr(self, f"mid_{j}")(h)
        for i in reversed(range(s.num_resolutions)):
            for j in range(s.num_res_blocks):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample_conv")(_repeat2(h))
        latent = h
        img = self.conv_out(self.norm_out(h))
        return (img, latent) if return_latent else img


class PixelQuantizer(nn.Module):
    """MishaLaskin-style VQ with the soft-code decode path
    (reference: maskgit_vqgan.py:269-381)."""

    def __init__(self, num_embeddings: int = 1024, embedding_dim: int = 256):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, embedding_dim)
                                      .uniform_(-1.0 / num_embeddings,
                                                1.0 / num_embeddings))

    def forward(self, z: torch.Tensor):
        """z: (B, H, W, C) -> (z_q (B, H, W, C), indices (B, H, W)), the
        nearest code by f32 scores (the inference path: no losses)."""
        B, H, W, C = z.shape
        idx = nearest_code(z.float().reshape(-1, C), self.embedding)
        return self.embedding[idx].reshape(B, H, W, C).to(z.dtype), \
            idx.reshape(B, H, W)

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        """(B, H, W) or (B, N) int -> (B, H, W, C)
        (reference: maskgit_vqgan.py:340-355)."""
        if indices.dim() == 2:
            B, N = indices.shape
            side = int(N ** 0.5)
            indices = indices.reshape(B, side, side)
        return self.embedding[indices.long()]

    def soft_decode(self, logits: torch.Tensor) -> torch.Tensor:
        """softmax(logits) @ embedding, the softmax in f32: TiTok's
        generative pixel path (reference: titok/titok.py:128-131).
        logits: (B, H, W, K) -> (B, H, W, embedding_dim)."""
        return torch.softmax(logits.float(), dim=-1) @ self.embedding
