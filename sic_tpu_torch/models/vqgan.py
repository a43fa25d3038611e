"""VQGAN (NHWC): the pixel decoder, the generative decode of the codec, and
the frozen teacher encoder that stage-feat training aligns to (reference:
src/taming/modules/diffusionmodules/model.py:342-537,
taming/models/vqgan.py:13-110).  GroupNorm(32, eps 1e-6) + swish resnet
stacks and single-head attention at the configured resolutions."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VQGANSpec
from .layers import Conv2d, GroupNorm
from .quantizer import VQGANQuantizer


def _norm(ch: int) -> GroupNorm:
    return GroupNorm(32, ch, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: Optional[int] = None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.norm1 = _norm(in_ch)
        self.conv1 = Conv2d(in_ch, out_ch, 3)
        self.norm2 = _norm(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3)
        if in_ch != out_ch:
            self.nin_shortcut = Conv2d(in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head attention over the spatial grid (reference:
    model.py:140-192).  Plain matmul + softmax, as the JAX package leaves it
    to XLA: at the f16 bottleneck the grid holds at most a few thousand
    positions and one head."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = _norm(ch)
        self.q = Conv2d(ch, ch)
        self.k = Conv2d(ch, ch)
        self.v = Conv2d(ch, ch)
        self.proj_out = Conv2d(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        h = self.norm(x)
        q = self.q(h).reshape(B, H * W, C)
        k = self.k(h).reshape(B, H * W, C)
        v = self.v(h).reshape(B, H * W, C)
        logits = torch.matmul(q, k.transpose(1, 2)) * (C ** -0.5)
        probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        h = torch.matmul(probs, v).reshape(B, H, W, C)
        return x + self.proj_out(h)


class Downsample(nn.Module):
    """Stride-2 3x3 convolution after the CompVis asymmetric pad, (0, 1) on
    H and W (reference: model.py:68-75)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return self.conv(x)


class Encoder(nn.Module):
    """Submodules are registered under the JAX package's names
    (``down_<level>_block_<i>``, ``down_<level>_attn_<i>``,
    ``down_<level>_downsample``); ``self.plan`` lists them in call order."""

    def __init__(self, spec: VQGANSpec):
        super().__init__()
        s = spec
        self.conv_in = Conv2d(s.in_channels, s.ch, 3)
        self.plan = []
        block_in, curr_res = s.ch, s.resolution
        for i_level, mult in enumerate(s.ch_mult):
            for i_block in range(s.num_res_blocks):
                self._add(f"down_{i_level}_block_{i_block}",
                          ResnetBlock(block_in, s.ch * mult))
                block_in = s.ch * mult
                if s.use_attn and curr_res in s.attn_resolutions:
                    self._add(f"down_{i_level}_attn_{i_block}", AttnBlock(block_in))
            if i_level != s.num_resolutions - 1:
                self._add(f"down_{i_level}_downsample", Downsample(block_in))
                curr_res //= 2
        self.mid_block_1 = ResnetBlock(block_in)
        self.use_attn = s.use_attn
        if s.use_attn:
            self.mid_attn_1 = AttnBlock(block_in)
        self.mid_block_2 = ResnetBlock(block_in)
        self.norm_out = _norm(block_in)
        self.conv_out = Conv2d(block_in, s.z_channels, 3)

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.plan.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for name in self.plan:
            h = getattr(self, name)(h)
        h = self.mid_block_1(h)
        if self.use_attn:
            h = self.mid_attn_1(h)
        h = self.mid_block_2(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    """Submodules are registered under the JAX package's names
    (``up_<level>_block_<i>``, ``up_<level>_attn_<i>``,
    ``up_<level>_upsample``); ``self.plan`` lists them in call order."""

    def __init__(self, spec: VQGANSpec):
        super().__init__()
        s = spec
        block_in = s.ch * s.ch_mult[-1]
        curr_res = s.resolution // s.downsample_factor
        self.conv_in = Conv2d(s.z_channels, block_in, 3)
        self.mid_block_1 = ResnetBlock(block_in)
        self.use_attn = s.use_attn
        if s.use_attn:
            self.mid_attn_1 = AttnBlock(block_in)
        self.mid_block_2 = ResnetBlock(block_in)
        self.plan = []
        for i_level in reversed(range(s.num_resolutions)):
            out_ch = s.ch * s.ch_mult[i_level]
            for i_block in range(s.num_res_blocks + 1):
                self._add(f"up_{i_level}_block_{i_block}",
                          ResnetBlock(block_in, out_ch))
                block_in = out_ch
                if s.use_attn and curr_res in s.attn_resolutions:
                    self._add(f"up_{i_level}_attn_{i_block}", AttnBlock(block_in))
            if i_level != 0:
                self._add(f"up_{i_level}_upsample", Upsample(block_in))
                curr_res *= 2
        self.norm_out = _norm(block_in)
        self.conv_out = Conv2d(block_in, s.out_ch, 3)

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.plan.append(name)

    def forward(self, z: torch.Tensor, return_pre: bool = False):
        """``return_pre``: also the activation before ``conv_out``, which
        the adaptive GAN weight re-applies the last convolution to."""
        h = self.mid_block_1(self.conv_in(z))
        if self.use_attn:
            h = self.mid_attn_1(h)
        h = self.mid_block_2(h)
        for name in self.plan:
            h = getattr(self, name)(h)
        h = F.silu(self.norm_out(h))
        out = self.conv_out(h)
        return (out, h) if return_pre else out


class VQGAN(nn.Module):
    """Decoder + codebook + post-quant conv, and the teacher encoder +
    quant conv (reference: taming/models/vqgan.py:13-110).  The teacher is
    registered last, so the decode side's parameters come first."""

    def __init__(self, spec: VQGANSpec):
        super().__init__()
        self.decoder = Decoder(spec)
        self.quantize = VQGANQuantizer(spec.n_embed, spec.embed_dim)
        self.post_quant_conv = Conv2d(spec.embed_dim, spec.z_channels)
        self.encoder = Encoder(spec)
        self.quant_conv = Conv2d(spec.z_channels, spec.embed_dim)

    def encode_latent(self, x: torch.Tensor) -> torch.Tensor:
        """Pre-VQ latent of an image in [-1, 1] (the frozen teacher path of
        stage-feat training)."""
        return self.quant_conv(self.encoder(x))

    def decode(self, quant: torch.Tensor, return_pre: bool = False):
        return self.decoder(self.post_quant_conv(quant), return_pre=return_pre)
