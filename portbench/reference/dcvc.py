"""DCVC-style depthwise conv blocks (NHWC) of the bottleneck transforms and
the spatial prior nets (reference: src/blocks/dcvc.py:14-66)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class DepthConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, slope: float = 0.01):
        super().__init__()
        self.slope = slope
        if in_ch != out_ch:
            self.adaptor = Conv2d(in_ch, out_ch)
        self.conv1 = Conv2d(in_ch, in_ch)
        self.depth_conv = Conv2d(in_ch, in_ch, 3, groups=in_ch)
        self.conv2 = Conv2d(in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.adaptor(x) if hasattr(self, "adaptor") else x
        out = F.leaky_relu(self.conv1(x), self.slope)
        out = self.conv2(self.depth_conv(out))
        return out + identity


class ConvFFN3(nn.Module):
    """Gated 1x1 FFN with dual leaky slopes (reference: dcvc.py:40-54)."""

    def __init__(self, in_ch: int):
        super().__init__()
        internal = in_ch * 2
        self.conv = Conv2d(in_ch, internal * 2)
        self.conv_out = Conv2d(internal, in_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = torch.chunk(self.conv(x), 2, dim=-1)
        out = F.leaky_relu(x1, 0.1) + F.leaky_relu(x2, 0.01)
        return x + self.conv_out(out)


class DepthConvBlock4(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, slope_depth_conv: float = 0.01):
        super().__init__()
        self.depth = DepthConv(in_ch, out_ch, slope_depth_conv)
        self.ffn = ConvFFN3(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ffn(self.depth(x))
