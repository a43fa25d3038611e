"""ConvNeXt block (NHWC) of the detail refiners
(reference: src/blocks/conv_blocks.py:48-81)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, LayerNorm, Linear


class ConvNeXtBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 mlp_ratio: float = 4.0, kernel_size: int = 7):
        super().__init__()
        out_ch = out_ch or in_ch
        self.layer_scale = nn.Parameter(torch.ones(in_ch))
        self.conv = Conv2d(in_ch, in_ch, kernel_size, groups=in_ch)
        self.norm = LayerNorm(in_ch)
        self.mlp_fc1 = Linear(in_ch, int(in_ch * mlp_ratio))
        self.mlp_fc2 = Linear(int(in_ch * mlp_ratio), out_ch)
        if out_ch != in_ch:
            self.short = Linear(in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.short(x) if hasattr(self, "short") else x
        # the layer scale multiplies in the activation's dtype
        h = self.conv(x * self.layer_scale.to(x.dtype))
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm(h))))
        return h + identity
