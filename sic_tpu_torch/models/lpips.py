"""LPIPS perceptual distance (NHWC).

Counterpart of the JAX package's ``models/lpips.py`` (reference:
src/taming/modules/losses/lpips.py:11-123): VGG16 feature slices ->
unit-normalize -> squared difference -> learned per-channel calibration ->
spatial mean -> sum over slices.  :func:`load_lpips_weights` reads the
calibration heads (``vgg.pth``) and a torchvision VGG16 state dict with
``torch.load``; without them the backbone is the seeded one and the
distance is uncalibrated.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d

# VGG16 "features" plan: channels per conv, "M" = maxpool
_VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512)
# slice boundaries: outputs after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_SLICE_AFTER_CONV = (2, 4, 7, 10, 13)
CHANNELS = (64, 128, 256, 512, 512)

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class VGG16Features(nn.Module):
    """The five LPIPS feature slices of VGG16 (``conv_<i>`` in call order)."""

    def __init__(self):
        super().__init__()
        prev, i = 3, 0
        for item in _VGG16_PLAN:
            if item != "M":
                self.add_module(f"conv_{i}", Conv2d(prev, item, 3))
                prev, i = item, i + 1

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats, i = [], 0
        for item in _VGG16_PLAN:
            if item == "M":
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
            else:
                x = F.relu(getattr(self, f"conv_{i}")(x))
                i += 1
                if i in _SLICE_AFTER_CONV:
                    feats.append(x)
        return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """Frozen perceptual distance; inputs NHWC in [-1, 1]; returns (B,)."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, ch in enumerate(CHANNELS):
            setattr(self, f"lin_{i}", nn.Parameter(torch.ones(ch)))
        self.register_buffer("shift", torch.tensor(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE), persistent=False)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initialisation: lecun-normal convolutions, zero biases,
        unit calibration heads."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.startswith("lin_"):
                    p.fill_(1.0)
                elif name.endswith("bias"):
                    p.zero_()
                else:
                    p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.vgg((x - self.shift) / self.scale)
        fy = self.vgg((y - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            val = torch.sum(d * getattr(self, f"lin_{i}"), dim=-1)   # (B, H, W)
            total = total + torch.mean(val, dim=(1, 2))
        return total


def load_lpips_weights(lpips: LPIPS, lin_ckpt: Optional[str] = None,
                       vgg_ckpt: Optional[str] = None) -> None:
    """Load the LPIPS calibration heads (``lin<i>.model.1.weight``) and/or a
    torchvision VGG16 state dict (``features.<n>.weight|bias``, taken in
    layer order) into ``lpips``."""
    with torch.no_grad():
        if lin_ckpt:
            sd = torch.load(lin_ckpt, map_location="cpu")
            for i in range(len(CHANNELS)):
                getattr(lpips, f"lin_{i}").copy_(
                    sd[f"lin{i}.model.1.weight"].reshape(-1))
        if vgg_ckpt:
            sd = torch.load(vgg_ckpt, map_location="cpu")
            layers = sorted({int(k.split(".")[1]) for k in sd
                             if k.startswith("features.") and k.endswith(".weight")})
            for i, n in enumerate(layers):
                conv = getattr(lpips.vgg, f"conv_{i}")
                conv.weight.copy_(sd[f"features.{n}.weight"])
                conv.bias.copy_(sd[f"features.{n}.bias"])
