"""PatchGAN discriminator (NHWC).

Counterpart of the JAX package's ``models/discriminator.py`` (reference:
src/taming/modules/discriminator/model.py:17-67).  Its BatchNorm follows
flax's rules, not ``nn.BatchNorm2d``'s: a training pass normalises with the
batch statistics, and only when asked (``update_stats=True``) folds them
into the running statistics as ``0.9 * running + 0.1 * batch`` with the
*biased* batch variance.  The training steps ask only on the discriminator's
own update (real, then fake), as the JAX steps keep only those statistics.

Under data parallelism (:meth:`NLayerDiscriminator.set_data_group`) the
batch statistics are the global batch's: each rank's mean and mean square
are averaged over the data group, in the forward and (through
``parallel.global_mean``) in the backward, and the running statistics move
by the global ones, the same on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.multihost import global_mean


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis of an NHWC tensor; parameters ``scale``/``bias`` and statistics
    ``mean``/``var`` carry flax's names."""

    def __init__(self, ch: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))
        self.data = None    # the data group whose global batch is normalised

    def forward(self, x: torch.Tensor, train: bool,
                update_stats: bool = False) -> torch.Tensor:
        if not train:
            mean, var = self.mean, self.var
        else:
            mean = global_mean(x.mean(dim=(0, 1, 2)), self.data)
            # flax's fast variance: E[x^2] - E[x]^2, floored at 0
            msq = global_mean((x * x).mean(dim=(0, 1, 2)), self.data)
            var = torch.clamp_min(msq - mean * mean, 0.0)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.mul_(m).add_((1.0 - m) * mean.detach())
                    self.var.mul_(m).add_((1.0 - m) * var.detach())
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias


class _Conv(nn.Conv2d):
    """4x4 convolution on NHWC tensors with a symmetric pad of 1."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, bias: bool = True):
        super().__init__(in_ch, out_ch, 4, stride=stride, padding=1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class NLayerDiscriminator(nn.Module):
    def __init__(self, ndf: int = 64, n_layers: int = 3, input_nc: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv_0 = _Conv(input_nc, ndf, 2)
        prev = ndf
        for n in range(1, n_layers + 1):
            ch = ndf * min(2 ** n, 8)
            self.add_module(f"conv_{n}", _Conv(prev, ch, 2 if n < n_layers else 1,
                                              bias=False))
            self.add_module(f"bn_{n}", BatchNorm(ch))
            prev = ch
        self.conv_out = _Conv(prev, 1, 1)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """The reference's weights_init: convolutions N(0, 0.02), BatchNorm
        scales N(1, 0.02), biases 0 (reference: model.py:9-14)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif name.endswith("scale"):
                    p.normal_(1.0, 0.02, generator=generator)
                else:
                    p.normal_(0.0, 0.02, generator=generator)

    def set_data_group(self, data) -> None:
        """Normalise with the statistics of the global batch split over the
        data group ``data`` (None: this process's batch)."""
        for n in range(1, self.n_layers + 1):
            getattr(self, f"bn_{n}").data = data

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = False) -> torch.Tensor:
        """x (B, H, W, 3) -> patch logits (B, H', W', 1).  A bf16 image (a
        bf16 codec's reconstruction) is promoted to the parameters' f32, as
        flax's convolution promotes it."""
        x = F.leaky_relu(self.conv_0(x.to(self.conv_0.weight.dtype)), 0.2)
        for n in range(1, self.n_layers + 1):
            x = getattr(self, f"conv_{n}")(x)
            x = getattr(self, f"bn_{n}")(x, train, update_stats)
            x = F.leaky_relu(x, 0.2)
        return self.conv_out(x)
