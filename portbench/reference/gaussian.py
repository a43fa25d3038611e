"""Device math for the scale-indexed Gaussian coder (PyTorch).

The scale -> CDF-table-index map consumed by both rANS decoders, with the
same float32 arithmetic as the JAX package's ``build_indexes`` so a stream
encoded by either package selects the same tables here; and the training
math: the gated lower bound, the Gaussian and Laplace likelihoods and their
bit costs (reference behaviours: src/entropy/entropy_models.py:14-28, 252-374).
"""
from __future__ import annotations

import math

import torch

from .tables import GAUSSIAN_SCALE_MIN, SCALE_LEVELS, SCALE_MAX


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x >= bound)
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (passthrough,) = ctx.saved_tensors
        return torch.where(passthrough | (g < 0), g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``max(x, bound)`` whose gradient passes where ``x >= bound``, or
    where it pushes ``x`` up toward the bound (reference:
    entropy_models.py:14-28)."""
    return _LowerBound.apply(x, bound)


def build_indexes(scales: torch.Tensor, skip_thres=None,
                  levels: int = SCALE_LEVELS) -> torch.Tensor:
    """Map float32 scales to int32 CDF table indexes; positions below the
    skip threshold get -1 and are dropped by the coders."""
    log_min = math.log(GAUSSIAN_SCALE_MIN)
    step = (math.log(SCALE_MAX) - log_min) / (levels - 1)
    s = torch.clamp_min(scales, 1e-5)
    idx = (torch.log(s) - log_min) / step
    idx = torch.clamp(idx, 0, levels - 1)
    if skip_thres is not None:
        idx = torch.where(scales < skip_thres, torch.full_like(idx, -1.0), idx)
    return idx.to(torch.int32)
