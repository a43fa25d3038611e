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

from .tables import GAUSSIAN_SCALE_MIN, LAPLACE_SCALE_MIN, SCALE_LEVELS, SCALE_MAX


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


def _ndtr(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF by the JAX package's piecewise erf/erfc formula
    (``jax.scipy.special.ndtr``)."""
    half_sqrt_2 = 0.5 * math.sqrt(2.0)
    w = x * half_sqrt_2
    z = torch.abs(w)
    y = torch.where(z < half_sqrt_2, 1.0 + torch.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def gaussian_prob(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """P(round(v) == v | N(0, scale)) via erfc, the training surrogate."""
    const = -(2.0 ** -0.5)
    scales = lower_bound(scales, GAUSSIAN_SCALE_MIN)
    values = torch.abs(values)
    upper = torch.erfc(const * (0.5 - values) / scales)
    lower = torch.erfc(const * (-0.5 - values) / scales)
    return lower_bound(0.5 * (upper - lower), 1e-9)


def laplace_prob(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """P(round(v) == v | Laplace(0, scale)), the training surrogate."""
    scales = lower_bound(scales, LAPLACE_SCALE_MIN)

    def _cdf2(x):
        return torch.sign(x) * (1.0 - torch.exp(-torch.abs(x)))

    upper = _cdf2((values + 0.5) / scales)
    lower = _cdf2((values - 0.5) / scales)
    return lower_bound(0.5 * (upper - lower), 1e-9)


def probs_to_bits(probs: torch.Tensor) -> torch.Tensor:
    bits = -torch.log(probs + 1e-5) / math.log(2.0)
    return lower_bound(bits, 0.0)


def gaussian_bits(y: torch.Tensor, sigma: torch.Tensor,
                  training: bool) -> torch.Tensor:
    """Per-element bit cost of quantized ``y`` under N(0, sigma)."""
    if training:
        return probs_to_bits(gaussian_prob(y, sigma))
    sigma = torch.clamp(sigma, 1e-5, 1e10)
    probs = _ndtr((y + 0.5) / sigma) - _ndtr((y - 0.5) / sigma)
    return probs_to_bits(probs)


def laplace_bits(y: torch.Tensor, sigma: torch.Tensor,
                 training: bool) -> torch.Tensor:
    """Per-element bit cost of quantized ``y`` under Laplace(0, sigma)."""
    if training:
        return probs_to_bits(laplace_prob(y, sigma))
    sigma = torch.clamp(sigma, 1e-5, 1e10)
    half = 0.5 * torch.exp(-torch.abs(y + 0.5) / sigma)
    upper = torch.where(y + 0.5 < 0, half, 1.0 - half)
    half2 = 0.5 * torch.exp(-torch.abs(y - 0.5) / sigma)
    lower = torch.where(y - 0.5 < 0, half2, 1.0 - half2)
    return probs_to_bits(upper - lower)


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
