"""Four-part autoregressive spatial-channel prior: masks and plane math.

The latent is split into 4 channel quarters x 4 checkerboard phases; each of
the four coding steps writes one plane, and training runs all four in one
differentiable pass (reference:
src/entropy/compression_model.py:241-418).  NHWC, channel quarters on the
last axis, as in the JAX package, so index and symbol planes compare
element for element.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .gaussian import lower_bound


def quant_ste(x: torch.Tensor) -> torch.Tensor:
    """Round with a straight-through gradient (reference:
    compression_model.py:87-93)."""
    return x + (torch.round(x) - x).detach()


def add_uniform_noise(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None,
                      level: float = 0.5) -> torch.Tensor:
    """``x`` plus U(-level, level) noise, drawn from ``generator`` or given
    as ``noise`` (so a test can feed another framework's draw)."""
    if noise is None:
        noise = uniform_noise(x.shape, generator, x.device, x.dtype, level)
    return x + noise


def uniform_noise(shape, generator: Optional[torch.Generator], device,
                  dtype=torch.float32, level: float = 0.5) -> torch.Tensor:
    """The U(-level, level) draw of :func:`add_uniform_noise`."""
    return (torch.rand(shape, generator=generator, device=device,
                       dtype=dtype) * 2.0 - 1.0) * level


def checkerboard_masks(height: int, width: int) -> tuple:
    """The four 2x2 one-hot phase masks, each (H, W) float32 numpy."""
    r = np.arange(height)[:, None] % 2
    c = np.arange(width)[None, :] % 2
    return tuple(((r == a) & (c == b)).astype(np.float32)
                 for a, b in ((0, 0), (0, 1), (1, 0), (1, 1)))


def four_part_masks(height: int, width: int, channels: int,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """Step masks (4, H, W, C): channel quarters rotate through the four
    checkerboard phases (reference: compression_model.py:269-283)."""
    if channels % 4:
        raise ValueError(f"channels must be a multiple of 4, got {channels}")
    m0, m1, m2, m3 = checkerboard_masks(height, width)
    quarter = channels // 4

    def cat(phases):
        return np.concatenate(
            [np.broadcast_to(p[:, :, None], (height, width, quarter))
             for p in phases], axis=-1)

    masks = np.stack([cat((m0, m1, m2, m3)), cat((m3, m2, m1, m0)),
                      cat((m2, m3, m0, m1)), cat((m1, m0, m3, m2))])
    return torch.from_numpy(masks).to(device=device, dtype=dtype)


def combine_for_writing(x: torch.Tensor) -> torch.Tensor:
    """Collapse the 4 channel quarters by addition -> (B, H, W, C/4).
    At any step exactly one quarter is live per position, so the sum is a
    gather (reference: compression_model.py:296-301)."""
    x0, x1, x2, x3 = torch.chunk(x, 4, dim=-1)
    return (x0 + x1) + (x2 + x3)


def uncombine(plane: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Scatter a written plane back to full channels under ``mask``."""
    return torch.cat([plane] * 4, dim=-1) * mask


def separate_prior(params: torch.Tensor):
    """Split fused prior features into (quant_step, scales, means)
    (reference: compression_model.py:208-210, the "quantstep3" layout)."""
    return torch.chunk(params, 3, dim=-1)


def process_with_mask(y, scales, means, mask,
                      force_zero_thres: Optional[float], training: bool = False):
    """Quantize the masked positions (reference:
    compression_model.py:224-239); training rounds straight-through and
    never forces zeros."""
    scales_hat = scales * mask
    means_hat = means * mask
    y_res = (y - means_hat) * mask
    y_q = quant_ste(y_res) if training else torch.round(y_res)
    if (not training) and force_zero_thres is not None:
        cond = scales_hat < force_zero_thres
        y_q = torch.where(cond, torch.zeros_like(y_q), y_q)
        scales_hat = torch.where(cond, torch.zeros_like(scales_hat),
                                 scales_hat)
    y_hat = y_q + means_hat
    return y_res, y_q, y_hat, scales_hat


class FourPartForward(NamedTuple):
    y_res: torch.Tensor
    y_q: torch.Tensor
    y_hat: torch.Tensor
    scales_hat: torch.Tensor


def forward_four_part_prior(y, common_params, step_fns: Sequence[Callable],
                            reduction_fn: Optional[Callable] = None,
                            training: bool = False,
                            force_zero_thres: Optional[float] = None
                            ) -> FourPartForward:
    """All four coding steps in one differentiable pass (training and bpp
    evaluation; reference: compression_model.py:303-366)."""
    quant_step, scales, means = separate_prior(common_params)
    common = reduction_fn(common_params) if reduction_fn is not None \
        else common_params
    B, H, W, C = y.shape
    masks = four_part_masks(H, W, C, y.dtype, y.device)
    quant_step = lower_bound(quant_step, 0.5) if training \
        else torch.clamp_min(quant_step, 0.5)
    y = y / quant_step

    y_res, y_q, y_hat_so_far, s_hat = process_with_mask(
        y, scales, means, masks[0], force_zero_thres, training)
    outs = [(y_res, y_q, s_hat)]
    for i, step_fn in enumerate(step_fns):
        scales, means = step_fn(y_hat_so_far, common)
        y_res_i, y_q_i, y_hat_i, s_hat_i = process_with_mask(
            y, scales, means, masks[i + 1], force_zero_thres, training)
        y_hat_so_far = y_hat_so_far + y_hat_i
        outs.append((y_res_i, y_q_i, s_hat_i))
    y_res = sum(o[0] for o in outs)
    y_q = sum(o[1] for o in outs)
    scales_hat = sum(o[2] for o in outs)
    return FourPartForward(y_res, y_q, y_hat_so_far * quant_step, scales_hat)
