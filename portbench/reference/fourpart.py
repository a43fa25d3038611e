"""Four-part autoregressive spatial-channel prior: masks and plane math.

The latent is split into 4 channel quarters x 4 checkerboard phases; each of
the four coding steps writes one plane (reference:
src/entropy/compression_model.py:241-418).  NHWC, channel quarters on the
last axis, as in the JAX package, so index and symbol planes compare
element for element.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


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


def separate_prior(params: torch.Tensor):
    """Split fused prior features into (quant_step, scales, means)
    (reference: compression_model.py:208-210, the "quantstep3" layout)."""
    return torch.chunk(params, 3, dim=-1)


def process_with_mask(y, scales, means, mask, force_zero_thres: Optional[float]):
    """Quantize the masked positions (reference:
    compression_model.py:224-239)."""
    scales_hat = scales * mask
    means_hat = means * mask
    y_res = (y - means_hat) * mask
    y_q = torch.round(y_res)
    if force_zero_thres is not None:
        cond = scales_hat < force_zero_thres
        y_q = torch.where(cond, torch.zeros_like(y_q), y_q)
        scales_hat = torch.where(cond, torch.zeros_like(scales_hat),
                                 scales_hat)
    y_hat = y_q + means_hat
    return y_res, y_q, y_hat, scales_hat


