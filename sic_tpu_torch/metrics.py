"""Image quality metrics: PSNR, SSIM, MS-SSIM on NHWC images.

Counterpart of the JAX package's ``metrics.py``: Wang et al.'s MS-SSIM
(11x11 gaussian window, sigma 1.5, the five standard power factors, the
``pytorch_msssim`` defaults), used by ``--perceptual msssim`` as a
differentiable loss.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Peak SNR; default range 2.0 for [-1, 1] images.  Returns (B,)."""
    mse = torch.mean((a.float() - b.float()) ** 2, dim=tuple(range(1, a.dim())))
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _blur(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise valid-conv gaussian blur, NHWC."""
    C = x.shape[-1]
    k = kernel[None, None].expand(C, 1, *kernel.shape)
    return F.conv2d(x.permute(0, 3, 1, 2), k, groups=C).permute(0, 2, 3, 1)


def _ssim_per_scale(a, b, kernel, data_range):
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = _blur(a, kernel), _blur(b, kernel)
    aa = _blur(a * a, kernel) - mu_a * mu_a
    bb = _blur(b * b, kernel) - mu_b * mu_b
    ab = _blur(a * b, kernel) - mu_a * mu_b
    cs = (2 * ab + c2) / (aa + bb + c2)
    ssim_map = ((2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)) * cs
    return ssim_map.mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Single-scale SSIM over NHWC images.  Returns (B,)."""
    k = torch.from_numpy(_gaussian_kernel()).to(a.device)
    s, _ = _ssim_per_scale(a.float(), b.float(), k, data_range)
    return s


def ms_ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Multi-scale SSIM (5 scales); images must be >= 176 px.  Returns (B,).
    Each factor is floored at 1e-4 before its fractional power: the power's
    derivative is infinite at 0, and a random decoder's anticorrelated
    patches drive cs negative."""
    a, b = a.float(), b.float()
    k = torch.from_numpy(_gaussian_kernel()).to(a.device)
    last = len(_MSSSIM_WEIGHTS) - 1
    out = None
    for i, w in enumerate(_MSSSIM_WEIGHTS):
        s, cs = _ssim_per_scale(a, b, k, data_range)
        v = torch.clamp_min(s if i == last else cs, 1e-4) ** w
        out = v if out is None else out * v
        if i != last:
            a = F.avg_pool2d(a.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
            b = F.avg_pool2d(b.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    return out
