"""CDF table construction for the scale-indexed Gaussian/Laplace coder.

Built once on the host after model load (the analogue of the reference's
``GaussianEncoder.update``, reference: src/entropy/entropy_models.py:252-353),
then registered with the native coder.  The per-pixel table *selection*
(``build_indexes``) runs on the device — see ``entropy/gaussian.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Literal

import numpy as np
from scipy.special import ndtr  # standard normal CDF

from .rans import pmf_to_quantized_cdf

SCALE_LEVELS = 256
GAUSSIAN_SCALE_MIN = 0.11
LAPLACE_SCALE_MIN = 0.01
SCALE_MAX = 64.0
PRECISION = 16


def scale_table(distribution: Literal["gaussian", "laplace"] = "gaussian",
                levels: int = SCALE_LEVELS) -> np.ndarray:
    """Log-spaced scale grid (reference: entropy_models.py:273-275)."""
    smin = GAUSSIAN_SCALE_MIN if distribution == "gaussian" else LAPLACE_SCALE_MIN
    return np.exp(np.linspace(math.log(smin), math.log(SCALE_MAX), levels))


def _cdf(x: np.ndarray, scales: np.ndarray, distribution: str) -> np.ndarray:
    if distribution == "gaussian":
        return ndtr(x / scales)
    # Laplace(0, b): F(x) = 0.5 + 0.5*sign(x)*(1 - exp(-|x|/b))
    return 0.5 + 0.5 * np.sign(x) * (1.0 - np.exp(-np.abs(x) / scales))


@dataclass(frozen=True)
class GaussianCdfTables:
    quantized_cdf: np.ndarray  # (levels, max_len + 2) int32, zero padded
    cdf_length: np.ndarray     # (levels,) int32 == pmf_length + 2
    offset: np.ndarray         # (levels,) int32 == -pmf_center
    distribution: str
    scale_min: float
    log_scale_min: float
    log_scale_step: float

    @property
    def levels(self) -> int:
        return int(self.cdf_length.shape[0])


def build_gaussian_tables(
        distribution: Literal["gaussian", "laplace"] = "gaussian",
        levels: int = SCALE_LEVELS) -> GaussianCdfTables:
    """Build per-scale quantized CDF tables.

    For each scale s the support is [-c, c] with c the smallest integer in
    [2, 50] whose CDF exceeds 0.9999 (reference: entropy_models.py:313-334);
    tail mass 2*F(-c-0.5) is appended as the escape symbol.
    """
    scales = scale_table(distribution, levels).astype(np.float64)

    pmf_center = np.full(levels, 50, dtype=np.int64)
    for i in range(50, 1, -1):
        probs = _cdf(np.full(levels, float(i)), scales, distribution)
        pmf_center = np.where(probs > 0.9999, i, pmf_center)
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())

    samples = (np.arange(max_length)[None, :] - pmf_center[:, None]).astype(np.float32)
    sc = np.broadcast_to(scales[:, None], samples.shape)
    upper = _cdf(samples + 0.5, sc, distribution).astype(np.float32)
    lower = _cdf(samples - 0.5, sc, distribution).astype(np.float32)
    pmf = (upper - lower).astype(np.float32)
    tail_mass = (2.0 * lower[:, :1]).astype(np.float32)

    quantized = np.zeros((levels, max_length + 2), dtype=np.int32)
    for i in range(levels):
        row_pmf = np.concatenate([pmf[i, : pmf_length[i]], tail_mass[i]])
        cdf = pmf_to_quantized_cdf(row_pmf, PRECISION)
        quantized[i, : cdf.shape[0]] = cdf

    smin = GAUSSIAN_SCALE_MIN if distribution == "gaussian" else LAPLACE_SCALE_MIN
    return GaussianCdfTables(
        quantized_cdf=quantized,
        cdf_length=(pmf_length + 2).astype(np.int32),
        offset=(-pmf_center).astype(np.int32),
        distribution=distribution,
        scale_min=smin,
        log_scale_min=math.log(smin),
        log_scale_step=(math.log(SCALE_MAX) - math.log(smin)) / (levels - 1),
    )


