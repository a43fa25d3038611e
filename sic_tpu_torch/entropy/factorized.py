"""Factorized-prior entropy model: a learned per-channel CDF.

Counterpart of the JAX package's ``entropy/factorized.py`` (``Bitparm`` /
``BitEstimator``, reference: src/entropy/entropy_models.py:97-249): four
monotone layers parameterize a per-channel CDF; :class:`FactorizedCoder`
scans [-50, 50] for each channel's support, builds one quantized CDF table
a channel and codes NHWC symbol planes with the host rANS coder, the table
chosen by channel.  The shipped codec instantiates none of it (the
reference builds it only for an ``mv_z_channel``); it is here for parity.

Per-channel parameters have shape (C,) and broadcast over the last axis.
"""
from __future__ import annotations

import struct
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .coder import EntropyCoder, pmf_to_quantized_cdf
from .gaussian import lower_bound


class Bitparm(nn.Module):
    """One monotone CDF layer (reference: entropy_models.py:97-117); its
    parameters start at N(0, 0.01), as the JAX package's."""

    def __init__(self, channel: int, final: bool = False):
        super().__init__()
        self.final = final
        self.h = nn.Parameter(0.01 * torch.randn(channel))
        self.b = nn.Parameter(0.01 * torch.randn(channel))
        if not final:
            self.a = nn.Parameter(0.01 * torch.randn(channel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * F.softplus(self.h) + self.b
        if self.final:
            return x
        return x + torch.tanh(x) * torch.tanh(self.a)


class BitEstimator(nn.Module):
    """Stacked Bitparm CDF model over the channel axis."""

    def __init__(self, channel: int):
        super().__init__()
        self.channel = channel
        self.f1 = Bitparm(channel)
        self.f2 = Bitparm(channel)
        self.f3 = Bitparm(channel)
        self.f4 = Bitparm(channel, final=True)

    def get_logits_cdf(self, x: torch.Tensor) -> torch.Tensor:
        return self.f4(self.f3(self.f2(self.f1(x))))

    def get_cdf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.get_logits_cdf(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.get_cdf(x)

    def get_prob(self, x: torch.Tensor) -> torch.Tensor:
        """P(round == x), by the numerically stable sign trick (reference:
        entropy_models.py:160-170)."""
        lower = self.get_logits_cdf(x - 0.5)
        upper = self.get_logits_cdf(x + 0.5)
        sign = -torch.sign(lower + upper).detach()
        prob = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
        return lower_bound(prob, 1e-9)

    def get_bits(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(-torch.log2(self.get_prob(x) + 1e-5), 0.0)


# -- the CDF the tables are built from, in fixed IEEE f32 arithmetic -----------
#
# A table entry is a 16-bit rounding of a CDF difference, so an ulp in the
# CDF moves a count for about one entry in a hundred, and a stream written
# with one table does not decode with the other.  The library tanh, exp and
# log1p of PyTorch (and of its CPU and CUDA builds apart) and of XLA differ
# in the last bit.  So the tables are built from the CDF computed step by
# step in f32 additions, multiplications, divisions, floors and bit
# operations, each correctly rounded on every device: the formulas XLA's CPU
# backend emits for the JAX package's ``jax.nn.softplus`` (max(h, 0) +
# log1p(exp(-|h|))), ``tanh`` (a rational approximation) and
# ``jax.nn.sigmoid`` (1 / (1 + exp(-x))), exp and log as Cephes'
# polynomials, with its contraction of each product feeding an add into
# one fused multiply-add (:func:`_fma`).  The port's tables then equal the
# JAX package's on the CPU, byte for byte, and are the same on the CPU and
# the card.

def _f32(bits: int) -> float:
    """The f32 whose bit pattern is ``bits`` (exactly, as a Python float)."""
    return struct.unpack("<f", struct.pack("<I", bits))[0]


_TANH_SMALL, _TANH_CLAMP = _f32(0x39D1B717), _f32(0x40FFF644)
_TANH_P = [_f32(b) for b in (0xA59F25C0, 0x2A61337E, 0xAEBD37FF, 0x335C0041,
                             0x3779434A, 0x3A270DED, 0x3BA059DC)]
_TANH_Q = [_f32(b) for b in (0x35A0D3D8, 0x38F895D6, 0x3B14AA05, 0x3BA059DD)]
_EXP_LO, _EXP_HI, _LOG2E = _f32(0xC2AF999A), _f32(0x42B1999A), _f32(0x3FB8AA3B)
_LN2_HI, _LN2_LO = _f32(0x3F318000), _f32(0xB95E8083)
_EXP_P = [_f32(b) for b in (0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1,
                            0x3E2AAAAA)]
_MIN_NORMAL, _SQRT_HALF = _f32(0x00800000), _f32(0x3F3504F3)
_LOG_A = [_f32(b) for b in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A)]
_LOG_B = [_f32(b) for b in (0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50)]
_LOG_C = [_f32(b) for b in (0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)]
_L1P_SMALL = _f32(0x3ED413CD)
_L1P_P = [_f32(b) for b in (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C,
                            0x4273CC76, 0x426473AD, 0x41A05101)]
_L1P_Q = [_f32(b) for b in (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3,
                            0x43586D8A, 0x42707982)]


def _fma(a, b, c) -> torch.Tensor:
    """f32 a * b + c with one rounding (the product is exact in f64)."""
    d = lambda v: v.double() if isinstance(v, torch.Tensor) else v  # noqa: E731
    return (d(a) * d(b) + d(c)).float()


def _exp(x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp(x, _EXP_LO, _EXP_HI)
    fx = torch.clamp(torch.floor(_fma(t, _LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(-fx, _LN2_HI, t)
    r = _fma(-fx, _LN2_LO, r)
    y = _fma(r, _EXP_P[0], _EXP_P[1])
    for c in (*_EXP_P[2:], 0.5):
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + 1.0
    return y * ((fx.to(torch.int32) << 23) + 0x3F800000).view(torch.float32)


def _log(y: torch.Tensor) -> torch.Tensor:
    """log of y > 0 (the CDF's arguments are in (1, 2])."""
    bits = torch.where(y > _MIN_NORMAL, y, torch.full_like(y, _MIN_NORMAL)).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    e = e - small.to(torch.float32)
    x = (m + -1.0) + torch.where(small, m, torch.zeros_like(m))
    z = x * x
    x3 = z * x
    pa = _fma(_fma(x, _LOG_A[0], _LOG_A[1]), x, _LOG_A[2])
    pb = _fma(_fma(x, _LOG_B[0], _LOG_B[1]), x, _LOG_B[2])
    pc = _fma(_fma(x, _LOG_C[0], _LOG_C[1]), x, _LOG_C[2])
    r = _fma(_fma(_fma(pa, x3, pb), x3, pc), x3, e * _LN2_LO)
    return _fma(e, _LN2_HI, _fma(-z, 0.5, x) + r)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    q = _fma(x, 0.0, 1.0)
    for c in _L1P_Q:
        q = _fma(q, x, c)
    p = _fma(x, 0.0, _L1P_P[0])
    for c in _L1P_P[1:]:
        p = _fma(p, x, c)
    x2 = x * x
    near = x + _fma(x2, -0.5, (x * x2) * (p / q))
    return torch.where(torch.abs(x) < _L1P_SMALL, near, _log(x + 1.0))


def _tanh(x: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    c2 = c * c
    p = _fma(c2, _TANH_P[0], _TANH_P[1])
    for k in _TANH_P[2:]:
        p = _fma(c2, p, k)
    q = _fma(c2, _TANH_Q[0], _TANH_Q[1])
    for k in _TANH_Q[2:]:
        q = _fma(c2, q, k)
    out = torch.where(torch.abs(x) < _TANH_SMALL, x, (c * p) / q)
    return torch.where(torch.abs(x) >= 20.0, torch.sign(x), out)


def _softplus(h: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(h), h,
                       torch.clamp_min(h, 0.0) + _log1p(_exp(-torch.abs(h))))


@torch.no_grad()
def table_cdf(module: "BitEstimator", x: torch.Tensor) -> torch.Tensor:
    """The module's CDF at ``x`` (..., C), f32, in the fixed arithmetic
    above: the function :class:`FactorizedCoder` builds its tables from
    (the module's own forward, which training differentiates, uses
    PyTorch's tanh and sigmoid)."""
    x = x.float()
    for f in (module.f1, module.f2, module.f3, module.f4):
        x = _fma(x, _softplus(f.h.float()), f.b.float())
        if not f.final:
            x = _fma(_tanh(x), _tanh(f.a.float()), x)
    cdf = 1.0 / (_exp(-x) + 1.0)
    # subnormal results flush to zero, as on XLA's CPU backend (deep tails)
    return torch.where(cdf < _MIN_NORMAL, torch.zeros_like(cdf), cdf)


def factorized_tables(cdf: Callable[[np.ndarray], np.ndarray], channels: int):
    """Per-channel quantized CDF tables of a CDF model (the reference's
    ``BitEstimator.update``, entropy_models.py:180-226): ``cdf`` maps an
    (n, C) f32 array of sample points to (n, C) CDF values.  Scans [-50, 50]
    for each channel's support (tails below 1e-4 and above 0.9999), takes
    the pmf on the integers of the support plus the tail mass, and
    quantizes it to 16 bits.  Returns (quantized_cdf, cdf_length, offset),
    int32."""
    C = channels
    minima = np.full(C, 50, np.int64)
    maxima = np.full(C, 50, np.int64)
    for i in range(50, 1, -1):
        probs_lo = cdf(np.full((1, C), -float(i), np.float32))[0]
        probs_hi = cdf(np.full((1, C), float(i), np.float32))[0]
        minima = np.where(probs_lo < 1e-4, i, minima)
        maxima = np.where(probs_hi > 0.9999, i, maxima)

    offset = -minima
    pmf_length = maxima + minima + 1
    max_length = int(pmf_length.max())
    samples = np.arange(max_length, dtype=np.float32)
    grid = (samples[None, :] - minima[:, None]).astype(np.float32).T   # (L, C)
    lower = cdf(grid - np.float32(0.5)).T                               # (C, L)
    upper = cdf(grid + np.float32(0.5)).T
    pmf = upper - lower
    tail_mass = lower[:, 0] + (1.0 - upper[:, -1])

    quantized = np.zeros((C, max_length + 2), np.int32)
    for c in range(C):
        row = np.concatenate([pmf[c, : pmf_length[c]], tail_mass[c:c + 1]])
        q = pmf_to_quantized_cdf(row, 16)
        quantized[c, : q.shape[0]] = q
    return quantized, (pmf_length + 2).astype(np.int32), offset.astype(np.int32)


class FactorizedCoder:
    """Host driver: per-channel CDF tables (:func:`factorized_tables` of
    :func:`table_cdf`) and coding with the native rANS (the reference's
    ``BitEstimator.update`` / ``encode`` / ``decode``,
    entropy_models.py:172-249)."""

    def __init__(self, module: BitEstimator, coder: Optional[EntropyCoder] = None):
        self.module = module
        self.channel = module.channel
        self.coder = coder or EntropyCoder()
        dev = next(module.parameters()).device

        def cdf(x: np.ndarray) -> np.ndarray:
            return table_cdf(module, torch.from_numpy(x).to(dev)).cpu().numpy()

        self.quantized_cdf, self.cdf_length, self.offset = factorized_tables(
            cdf, self.channel)
        self.cdf_group = self.coder.add_cdf(self.quantized_cdf, self.cdf_length,
                                            self.offset)

    def build_indexes(self, shape_bhwc) -> np.ndarray:
        """Channel-index plane (reference: entropy_models.py:229-234; NHWC)."""
        B, H, W, C = shape_bhwc
        return np.broadcast_to(np.arange(C, dtype=np.int16)[None, None, None, :],
                               (B, H, W, C)).copy()

    def encode(self, symbols) -> None:
        x = np.asarray(symbols)
        idx = self.build_indexes(x.shape)
        self.coder.encode_with_indexes(x.reshape(-1), idx.reshape(-1), self.cdf_group)

    def decode_stream(self, shape_bhwc) -> np.ndarray:
        idx = self.build_indexes(shape_bhwc)
        out = self.coder.decode_stream(idx.reshape(-1), self.cdf_group)
        return out.reshape(shape_bhwc)
