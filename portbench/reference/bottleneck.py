"""The detail branch's bottleneck and its coding chain, in plain PyTorch
on one device: the transforms and the four-part prior (a copy of the
port's ``CompressiveBottleneck``), and the chain that a stream's decode
and an encode's simulation walk: the prior at the coding batch, each
step's CDF-index plane, the symbols (read from a stream by ``rans.py`` or
quantized from a latent) and the reconstruction.  The decode recomputes
the encoder's CDF indexes from the same float operations at the same
coding batch, so run it in fp32 with TF32 off."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .dcvc import DepthConvBlock4
from .fourpart import (combine_for_writing, four_part_masks,
                       process_with_mask, separate_prior)
from .gaussian import build_indexes, lower_bound
from .layers import Conv2d
from .rans import StreamDecoder
from .tables import build_gaussian_tables

CODING_BATCH = 8


class CompressiveBottleneck(nn.Module):
    """Analysis/synthesis transforms + learned prior over the detail
    latent (the port's module without its training pass)."""

    def __init__(self, feat_dim: int, quant_dim: int, bpp_num: int = 1):
        super().__init__()
        f, q, b = feat_dim, quant_dim, bpp_num
        self.quant_dim = q
        self.enc_q = nn.Parameter(torch.ones(b, f))
        self.dec_q = nn.Parameter(torch.ones(b, f))
        self.factorized_prior_vec = nn.Parameter(torch.ones(b, q))
        self.enc_trans_0 = nn.ModuleList([DepthConvBlock4(f, f),
                                          DepthConvBlock4(f, f)])
        self.enc_trans_1 = nn.ModuleList([DepthConvBlock4(f, f),
                                          DepthConvBlock4(f, q)])
        self.dec_trans_0 = nn.ModuleList([DepthConvBlock4(q, f),
                                          DepthConvBlock4(f, f)])
        self.dec_trans_1 = nn.ModuleList([DepthConvBlock4(f, f),
                                          DepthConvBlock4(f, f)])
        self.y_prior_fusion = nn.ModuleList([DepthConvBlock4(q, q * 2),
                                             DepthConvBlock4(q * 2, q * 3)])
        self.y_spatial_prior_reduction = Conv2d(q * 3, q)
        self.y_spatial_prior_adaptors = nn.ModuleList(
            DepthConvBlock4(q * 2, q * 2) for _ in range(3))
        self.y_spatial_prior = nn.ModuleList(
            DepthConvBlock4(q * 2, q * 2) for _ in range(3))

    def encode_transform(self, y, q_idx: int = 0):
        for blk in self.enc_trans_0:
            y = blk(y)
        y = y * self.enc_q[q_idx]
        for blk in self.enc_trans_1:
            y = blk(y)
        return y

    def decode_transform(self, y_hat, q_idx: int = 0):
        for blk in self.dec_trans_0:
            y_hat = blk(y_hat)
        y_hat = y_hat * self.dec_q[q_idx]
        for blk in self.dec_trans_1:
            y_hat = blk(y_hat)
        return y_hat

    def prior_params(self, shape_bhw: Tuple[int, int, int], q_idx: int = 0):
        B, H, W = shape_bhw
        p = self.factorized_prior_vec[q_idx].expand(B, H, W, self.quant_dim)
        for blk in self.y_prior_fusion:
            p = blk(p)
        return p  # (B, H, W, 3*quant_dim)

    def reduce_common(self, common_params):
        return self.y_spatial_prior_reduction(common_params)

    def spatial_step(self, step: int, y_hat_so_far, common_reduced):
        p = torch.cat([y_hat_so_far, common_reduced], dim=-1)
        p = self.y_spatial_prior_adaptors[step - 1](p)
        for blk in self.y_spatial_prior:
            p = blk(p)
        scales, means = torch.chunk(p, 2, dim=-1)
        return scales, means


class Chain:
    """The coding chain of one bottleneck (its prior, the tables, the
    zero-scale threshold)."""

    def __init__(self, module: CompressiveBottleneck,
                 force_zero_thres: Optional[float] = 0.12):
        self.m = module
        self.thres = force_zero_thres
        self.tables = build_gaussian_tables("gaussian")

    def _idx_of(self, scales, step: int):
        H, W, C = scales.shape[1:]
        mask = four_part_masks(H, W, C, scales.dtype, scales.device)[step]
        plane = combine_for_writing(scales * mask)
        return build_indexes(plane, skip_thres=self.thres).to(torch.int16)

    def _prior(self, shape_bhw, q_idx: int):
        common = self.m.prior_params(shape_bhw, q_idx)
        quant_step, scales, means = separate_prior(common)
        common_reduced = self.m.reduce_common(common)
        return (lower_bound(quant_step, 0.5), scales, means,
                common_reduced, self._idx_of(scales, 0))

    def _spatial(self, step: int, y_hat_so_far, common_reduced):
        scales, means = self.m.spatial_step(step, y_hat_so_far, common_reduced)
        return scales, means, self._idx_of(scales, step)

    @staticmethod
    def _recon(sym_plane, means, step: int):
        B, H, W, Cq = sym_plane.shape
        mask = four_part_masks(H, W, Cq * 4, means.dtype, means.device)[step]
        full = torch.cat([sym_plane.to(means.dtype)] * 4, dim=-1)
        return (full + means) * mask

    @torch.no_grad()
    def decode(self, streams, hw: Tuple[int, int], coding_batch: int = CODING_BATCH,
               q_idx: int = 0):
        """Per-image framed streams -> (h_hat (B, H, W, feat), symbol planes
        [(B, H, W, C/4) int64] * 4, substreams left unfinished), the chain at ``coding_batch`` (pad
        images are zeros and read no bytes)."""
        t = self.tables
        decs = [StreamDecoder(s, t.quantized_cdf, t.cdf_length, t.offset)
                for s in streams]
        B, (H, W), C = len(streams), hw, self.m.quant_dim
        Bc = coding_batch
        dev = self.m.factorized_prior_vec.device
        quant_step, _s, means0, common, idx0 = self._prior((Bc, H, W), q_idx)
        outs, planes = [], [[] for _ in range(4)]
        for start in range(0, B, Bc):
            real = min(Bc, B - start)
            y_hat = torch.zeros((Bc, H, W, C), dtype=quant_step.dtype, device=dev)
            means, idx = means0, idx0
            for step in range(4):
                if step > 0:
                    _s, means, idx = self._spatial(step, y_hat, common)
                idx_np = idx.cpu().numpy()
                sym = np.zeros(idx_np.shape, np.int64)
                for b in range(real):
                    sym[b] = decs[start + b].decode(idx_np[b]).reshape(idx_np.shape[1:])
                planes[step].append(sym[:real])
                y_hat = y_hat + self._recon(torch.from_numpy(sym).to(dev),
                                            means, step)
            outs.append(self.m.decode_transform(y_hat * quant_step, q_idx)[:real])
        return (torch.cat(outs), [np.concatenate(p) for p in planes],
                sum(d.unfinished() for d in decs))

    @torch.no_grad()
    def encode_plan(self, y, coding_batch: int = CODING_BATCH, q_idx: int = 0):
        """The encoder's side: a latent (B, H, W, feat) -> (h_hat, symbol
        planes), the chain at ``coding_batch``."""
        B = y.shape[0]
        Bc = coding_batch
        outs, planes = [], [[] for _ in range(4)]
        for start in range(0, B, Bc):
            real = min(Bc, B - start)
            yc = y[start:start + real]
            if real < Bc:
                yc = torch.cat([yc, yc.new_zeros((Bc - real,) + tuple(y.shape[1:]))])
            y_t = self.m.encode_transform(yc, q_idx)
            quant_step, scales, means, common, _idx = self._prior(
                tuple(y_t.shape[:3]), q_idx)
            y_div = y_t / quant_step
            y_hat = torch.zeros_like(y_div)
            H, W, C = y_div.shape[1:]
            for step in range(4):
                if step > 0:
                    scales, means, _idx = self._spatial(step, y_hat, common)
                mask = four_part_masks(H, W, C, y_div.dtype, y_div.device)[step]
                _, y_q, _, _ = process_with_mask(y_div, scales, means, mask,
                                                 self.thres)
                sym = torch.clamp(combine_for_writing(y_q), -30000, 30000)
                planes[step].append(sym[:real].long().cpu().numpy())
                y_hat = y_hat + self._recon(combine_for_writing(y_q), means, step)
            outs.append(self.m.decode_transform(y_hat * quant_step, q_idx)[:real])
        return torch.cat(outs), [np.concatenate(p) for p in planes]
