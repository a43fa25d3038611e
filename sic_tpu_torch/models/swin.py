"""Swin window attention blocks (NHWC).

Counterpart of the JAX package's ``models/swin.py`` (reference:
src/blocks/swin_transformer.py:64-156): cyclic shift by ``torch.roll``, a
relative position bias in block 0 only, shift masks folded into a
per-window additive bias, and the NHWC window-attention kernel.

Under the width split (``parallel.collectives.tile_parallel``) a stack
whose slab holds whole windows runs on the slab: the cyclic shift crosses
the ranks (``tile_roll``) and each rank's shift mask covers its windows'
place in the whole window grid, since the kernel indexes the bias by the
local window index.  A slab narrower than a window, or not a multiple of
one, runs the stack on the gathered width.  Under tensor parallelism the
block's ``to_qkv`` / ``mlp_fc1`` hold this rank's heads / hidden units and
``to_out`` / ``mlp_fc2`` the matching input columns (``layers.Linear.tp``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import window_attention_nhwc
from ..parallel.collectives import (copy_to_model, run_gathered, tile_group,
                                    tile_roll)
from .layers import LayerNorm, Linear


def _relative_index(window_size: int) -> np.ndarray:
    """(S, S, 2) table of pairwise offsets shifted to [0, 2*ws-2]."""
    coords = np.stack(np.meshgrid(np.arange(window_size),
                                  np.arange(window_size), indexing="ij"),
                      axis=-1).reshape(-1, 2)
    rel = coords[None, :, :] - coords[:, None, :]
    return rel + window_size - 1


def _relative_bins(window_size: int):
    """The relative position table's gather and its inverse: ``flat``
    (S*S,) holds, for each (query, key) pair, its bin of the flattened
    (2ws-1, 2ws-1) table; ``members`` (bins, ws*ws) lists each bin's pairs
    in ascending order, padded with S*S (a zero slot)."""
    idx = _relative_index(window_size)
    nb = 2 * window_size - 1
    flat = (idx[..., 0] * nb + idx[..., 1]).reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=nb * nb)
    members = np.full((nb * nb, window_size * window_size), flat.size, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for b in range(nb * nb):
        members[b, :counts[b]] = order[starts[b]:starts[b] + counts[b]]
    return flat, members


class _RelativeBias(torch.autograd.Function):
    """``table.flatten()[flat]`` with a deterministic backward: each bin's
    gradient is the sum of its pairs' in a fixed order (a gather and a sum
    over a fixed axis), where indexing's own backward accumulates with
    atomics on CUDA and across threads on the CPU, and so changes from run
    to run."""

    @staticmethod
    def forward(ctx, table, flat, members):
        ctx.save_for_backward(members)
        ctx.shape = table.shape
        return table.reshape(-1)[flat]

    @staticmethod
    def backward(ctx, g):
        (members,) = ctx.saved_tensors
        padded = torch.cat([g.reshape(-1), g.new_zeros(1)])
        return padded[members].sum(1).reshape(ctx.shape), None, None


def _shift_masks(window_size: int) -> tuple:
    """Additive -inf masks for the shifted layout
    (reference: swin_transformer.py:42-55)."""
    d = window_size // 2
    s = window_size * window_size
    ul = np.zeros((s, s), np.float32)
    ul[-d * window_size:, :-d * window_size] = -np.inf
    ul[:-d * window_size, -d * window_size:] = -np.inf
    lr = np.zeros((window_size,) * 4, np.float32)
    lr[:, -d:, :, :-d] = -np.inf
    lr[:, :-d, :, -d:] = -np.inf
    return ul, lr.reshape(s, s)


def _mask_columns(nww: int):
    """(first, total): this rank's window columns in the whole grid."""
    group = tile_group()
    if group is None:
        return 0, nww
    return group.index * nww, group.size * nww


def _full_shift_mask(nwh: int, nww: int, window_size: int) -> np.ndarray:
    """Per-window additive mask (nwh*nww, S, S)."""
    ul, lr = _shift_masks(window_size)
    s = window_size * window_size
    mask = np.zeros((nwh, nww, s, s), np.float32)
    mask[-1, :, :, :] += ul          # last window row
    mask[:, -1, :, :] += lr          # last window column
    return mask.reshape(nwh * nww, s, s)


class WindowAttention(nn.Module):
    """Windowed MHSA with optional cyclic shift + relative position bias."""

    def __init__(self, dim: int, heads: int, head_dim: int, window_size: int,
                 shifted: bool, relative_pos_embedding: bool):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        self.window_size, self.shifted = window_size, shifted
        self.relative = relative_pos_embedding
        inner = heads * head_dim
        ws = window_size
        self.to_qkv = Linear(dim, inner * 3, bias=False)
        if relative_pos_embedding:
            self.pos_embedding = nn.Parameter(torch.randn(2 * ws - 1, 2 * ws - 1))
            flat, members = _relative_bins(ws)
            self.register_buffer("rel_flat", torch.from_numpy(flat), persistent=False)
            self.register_buffer("rel_members", torch.from_numpy(members),
                                 persistent=False)
        else:
            self.pos_embedding = nn.Parameter(torch.randn(ws * ws, ws * ws))
        self.to_out = Linear(inner, dim)
        self._masks: dict = {}

    def _shift_mask(self, nwh: int, nww: int, device) -> torch.Tensor:
        """The shift mask of this rank's ``nww`` window columns: their
        place in the whole window grid (the width split's slabs)."""
        first, total = _mask_columns(nww)
        key = (nwh, nww, first, total, str(device))
        if key not in self._masks:
            full = _full_shift_mask(nwh, total, self.window_size)
            s = self.window_size ** 2
            cols = full.reshape(nwh, total, s, s)[:, first:first + nww]
            self._masks[key] = torch.from_numpy(
                np.ascontiguousarray(cols).reshape(nwh * nww, s, s)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        ws = self.window_size
        if H % ws or W % ws:
            raise ValueError(f"feature map {H}x{W} is not a multiple of {ws}")
        d = ws // 2
        if self.shifted:
            x = tile_roll(torch.roll(x, shifts=-d, dims=1), -d)
        qkv = self.to_qkv(x)
        if self.relative:
            ws2 = self.window_size ** 2
            bias = _RelativeBias.apply(self.pos_embedding, self.rel_flat,
                                       self.rel_members).reshape(ws2, ws2)
        else:
            bias = self.pos_embedding
        bias = bias.float()[None]      # f32 in every compute dtype
        tp = getattr(self.to_qkv, "tp", None)    # an int8 QuantLinear has none
        if tp is not None:
            # the bias is every head's: its gradient sums the ranks' heads
            bias = copy_to_model(bias, tp[0])
        if self.shifted:
            bias = bias + self._shift_mask(H // ws, W // ws, x.device)
        out = window_attention_nhwc(qkv, bias.contiguous(),
                                    self.head_dim ** -0.5, self.heads)
        out = self.to_out(out)
        if self.shifted:
            out = tile_roll(torch.roll(out, shifts=d, dims=1), d)
        return out


class SwinBlock(nn.Module):
    """Pre-LN window-attention block (reference: swin_transformer.py:131-156)."""

    def __init__(self, dim: int, heads: int, head_dim: int, mlp_dim: int,
                 window_size: int, shifted: bool, relative_pos_embedding: bool):
        super().__init__()
        self.norm_attn = LayerNorm(dim)
        self.attention_block = WindowAttention(
            dim, heads, head_dim, window_size, shifted, relative_pos_embedding)
        self.norm_mlp = LayerNorm(dim)
        self.mlp_fc1 = Linear(dim, mlp_dim)
        self.mlp_fc2 = Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention_block(self.norm_attn(x))
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm_mlp(x))))


class SwinStack(nn.Module):
    """Alternating-shift Swin layers at head dim 64
    (reference: codec_sq_fixbpp.py:33-45).  ``block.<i>`` maps onto the
    JAX package's ``block_<i>``."""

    def __init__(self, width: int, num_layers: int, mlp_ratio: float = 4.0,
                 window_size: int = 16, inverse_shifted: bool = False):
        super().__init__()
        if width % 64:
            raise ValueError(f"Swin width {width} is not a multiple of 64")
        blocks = []
        for i in range(num_layers):
            shifted = (not bool(i % 2)) if inverse_shifted else bool(i % 2)
            rel = False if inverse_shifted else (i == 0)
            blocks.append(SwinBlock(width, width // 64, 64,
                                    int(width * mlp_ratio), window_size,
                                    shifted, rel))
        self.block = nn.ModuleList(blocks)
        self.window_size = window_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tile_group() is not None and x.shape[2] % self.window_size:
            return run_gathered(self._blocks, x)
        return self._blocks(x)

    def _blocks(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.block:
            x = blk(x)
        return x
