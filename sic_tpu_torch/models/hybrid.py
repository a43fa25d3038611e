"""Hybrid TiTok + detail-branch codec (NHWC, tile-batched).

Counterpart of the JAX package's ``models/hybrid.py`` (reference:
src/models/codec_sq_fixbpp.py:48-439): the TiTok ViT encoder and decoder,
each interleaved with the detail branch's cross-attention and refiners, and
FeatMerge, the prior fusion into VQGAN codebook logits.  Images are tiled
into 256-px tiles that form one batch axis.

Both trunks run as *cells* (``cell_partition``): a cell is ``k`` ViT
layers whose last is an insert position (or no insert at all), then that
position's cross block and refiner.  Run in order, the cells are the
sequential layer loop.  With a :class:`PPConfig` the cells are pipeline
stages (GPipe, ``parallel/pipeline.py``): stage ``p`` of ``P`` owns cells
``[p * C / P, (p + 1) * C / P)``, and :meth:`HybridCodec.prune_to_stage`
drops the modules of the other stages' cells.  The port keeps its named
layout (``transformer.<i>``, ``inter_blocks.<i>``, ``feat_blocks.<i>``)
in both modes; the JAX package's stacked ``trunk_cells``, with zeroed
interaction parameters behind a 0-gate in insert-free cells, is a layout
of ``nn.scan`` that only ``parallel.pipeline``'s converters know.

Under the width split (``parallel.collectives.tile_parallel``) a rank whose
slab holds whole 256-px tiles runs the encoder and decoder on its own
tiles (the ViT, the cross blocks and the detail branch; the Swin stacks on
the slab, the quantizer's losses averaged over the ranks), and the detail
bottleneck, whose prior and rate couple the whole latent, runs on the
gathered latent.  Where a tile straddles two ranks (the 256-px training
crop at ``--tile 2``) the hybrid branch runs on the gathered width, the
same on every rank, and hands each rank its slab of the decoded maps.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import TiTokSpec
from ..parallel.collectives import (no_tile, tile_gather, tile_group,
                                    tile_mean, tile_scatter)
from .bottleneck import CompressiveBottleneck
from .convnext import ConvNeXtBlock
from .cross import (InteractiveCrossAttn, tile_nhwc_to_tokens,
                    tokens_to_tile_nhwc)
from .layers import Conv2d, LayerNorm, Linear, ResidualAttentionBlock
from .quantizer import L2VectorQuantizer
from .swin import SwinStack


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NHWC depth-to-space with torch ``nn.PixelShuffle`` channel ordering
    (in channel = c*r*r + i*r + j)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H, W, C // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, C // (r * r))


class FeatBlock(nn.Module):
    """Per-insert-position detail refiner: 2 Swin + 2 ConvNeXt
    (reference: codec_sq_fixbpp.py:75-79)."""

    def __init__(self, feat_width: int):
        super().__init__()
        self.swin = SwinStack(feat_width, 2)
        self.convnext_0 = ConvNeXtBlock(feat_width, feat_width, 2.0, 5)
        self.convnext_1 = ConvNeXtBlock(feat_width, feat_width, 2.0, 5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convnext_1(self.convnext_0(self.swin(x)))


def _run(remat: bool, module: nn.Module, *args):
    """``module(*args)``; with ``remat`` and gradients on, its activations
    are recomputed in the backward instead of kept (the JAX package's
    ``nn.remat`` on the same blocks, the ``save_mem`` path).  The blocks
    draw no random numbers and their kernels are deterministic, so the
    recomputed forward gives the same activations and gradients."""
    if remat and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False)
    return module(*args)


def _scaled_normal(shape, scale: float) -> nn.Parameter:
    return nn.Parameter(scale * torch.randn(shape))


# -- pipeline-parallel trunk cells ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class PPConfig:
    """Pipeline-parallel execution of the hybrid trunks: ``group`` is this
    process's ``pipe`` group (:class:`~sic_tpu_torch.parallel.multihost.Group`:
    the stages' global ranks, this rank's stage), ``n_microbatch`` the
    microbatch count (default: one a stage).  The JAX package's
    ``PPConfig(mesh, axis, batch_axis, n_microbatch)``: the mesh axis is the
    group, and data parallelism is the data group beside it."""
    group: Any = None
    n_microbatch: Optional[int] = None

    @property
    def n_stages(self) -> int:
        return self.group.size if self.group is not None else 1

    @property
    def stage(self) -> int:
        return self.group.index if self.group is not None else 0


def cell_partition(num_layers: int, insert_pos: Tuple[int, ...]) -> int:
    """Largest cell size ``k`` dividing ``num_layers`` with every insert
    position at a cell end (layer ``c*k + k-1``).  The shipped geometries
    partition exactly: 24 layers / inserts (3,7,11,15,19) -> k=4 (6 cells,
    1 insert-free); 8 layers / inserts (1,3,5,7) -> k=2 (4 cells)."""
    live = [p for p in insert_pos if p < num_layers]  # positions beyond the
    # trunk never fire in the sequential loop; ignore them here too
    for k in range(num_layers, 0, -1):
        if num_layers % k == 0 and all(p % k == k - 1 for p in live):
            return k
    raise ValueError(f"no cell partition for L={num_layers}, {insert_pos}")


def cell_gates(num_layers: int, insert_pos: Tuple[int, ...]):
    """Per-cell 0/1 interaction gates: 1.0 where the cell ends on an
    insert position."""
    k = cell_partition(num_layers, insert_pos)
    live = {p for p in insert_pos if p < num_layers}
    return [1.0 if (c * k + k - 1) in live else 0.0
            for c in range(num_layers // k)]


# a leaf of a trunk cell, in torch names (``hybrid_codec.encoder.transformer.3.``)
# or the JAX package's keys (``hybrid_codec/encoder/inter_blocks_3/``)
_CELL_LEAF = re.compile(r"hybrid_codec[./](encoder|decoder)[./]"
                        r"(transformer|inter_blocks|feat_blocks)[._]\d+[./]")


def is_cell_leaf(name: str) -> bool:
    """True for a parameter (or its state) of a trunk cell: what a pipeline
    stage holds alone; every other leaf is on every stage."""
    return _CELL_LEAF.search(name) is not None


def stage_cells(num_layers: int, insert_pos, pp: Optional[PPConfig]):
    """(cell size k, first cell, end cell) of this process's stage: every
    cell without ``pp``."""
    k = cell_partition(num_layers, insert_pos)
    n = num_layers // k
    P = pp.n_stages if pp is not None else 1
    if n % P:
        raise ValueError(f"{n} pipeline cells not divisible by {P} stages")
    p = pp.stage if pp is not None else 0
    return k, p * n // P, (p + 1) * n // P


class _Trunk(nn.Module):
    """The cell structure shared by the encoder's and decoder's trunks:
    ``transformer`` layers, with ``inter_blocks`` and ``feat_blocks`` at
    the insert positions."""

    def _cell(self, c: int, k: int, x, feat, stack_shape):
        for i in range(c * k, c * k + k):
            x = _run(self.remat, self.transformer[i], x)
        end = c * k + k - 1
        if end in self.insert_pos:
            feat, x = _run(self.remat, self.inter_blocks[str(end)], feat, x,
                           stack_shape)
            feat = _run(self.remat, self.feat_blocks[str(end)], feat)
        return x, feat

    def _trunk(self, x, feat, stack_shape):
        k, first, end = stage_cells(self.spec.num_layers, self.insert_pos,
                                    self.pp)

        def stage(carry):
            x, feat = carry
            for c in range(first, end):
                x, feat = self._cell(c, k, x, feat, stack_shape)
            return x, feat

        if self.pp is None:
            return stage((x, feat))
        from ..parallel.pipeline import spmd_pipeline
        return spmd_pipeline(stage, (x, feat), self.pp.group,
                             self.pp.n_microbatch)

    def prune_to_stage(self) -> None:
        """Drop the layers and blocks of the other stages' cells (their
        ``transformer`` entries become parameter-free placeholders, so the
        owned layers keep their names)."""
        if self.pp is None:
            return
        k, first, end = stage_cells(self.spec.num_layers, self.insert_pos,
                                    self.pp)
        for i in range(self.spec.num_layers):
            if not first * k <= i < end * k:
                self.transformer[i] = nn.Identity()
        for pos in list(self.inter_blocks):
            if not first * k <= int(pos) < end * k:
                del self.inter_blocks[pos]
                del self.feat_blocks[pos]


class HybridEncoder(_Trunk):
    """TiTok ViT encoder interleaved with the detail branch
    (reference: codec_sq_fixbpp.py:48-183)."""

    def __init__(self, spec: TiTokSpec, insert_pos: Tuple[int, ...],
                 feat_width: int, num_attns: int = 2, remat: bool = False,
                 pp: Optional[PPConfig] = None):
        super().__init__()
        s = spec
        self.spec = spec
        self.remat = remat
        self.pp = pp
        self.insert_pos = tuple(p for p in insert_pos if p < s.num_layers)
        scale = s.width ** -0.5
        self.patch_embed = Conv2d(3, s.width, s.patch_size, stride=s.patch_size)
        self.class_embedding = _scaled_normal((1, s.width), scale)
        self.positional_embedding = _scaled_normal((s.grid_size ** 2 + 1, s.width), scale)
        self.latent_token_positional_embedding = _scaled_normal(
            (s.num_latent_tokens, s.width), scale)
        self.ln_pre = LayerNorm(s.width)
        self.transformer = nn.ModuleList(
            ResidualAttentionBlock(s.width, s.num_heads) for _ in range(s.num_layers))
        self.ln_post = LayerNorm(s.width)
        # pre-VQ projection: float in the int8 mode (sic_tpu/models/hybrid.py:261)
        self.conv_out = Linear(s.width, s.token_size, sensitive=True)
        self.pix_emb_proj = Linear(s.width, feat_width)
        self.feat_in = SwinStack(feat_width, 4)
        self.inter_blocks = nn.ModuleDict({
            str(i): InteractiveCrossAttn(s.width, feat_width, num_attns,
                                         s.grid_size, s.grid_size,
                                         s.num_latent_tokens + 1)
            for i in self.insert_pos})
        self.feat_blocks = nn.ModuleDict({str(i): FeatBlock(feat_width)
                                          for i in self.insert_pos})
        self.feat_out_swin = SwinStack(feat_width, 2)
        self.feat_out_down = Conv2d(feat_width, feat_width, 2, stride=2)
        self.feat_out_ln = LayerNorm(feat_width)
        self.feat_out_fc = Linear(feat_width, feat_width)

    def forward(self, pixel_values, latent_tokens):
        """pixel_values: (B, H, W, 3) in [0, 1], H and W multiples of the
        tile; latent_tokens: (num_latent_tokens, width).  Returns (z (BT,
        n_latent, token_size), feat (B, H/32, W/32, feat_width),
        stack_shape)."""
        s = self.spec
        x_emb = self.patch_embed(pixel_values)            # (B, H/16, W/16, width)
        feat_emb = self.pix_emb_proj(x_emb)
        x, stack_shape = tile_nhwc_to_tokens(x_emb, s.grid_size)
        BT, dt = x.shape[0], x.dtype
        # the parameters join the tokens in the compute dtype, each cast
        # first, as the JAX module casts them
        cls = self.class_embedding.to(dt).expand(BT, 1, s.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        lat = latent_tokens.to(dt)[None].expand(BT, s.num_latent_tokens, s.width) \
            + self.latent_token_positional_embedding.to(dt)
        x = torch.cat([x, lat], dim=1)                    # (BT, 1+256+n, width)

        feat = self.feat_in(feat_emb)
        x, feat = self._trunk(self.ln_pre(x), feat, stack_shape)

        z = self.ln_post(x[:, 1 + s.grid_size ** 2:])
        # TiTok's "fake 2D" projection: the torch original reshapes
        # (BT, N, width) row-major to (BT, width, N, 1) before its 1x1
        # conv_out, a channel scramble that trained weights expect
        # (reference: titok/blocks.py:140-143)
        BT2, N, Wd = z.shape
        z = self.conv_out(z.reshape(BT2, Wd, N).transpose(1, 2))

        feat = self.feat_out_down(self.feat_out_swin(feat))  # stride 16 -> 32
        return z, self.feat_out_fc(self.feat_out_ln(feat)), stack_shape


class HybridDecoder(_Trunk):
    """TiTok ViT decoder + detail-branch upsampler
    (reference: codec_sq_fixbpp.py:186-300)."""

    def __init__(self, spec: TiTokSpec, insert_pos: Tuple[int, ...],
                 feat_width: int, num_attns: int = 2, remat: bool = False,
                 pp: Optional[PPConfig] = None):
        super().__init__()
        s = spec
        self.spec = spec
        self.remat = remat
        self.pp = pp
        # a position past the trunk never fires (flax then creates no
        # parameters for it, e.g. the tiny spec's 2 layers)
        self.insert_pos = tuple(p for p in insert_pos if p < s.num_layers)
        scale = s.width ** -0.5
        self.decoder_embed = Linear(s.token_size, s.width)
        self.class_embedding = _scaled_normal((1, s.width), scale)
        self.positional_embedding = _scaled_normal((s.grid_size ** 2 + 1, s.width), scale)
        self.mask_token = _scaled_normal((1, 1, s.width), scale)
        self.latent_token_positional_embedding = _scaled_normal(
            (s.num_latent_tokens, s.width), scale)
        self.ln_pre = LayerNorm(s.width)
        self.transformer = nn.ModuleList(
            ResidualAttentionBlock(s.width, s.num_heads) for _ in range(s.num_layers))
        self.ln_post = LayerNorm(s.width)
        self.feat_up_conv = Conv2d(feat_width, feat_width * 4)
        self.feat_up_swin = SwinStack(feat_width, 4)
        # keys are the insert positions: ``inter_blocks.<i>`` maps onto the
        # JAX package's ``inter_blocks_<i>``
        self.inter_blocks = nn.ModuleDict({
            str(i): InteractiveCrossAttn(s.width, feat_width, num_attns,
                                         s.grid_size, s.grid_size,
                                         s.num_latent_tokens + 1)
            for i in self.insert_pos})
        self.feat_blocks = nn.ModuleDict({str(i): FeatBlock(feat_width)
                                          for i in self.insert_pos})

    def forward(self, z_quantized, h_quantized, stack_shape: Tuple[int, int]):
        """z_quantized: (BT, n_latent, token_size); h_quantized:
        (B, H/32, W/32, feat_width).  Returns (titok_hat (B, H/16, W/16,
        width), feat (B, H/16, W/16, feat_width))."""
        s = self.spec
        x = self.decoder_embed(z_quantized)               # the compute dtype
        BT, seq_len, _ = x.shape
        dt = x.dtype
        mask = self.mask_token.to(dt).expand(BT, s.grid_size ** 2, s.width)
        cls = self.class_embedding.to(dt).expand(BT, 1, s.width)
        mask = torch.cat([cls, mask], dim=1) + self.positional_embedding.to(dt)
        x = x + self.latent_token_positional_embedding[:seq_len].to(dt)
        x = torch.cat([mask, x], dim=1)                   # (BT, 1+256+n, width)

        # the decoded (f32) h enters the compute dtype in feat_up_conv
        feat = pixel_shuffle(self.feat_up_conv(h_quantized), 2)
        feat = self.feat_up_swin(feat)
        x, feat = self._trunk(self.ln_pre(x), feat, stack_shape)

        x = self.ln_post(x[:, 1:1 + s.grid_size ** 2])
        return tokens_to_tile_nhwc(x, stack_shape, s.grid_size), feat


class FeatMerge(nn.Module):
    """Prior fusion: titok_hat + feat_hat -> logits over the VQGAN codebook
    (reference: codec_sq_fixbpp.py:395-439)."""

    def __init__(self, titok_width: int = 1024, feat_width: int = 768,
                 n_embed: int = 256, inner_width: int = 1024):
        super().__init__()
        tw = titok_width
        self.titok_in = SwinStack(tw, 2)
        self.feat_in = SwinStack(feat_width, 2)
        self.merge_fc1 = Linear(tw + feat_width, tw * 2)
        self.merge_ln = LayerNorm(tw * 2)
        self.merge_fc2 = Linear(tw * 2, inner_width)
        self.merge_swin = SwinStack(inner_width, 4)
        self.ffn_ln = LayerNorm(inner_width)
        self.ffn_fc1 = Linear(inner_width, inner_width * 2)
        # the codebook logits: float in the int8 mode (sic_tpu/models/hybrid.py:448)
        self.ffn_fc2 = Linear(inner_width * 2, n_embed, sensitive=True)

    def forward(self, titok: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        h = torch.cat([self.titok_in(titok), self.feat_in(feat)], dim=-1)
        h = self.merge_fc2(F.silu(self.merge_ln(self.merge_fc1(h))))
        h = self.merge_swin(h)
        h = torch.tanh(self.ffn_fc1(self.ffn_ln(h)))
        return self.ffn_fc2(h)


class HybridCodec(nn.Module):
    """Encoder + decoder + semantic quantizer + detail bottleneck
    (reference: codec_sq_fixbpp.py:303-392)."""

    def __init__(self, spec: TiTokSpec, insert_pos_enc: Tuple[int, ...],
                 insert_pos_dec: Tuple[int, ...], feat_width: int,
                 quant_dim: int, num_attns: int = 2, remat: bool = False,
                 pp: Optional[PPConfig] = None):
        super().__init__()
        self.encoder = HybridEncoder(spec, insert_pos_enc, feat_width,
                                     num_attns, remat, pp)
        self.decoder = HybridDecoder(spec, insert_pos_dec, feat_width,
                                     num_attns, remat, pp)
        self.latent_tokens = _scaled_normal((spec.num_latent_tokens, spec.width),
                                            spec.width ** -0.5)
        self.quantize = L2VectorQuantizer(spec.codebook_size, spec.token_size,
                                          spec.commitment_cost, spec.use_l2_norm)
        self.quantize_feat = CompressiveBottleneck(feat_width, quant_dim)

    def encode(self, x, training: bool = False,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """x: (B, H, W, 3) in [0, 1] -> both quantized latents and their
        result dicts (``noise``/``generator``: the bottleneck's rate noise).
        On width slabs of whole tiles: this rank's tiles' tokens and the
        slab of the detail latent; the rate and the quantizer's losses are
        the whole image's."""
        z, h, stack_shape = self.encoder(x, self.latent_tokens)
        z_quantized, z_result = self.quantize(z)
        group = tile_group()
        img_hw = (x.shape[1], x.shape[2])
        if group is not None:
            for k in ("quantizer_loss", "commitment_loss", "codebook_loss"):
                z_result[k] = tile_mean(z_result[k], group)
            img_hw = (x.shape[1], x.shape[2] * group.size)
            h = tile_gather(h, group)
        with no_tile():
            h_quantized, h_result = self.quantize_feat(
                h, img_hw, q_idx=0, training=training, noise=noise,
                generator=generator)
        if group is not None:
            h_quantized = tile_scatter(h_quantized, group)
        return {"z_quantized": z_quantized, "z_result_dict": z_result,
                "h_quantized": h_quantized, "h_result_dict": h_result,
                "stack_shape": stack_shape}

    def forward(self, x, training: bool = False,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        group = tile_group()
        if group is not None and x.shape[2] % self.encoder.spec.tile_px:
            # a tile straddles ranks: the whole width, the same on each
            with no_tile():
                out = self.forward(tile_gather(x, group), training, noise,
                                   generator)
            for k in ("titok_hat", "feat_hat"):
                out[k] = tile_scatter(out[k], group)
            return out
        out = self.encode(x, training, noise, generator)
        out["titok_hat"], out["feat_hat"] = self.decoder(
            out["z_quantized"], out["h_quantized"], out["stack_shape"])
        return out

    def decode_z_indices(self, indices: torch.Tensor) -> torch.Tensor:
        return self.quantize.decode_indices(indices)

    def prune_to_stage(self) -> None:
        """Keep only this pipeline stage's trunk cells, in both trunks."""
        self.encoder.prune_to_stage()
        self.decoder.prune_to_stage()
