"""MaskGIT-UViT: the masked-token generator of TiTok's best-FID generation
setting (TiTok-S-128; arXiv:2406.07550, github.com/bytedance/1d-tokenizer
``modeling/maskgit.py`` ``UViTBert``, ``modeling/modules/blocks.py``
``UViTBlock``), whose blocks are U-ViT's (arXiv:2209.12152, libs/uvit.py
``Block``).

It has :class:`~sic_tpu_torch.models.maskgit.MaskGITGenerator`'s call
signature and token space (the class token prepended, the drop label
``codebook_size + classes + 1``, position 0 dropped from the output), so
:func:`~sic_tpu_torch.models.maskgit.generate` samples from either.  What
differs:

- the input is BERT's embedding: ``LayerNorm(word[ids] + token_type[0] +
  position[arange(L + 1)])``, eps 1e-12 (``BertConfig``'s default);
- ``num_layers // 2`` "in" blocks, one "mid" block and ``num_layers // 2``
  "out" blocks, pre-LN, the qkv projection without a bias; an out block
  first sets ``x = skip_linear(cat([x, skip], -1))``, ``skip`` the output
  of the matching in block, taken last-in first-out (the long skips);
- a final LayerNorm before ``lm_head``.

Dropout is off (inference).  Trace-only spans: ``maskgit.uvit.down``
(the in blocks), ``maskgit.uvit.mid``, ``maskgit.uvit.up`` (the out
blocks) and, inside the latter, ``maskgit.uvit.skip`` (each concatenation
and skip projection).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..utils.profiling import timed_stage
from .layers import Embed, LayerNorm, Linear, ResidualAttentionBlock
from .maskgit import MaskGITSpec


@dataclasses.dataclass(frozen=True)
class UViTSpec(MaskGITSpec):
    """TiTok-S-128's generator (configs/infer/titok_s128.yaml): 20 layers
    are 10 in, 1 mid and 10 out blocks."""
    image_seq_len: int = 128
    hidden: int = 1024
    num_layers: int = 20
    num_heads: int = 16
    intermediate_size: int = 4096


class UViTBlock(ResidualAttentionBlock):
    """U-ViT's block: pre-LN attention (no qkv bias) and exact-GELU MLP;
    with ``skip``, a ``Linear(2d -> d)`` over ``[x, skip]`` first."""

    def __init__(self, d_model: int, num_heads: int, mlp_ratio: float,
                 skip: bool = False):
        super().__init__(d_model, num_heads, mlp_ratio, qkv_bias=False)
        self.skip_linear = Linear(2 * d_model, d_model) if skip else None

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.skip_linear is not None:
            with timed_stage(None, "maskgit.uvit.skip"):
                x = self.skip_linear(torch.cat([x, skip], dim=-1))
        return super().forward(x)


class UViTGenerator(nn.Module):
    """The U-ViT generator.  Parameters in registration order: the three
    embedding tables, ``ln_embed``, ``in_blocks``, ``mid_block``,
    ``out_blocks``, ``ln_post``, ``lm_head``."""

    # leaves weights.init_seeded draws N(0, 0.02), BERT's initializer_range
    normal_002 = ("position_embedding", "token_type_embedding")

    def __init__(self, spec: UViTSpec = UViTSpec()):
        super().__init__()
        s = self.spec = spec
        d, ratio, n = s.hidden, s.intermediate_size / s.hidden, s.num_layers // 2
        self.token_embedding = Embed(s.vocab_size, d)
        self.position_embedding = nn.Parameter(0.02 * torch.randn(s.image_seq_len + 1, d))
        # BERT's two token types; every position takes type 0
        self.token_type_embedding = nn.Parameter(0.02 * torch.randn(2, d))
        self.ln_embed = LayerNorm(d, eps=1e-12)
        self.in_blocks = nn.ModuleList(UViTBlock(d, s.num_heads, ratio) for _ in range(n))
        self.mid_block = UViTBlock(d, s.num_heads, ratio)
        self.out_blocks = nn.ModuleList(UViTBlock(d, s.num_heads, ratio, skip=True)
                                        for _ in range(n))
        self.ln_post = LayerNorm(d)
        self.lm_head = Linear(d, s.codebook_size)

    def forward(self, input_ids: torch.Tensor, condition: torch.Tensor,
                drop_cond: torch.Tensor) -> torch.Tensor:
        """As :meth:`MaskGITGenerator.forward`: (B, L) ids, (B,) class ids,
        (B,) bool drop -> logits (B, L, codebook_size)."""
        s = self.spec
        cond_tok = torch.where(drop_cond,
                               s.condition_num_classes + s.codebook_size + 1,
                               condition + s.codebook_size + 1)
        ids = torch.cat([cond_tok[:, None], input_ids], dim=1).long()
        x = self.token_embedding(ids) + self.token_type_embedding[0]
        x = self.ln_embed(x + self.position_embedding)
        skips = []
        with timed_stage(None, "maskgit.uvit.down"):
            for blk in self.in_blocks:
                x = blk(x)
                skips.append(x)
        with timed_stage(None, "maskgit.uvit.mid"):
            x = self.mid_block(x)
        with timed_stage(None, "maskgit.uvit.up"):
            for blk in self.out_blocks:
                x = blk(x, skips.pop())
        # the condition position dropped before the head, which is per position
        return self.lm_head(self.ln_post(x[:, 1:]))
