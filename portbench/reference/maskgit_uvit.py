"""Plain reference of the MaskGIT-UViT generator and its sampler, fp32.

The generator of TiTok-S-128 (arXiv:2406.07550; github.com/bytedance/
1d-tokenizer ``configs/infer/titok_s128.yaml``, ``modeling/maskgit.py``
``UViTBert``, ``modeling/modules/blocks.py`` ``UViTBlock``), whose blocks
are U-ViT's (arXiv:2209.12152, libs/uvit.py ``Block``), in plain
``torch``: no kernel, no cache, no batching of the two guidance passes.
TF32 is off for matrix products and convolutions while :func:`fp32` is
entered (the caller holds the reference to fp32 that way).

Equations, as published:
- token space: ids in [0, K) are image tokens, K the mask, K + 1 + c the
  class token of class c, K + 1 + C the drop label; the class token is
  prepended and position 0 is dropped from the logits;
- embedding (``BertEmbeddings``): ``LayerNorm(word[ids] + token_type[0]
  + position[arange(L + 1)])``, dropout off;
- ``num_layers // 2`` in blocks, a mid block, ``num_layers // 2`` out
  blocks; each ``x = x + proj(attn(LN1(x)))``, ``x = x + fc2(GELU(fc1(
  LN2(x))))``, the qkv projection without a bias, exact GELU, eps 1e-5;
  an out block first ``x = skip_linear(cat([x, skips.pop()], -1))``;
- a final LayerNorm, then ``lm_head`` (with a bias);
- the sampler: ``num_sample_steps`` steps of a Gumbel-noised argmax over
  the guided logits, the arccos mask schedule and an annealed
  temperature; guidance ``"constant"``: ``cond + (cond - uncond) * g``;
  ``"power-cosine"``: ``uncond + (cond - uncond) * cfg``, ``cfg = (g - 1)
  * (1 - cos(pi * (step / n) ** 3)) / 2 + 1`` (the power the published
  sampler's default, :data:`GUIDANCE_SCALE_POW`); softmax-temperature
  annealing divides the guided logits by ``0.5 + 0.8 * (1 - ratio)``.

Departures, none of them in the mathematics of a forward pass:
- parameter names and order are the port's (``token_embedding``,
  ``position_embedding``, ``token_type_embedding``, ``ln_embed``, blocks of
  ``ln_1``, ``attn.in_proj`` / ``attn.out_proj``, ``ln_2``, ``mlp.c_fc`` /
  ``mlp.c_proj``, ``skip_linear``; ``ln_post``, ``lm_head``), so one
  seeded draw fills both; BERT names them otherwise;
- the embedding's LayerNorm eps is 1e-12, ``BertConfig``'s default (the
  published config does not set it);
- the condition position is dropped before the final LayerNorm and the
  head, which act on each position alone;
- the sampler's temperature and mask length are float32 as the port's
  JAX lineage computes them (:func:`step_schedule`), the guidance factor
  and the softmax temperature float32 on the CPU; the Gumbel noise comes
  from a ``torch.Generator`` (:func:`_gumbel`), uniform clamped to
  [1e-20, 1) as published.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from .layers import MLP, Embed, Linear, seq_attention


@contextlib.contextmanager
def fp32():
    """TF32 off for matrix products and convolutions inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@dataclasses.dataclass(frozen=True)
class UViTSpec:
    codebook_size: int = 4096
    condition_num_classes: int = 1000
    image_seq_len: int = 128
    hidden: int = 1024
    num_layers: int = 20
    num_heads: int = 16
    intermediate_size: int = 4096

    @property
    def mask_token_id(self) -> int:
        return self.codebook_size

    @property
    def vocab_size(self) -> int:
        return self.codebook_size + self.condition_num_classes + 2


class Attention(nn.Module):
    """Self attention over a bias-free packed qkv projection."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj = Linear(d, 3 * d, bias=False)
        self.out_proj = Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d_head = x.shape[-1] // self.heads
        return self.out_proj(seq_attention(self.in_proj(x), d_head ** -0.5, self.heads))


class UViTBlock(nn.Module):
    def __init__(self, d: int, heads: int, mlp_dim: int, skip: bool = False):
        super().__init__()
        self.ln_1 = nn.LayerNorm(d, eps=1e-5)
        self.attn = Attention(d, heads)
        self.ln_2 = nn.LayerNorm(d, eps=1e-5)
        self.mlp = MLP(d, mlp_dim)
        self.skip_linear = Linear(2 * d, d) if skip else None

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.skip_linear is not None:
            x = self.skip_linear(torch.cat([x, skip], dim=-1))
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class UViTGenerator(nn.Module):
    normal_002 = ("position_embedding", "token_type_embedding")

    def __init__(self, spec: UViTSpec = UViTSpec()):
        super().__init__()
        s = self.spec = spec
        d, n = s.hidden, s.num_layers // 2
        self.token_embedding = Embed(s.vocab_size, d)
        self.position_embedding = nn.Parameter(0.02 * torch.randn(s.image_seq_len + 1, d))
        self.token_type_embedding = nn.Parameter(0.02 * torch.randn(2, d))
        self.ln_embed = nn.LayerNorm(d, eps=1e-12)
        self.in_blocks = nn.ModuleList(
            UViTBlock(d, s.num_heads, s.intermediate_size) for _ in range(n))
        self.mid_block = UViTBlock(d, s.num_heads, s.intermediate_size)
        self.out_blocks = nn.ModuleList(
            UViTBlock(d, s.num_heads, s.intermediate_size, skip=True) for _ in range(n))
        self.ln_post = nn.LayerNorm(d, eps=1e-5)
        self.lm_head = Linear(d, s.codebook_size)

    def forward(self, input_ids: torch.Tensor, condition: torch.Tensor,
                drop_cond: torch.Tensor) -> torch.Tensor:
        s = self.spec
        cls = torch.where(drop_cond, s.codebook_size + 1 + s.condition_num_classes,
                          condition + s.codebook_size + 1)
        ids = torch.cat([cls[:, None], input_ids], dim=1).long()
        x = self.token_embedding(ids) + self.token_type_embedding[0]
        x = self.ln_embed(x + self.position_embedding)
        skips = []
        for blk in self.in_blocks:
            x = blk(x)
            skips.append(x)
        x = self.mid_block(x)
        for blk in self.out_blocks:
            x = blk(x, skips.pop())
        return self.lm_head(self.ln_post(x[:, 1:]))


# -- the sampler -------------------------------------------------------------------

GUIDANCE_DECAYS = ("constant", "power-cosine")
GUIDANCE_SCALE_POW = 3.0


def _gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = (u * (1.0 - 1e-20) + 1e-20).clamp_min(1e-20)
    return -torch.log(-torch.log(u))


def step_schedule(step: int, n: int, seq_len: int,
                  randomize_temperature: float) -> Tuple[torch.Tensor, float]:
    """Temperature (float32) and mask length of step ``step``: ``ratio = (step
    + 1) / n`` as ``(step + 1) * (1 / n)``, the temperature's ``1 - ratio``
    rounded once, ``floor(L * arccos(ratio) * (1 / (pi / 2)))``."""
    f32 = torch.float32
    inv_n = 1.0 / torch.tensor(n, dtype=f32)
    ratio = torch.tensor(step + 1, dtype=f32) * inv_n
    complement = (1.0 - (step + 1) * inv_n.double()).float()
    temp = torch.tensor(randomize_temperature, dtype=f32) * complement
    mask_ratio = torch.arccos(ratio) * (1.0 / torch.tensor(math.pi * 0.5, dtype=f32))
    return temp, float(torch.floor(torch.tensor(seq_len, dtype=f32) * mask_ratio))


def guidance_cfg(step: int, n: int, guidance_scale: float) -> float:
    f32 = torch.float32
    t = torch.tensor(step / n, dtype=f32) ** torch.tensor(GUIDANCE_SCALE_POW, dtype=f32)
    s = (1.0 - torch.cos(t * math.pi)) * 0.5
    return float((guidance_scale - 1.0) * s + 1.0)


def softmax_temperature(step: int, n: int) -> float:
    return float(torch.tensor(0.5 + 0.8 * (1.0 - (step + 1) / n), dtype=torch.float32))


@torch.no_grad()
def guided_logits(model, ids, condition, step: int, num_sample_steps: int,
                  guidance_scale: float, guidance_decay: str = "constant",
                  softmax_temperature_annealing: bool = False) -> torch.Tensor:
    """The logits step ``step`` samples from: both passes, guided, annealed."""
    no = torch.zeros(ids.shape[:1], dtype=torch.bool, device=ids.device)
    cond = model(ids, condition, no).float()
    if guidance_decay == "power-cosine":
        uncond = model(ids, condition, ~no).float()
        cfg = guidance_cfg(step, num_sample_steps, guidance_scale)
        logits = uncond + (cond - uncond) * cfg
    elif guidance_scale != 0:
        uncond = model(ids, condition, ~no).float()
        logits = cond + (cond - uncond) * guidance_scale
    else:
        logits = cond
    if softmax_temperature_annealing:
        logits = logits / softmax_temperature(step, num_sample_steps)
    return logits


@torch.no_grad()
def generate(model, generator: torch.Generator, condition: torch.Tensor,
             guidance_scale: float = 3.0, randomize_temperature: float = 4.5,
             num_sample_steps: int = 8, guidance_decay: str = "constant",
             softmax_temperature_annealing: bool = False) -> torch.Tensor:
    if guidance_decay not in GUIDANCE_DECAYS:
        raise ValueError(f"guidance_decay {guidance_decay!r}")
    s = model.spec
    dev = condition.device
    B, L, mask_id = condition.shape[0], s.image_seq_len, s.mask_token_id
    ids = torch.full((B, L), mask_id, dtype=torch.long, device=dev)
    for step in range(num_sample_steps):
        temp, mask_len = step_schedule(step, num_sample_steps, L, randomize_temperature)
        temp = temp.to(dev)
        is_mask = ids == mask_id
        logits = guided_logits(model, ids, condition, step, num_sample_steps,
                               guidance_scale, guidance_decay,
                               softmax_temperature_annealing)
        sampled = torch.argmax(logits + temp * _gumbel(generator, logits.shape).to(dev), -1)
        samp_logit = torch.gather(logits, -1, sampled[..., None])[..., 0]
        sampled = torch.where(is_mask, sampled, ids)
        samp_logit = torch.where(is_mask, samp_logit, torch.full_like(samp_logit, math.inf))
        mask_len = max(1.0, min(float(is_mask.sum(-1).min()) - 1.0, mask_len))
        confidence = samp_logit + temp * _gumbel(generator, samp_logit.shape).to(dev)
        cut_off = torch.sort(confidence, dim=-1).values[:, int(mask_len) - 1][:, None]
        if step == num_sample_steps - 1:
            ids = sampled
        else:
            ids = torch.where(confidence <= cut_off, torch.full_like(sampled, mask_id),
                              sampled)
    return ids

