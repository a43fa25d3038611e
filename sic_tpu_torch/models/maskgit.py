"""MaskGIT masked-token generator over TiTok's 1-D tokens, and its
iterative confidence-based sampler.

Counterpart of the JAX package's ``models/maskgit.py`` (reference:
src/titok/maskgit.py:30-138, ``ImageBert``): a pre-LN transformer over
``[class token, image tokens]`` whose sampler runs classifier-free
guidance, a gumbel-noised argmax, the arccos mask schedule and an annealed
temperature.  The JAX sampler is one ``lax.fori_loop`` under ``jit``; here
it is a Python loop of ``num_sample_steps`` steps with two generator
passes each (conditioned, then every class dropped), not batched together,
as the JAX package runs two ``apply``\\ s.

Random numbers come from the caller's ``torch.Generator`` through
:func:`_gumbel`; they are not ``jax.random``'s bits.  The schedule (ratio,
temperature, ``arccos(ratio) / (pi / 2)`` and ``floor(L * mask_ratio)``)
is computed on the CPU in float32 tensors, as XLA computes it (divisions
by constants as products with their reciprocals), so a mask length never
floors differently at a boundary.

Guidance (reference: 1d-tokenizer ``modeling/maskgit.py`` ``generate``):
``"constant"`` (the JAX package's, the default) takes ``cond + (cond -
uncond) * scale``; ``"power-cosine"`` (TiTok-S-128's) takes ``uncond +
(cond - uncond) * cfg`` with ``cfg = (scale - 1) * (1 - cos(pi * (step /
n) ** 3)) / 2 + 1`` (:func:`guidance_cfg`; the power is the published
sampler's default, :data:`GUIDANCE_SCALE_POW`), both passes at every step.
``softmax_temperature_annealing`` divides the guided logits by ``0.5 +
0.8 * (1 - ratio)`` (:func:`softmax_temperature`).  Both factors are
float32 numbers computed on the CPU.  :func:`generate` drives the
MaskGIT generator and the U-ViT one (``models/maskgit_uvit.py``) alike.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch import nn

from ..utils.profiling import timed_stage
from .layers import Embed, LayerNorm, Linear, ResidualAttentionBlock


@dataclasses.dataclass(frozen=True)
class MaskGITSpec:
    codebook_size: int = 4096
    condition_num_classes: int = 1000
    image_seq_len: int = 32
    hidden: int = 768
    num_layers: int = 24
    num_heads: int = 16

    @property
    def mask_token_id(self) -> int:
        return self.codebook_size

    @property
    def vocab_size(self) -> int:
        # image tokens + mask + class tokens + class-drop label
        return self.codebook_size + self.condition_num_classes + 2


class MaskGITGenerator(nn.Module):
    """Submodules carry the JAX package's names (``token_embedding``,
    ``ln_pre``, ``block_<i>``, ``ln_post``, ``lm_head``)."""

    # leaves weights.init_seeded draws N(0, 0.02), as flax's initializer
    # draws them (sic_tpu/models/maskgit.py:64-66)
    normal_002 = ("positional_embedding",)

    def __init__(self, spec: MaskGITSpec = MaskGITSpec()):
        super().__init__()
        s = self.spec = spec
        self.token_embedding = Embed(s.vocab_size, s.hidden)
        self.positional_embedding = nn.Parameter(
            0.02 * torch.randn(s.image_seq_len + 1, s.hidden))
        self.ln_pre = LayerNorm(s.hidden)
        for i in range(s.num_layers):
            self.add_module(f"block_{i}", ResidualAttentionBlock(s.hidden, s.num_heads))
        self.ln_post = LayerNorm(s.hidden)
        self.lm_head = Linear(s.hidden, s.codebook_size)

    def forward(self, input_ids: torch.Tensor, condition: torch.Tensor,
                drop_cond: torch.Tensor) -> torch.Tensor:
        """input_ids: (B, L) image-token ids (the mask id where unknown);
        condition: (B,) class ids; drop_cond: (B,) bool, which replaces the
        class token with the drop label (classifier-free guidance).
        Returns logits (B, L, codebook_size)."""
        s = self.spec
        cond_tok = torch.where(drop_cond,
                               s.condition_num_classes + s.codebook_size + 1,
                               condition + s.codebook_size + 1)
        ids = torch.cat([cond_tok[:, None], input_ids], dim=1).long()
        x = self.token_embedding(ids)
        x = self.ln_pre(x + self.positional_embedding.to(x.dtype))
        for i in range(s.num_layers):
            x = getattr(self, f"block_{i}")(x)
        logits = self.lm_head(self.ln_post(x))
        return logits[:, 1:]  # drop the condition position


def _gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    """Gumbel noise of ``shape`` on the generator's device: uniform in
    [1e-20, 1) from ``generator``, then ``-log(-log(u))``."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = (u * (1.0 - 1e-20) + 1e-20).clamp_min(1e-20)
    return -torch.log(-torch.log(u))


def step_schedule(step: int, num_sample_steps: int, seq_len: int,
                  randomize_temperature: float) -> Tuple[torch.Tensor, float]:
    """The temperature (a float32 scalar tensor) and the mask length before
    its clamps (``floor(L * arccos(ratio) / (pi / 2))``) of sampler step
    ``step``, in float32 on the CPU as XLA computes them.  XLA turns each
    division by a constant into a product with the constant's float32
    reciprocal, and its CPU backend fuses ``1 - (step + 1) * (1 / n)``
    into one multiply-add, rounded once; either rounds otherwise than
    plain float32 steps (ratio 5/12: temperature 2.625 there, 2.6250002 by
    division; 7/12: 1.875, 1.8749998 unfused)."""
    def recip(c):
        return 1.0 / torch.tensor(c, dtype=torch.float32)
    f32 = torch.float32
    inv_n = recip(num_sample_steps)
    ratio = torch.tensor(step + 1, dtype=f32) * inv_n
    # the fused multiply-add, exact in float64 (a small integer times a
    # float32), then rounded once to float32
    complement = (1.0 - (step + 1) * inv_n.double()).float()
    temp = torch.tensor(randomize_temperature, dtype=f32) * complement
    mask_ratio = torch.arccos(ratio) * recip(math.pi * 0.5)
    mask_len = torch.floor(torch.tensor(seq_len, dtype=f32) * mask_ratio)
    return temp, float(mask_len)


GUIDANCE_DECAYS = ("constant", "power-cosine")
# the power of the power-cosine schedule (the published sampler's default)
GUIDANCE_SCALE_POW = 3.0


def guidance_cfg(step: int, num_sample_steps: int, guidance_scale: float) -> float:
    """The power-cosine guidance factor of sampler step ``step``:
    ``(scale - 1) * (1 - cos(pi * (step / n) ** pow)) / 2 + 1``, in
    float32 on the CPU (1 at step 0, rising towards ``scale``)."""
    f32 = torch.float32
    t = torch.tensor(step / num_sample_steps, dtype=f32) \
        ** torch.tensor(GUIDANCE_SCALE_POW, dtype=f32)
    s = (1.0 - torch.cos(t * math.pi)) * 0.5
    return float((guidance_scale - 1.0) * s + 1.0)


def softmax_temperature(step: int, num_sample_steps: int) -> float:
    """The annealed softmax temperature of sampler step ``step``: ``0.5 +
    0.8 * (1 - (step + 1) / n)``, rounded to float32."""
    ratio = (step + 1) / num_sample_steps
    return float(torch.tensor(0.5 + 0.8 * (1.0 - ratio), dtype=torch.float32))


@torch.no_grad()
def generate(model: nn.Module, generator: torch.Generator,
             condition: torch.Tensor, guidance_scale: float = 3.0,
             randomize_temperature: float = 4.5,
             num_sample_steps: int = 8, guidance_decay: str = "constant",
             softmax_temperature_annealing: bool = False) -> torch.Tensor:
    """Iterative confidence-based sampling (reference: titok/maskgit.py:
    81-138): ``condition`` (B,) class ids on the model's device ->
    (B, image_seq_len) token ids in [0, codebook_size).  ``model``: a
    :class:`MaskGITGenerator` or a ``maskgit_uvit.UViTGenerator``."""
    if guidance_decay not in GUIDANCE_DECAYS:
        raise ValueError(f"guidance_decay {guidance_decay!r} is none of "
                         f"{GUIDANCE_DECAYS}")
    with timed_stage(None, "maskgit.generate"):
        return _generate(model, generator, condition, guidance_scale,
                         randomize_temperature, num_sample_steps, guidance_decay,
                         softmax_temperature_annealing)


def _generate(model, generator, condition, guidance_scale,
              randomize_temperature, num_sample_steps, guidance_decay,
              softmax_temperature_annealing):
    s = model.spec
    dev = condition.device
    B, L, mask_id = condition.shape[0], s.image_seq_len, s.mask_token_id
    ids = torch.full((B, L), mask_id, dtype=torch.long, device=dev)
    no_drop = torch.zeros((B,), dtype=torch.bool, device=dev)
    all_drop = torch.ones((B,), dtype=torch.bool, device=dev)
    for step in range(num_sample_steps):
        with timed_stage(None, "maskgit.step"):
            temp, mask_len = step_schedule(step, num_sample_steps, L,
                                           randomize_temperature)
            temp = temp.to(dev)
            is_mask = ids == mask_id

            logits = model(ids, condition, no_drop).float()
            if guidance_decay == "power-cosine":
                cfg = guidance_cfg(step, num_sample_steps, guidance_scale)
                uncond = model(ids, condition, all_drop).float()
                logits = uncond + (logits - uncond) * cfg
            elif guidance_scale != 0:
                uncond = model(ids, condition, all_drop).float()
                logits = logits + (logits - uncond) * guidance_scale
            if softmax_temperature_annealing:
                logits = logits / softmax_temperature(step, num_sample_steps)

            noisy = logits + temp * _gumbel(generator, logits.shape).to(dev)
            sampled = torch.argmax(noisy, dim=-1)
            samp_logit = torch.gather(logits, -1, sampled[..., None])[..., 0]
            sampled = torch.where(is_mask, sampled, ids)
            samp_logit = torch.where(is_mask, samp_logit,
                                     torch.full_like(samp_logit, math.inf))

            # at least one position is masked again, and at most all but one
            # of those still masked in the batch's least-masked sequence
            with timed_stage(None, "maskgit.sync"):    # waits for the card
                masked_least = int(is_mask.sum(dim=-1).min())
            mask_len = max(1.0, min(masked_least - 1.0, mask_len))

            confidence = samp_logit + temp * _gumbel(generator, samp_logit.shape).to(dev)
            sorted_conf = torch.sort(confidence, dim=-1).values
            cut_off = sorted_conf[:, int(mask_len) - 1][:, None]
            if step == num_sample_steps - 1:
                ids = sampled
            else:
                ids = torch.where(confidence <= cut_off,
                                  torch.full_like(sampled, mask_id), sampled)
    return ids
