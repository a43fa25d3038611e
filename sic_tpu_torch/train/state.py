"""Train state, parameter partitioning and optimizers.

Counterpart of the JAX package's ``train/state.py`` (reference:
codec_sq_fixbpp.py:510-520, 560-569), in PyTorch idiom:

- a *static* partition labels each codec parameter frozen (TiTok backbone,
  latent tokens, TiTok codebook, VQGAN teacher encoder) or trainable, by
  its JAX-package key (:func:`weights.flax_key`); frozen parameters get
  ``requires_grad_(False)`` and no optimizer state.  With ``tune_titok``
  the TiTok encoder and decoder backbones train too (latent tokens and
  codebook stay frozen);
- the *stage-dependent* freeze (the VQGAN decoder side during the feat
  stages) is a gradient mask applied before the update.  It writes zeros,
  not ``None``: ``torch.optim.Adam`` skips a parameter whose gradient is
  ``None`` and its step count would then lag optax's, which counts every
  step of every parameter.  For the same reason a trainable parameter that
  a step does not reach gets a zero gradient.

The schedule state (``epoch_for_strategy``, ``lmbda_idx``, ``lmbda_list``,
``rate_floor``) and the noise generator live in :class:`TrainState`, so a
checkpoint carries them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from ..weights import named_flax_params

_FROZEN_TITOK_LEAVES = {
    "patch_embed", "class_embedding", "positional_embedding",
    "latent_token_positional_embedding", "ln_pre", "ln_post", "conv_out",
    "decoder_embed", "mask_token",
}

ADAM_BETAS = (0.5, 0.9)
ADAM_EPS = 1e-8


def is_frozen_path(path: Tuple[str, ...], tune_titok: bool = False) -> bool:
    """True for parameters the optimizer never updates (reference:
    codec_sq_fixbpp.py:48-52, 471-474); ``path`` is a JAX-package key split
    at ``/``."""
    if not path or path[0] != "params":
        path = ("params",) + tuple(path)
    p = path[1:]
    if p[0] == "hybrid_codec":
        if p[1] in ("latent_tokens", "quantize"):
            return True
        if p[1] in ("encoder", "decoder") and not tune_titok:
            leaf = p[2]
            return leaf in _FROZEN_TITOK_LEAVES or leaf.startswith("transformer_")
        return False
    if p[0] == "vqgan":
        return p[1] in ("encoder", "quant_conv")
    return False


def is_vqgan_decoder_side(path: Tuple[str, ...]) -> bool:
    if "vqgan" in path:
        return path[path.index("vqgan") + 1] in ("decoder", "post_quant_conv",
                                                 "quantize")
    return False


def named_codec_params(model: nn.Module) -> List[Tuple[Tuple[str, ...], nn.Parameter]]:
    """(JAX-package key path, parameter) for every parameter of ``model``."""
    return [(tuple(k.split("/")), p) for k, p in named_flax_params(model)]


def partition(model: nn.Module, tune_titok: bool = False):
    """Freeze the static partition in place; returns the trainable (path,
    parameter) pairs."""
    trainable = []
    for path, p in named_codec_params(model):
        frozen = is_frozen_path(path, tune_titok)
        p.requires_grad_(not frozen)
        if not frozen:
            trainable.append((path, p))
    return trainable


def stage_grad_mask(trainable, stage: str) -> None:
    """Give every trainable parameter a gradient (zeros where the step did
    not reach it), and zero the VQGAN decoder side's outside stage 'pix'
    (reference: codec_sq_fixbpp.py:560-569)."""
    for path, p in trainable:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        elif stage != "pix" and is_vqgan_decoder_side(path):
            p.grad.zero_()


def make_optimizer(params, learning_rate: float) -> torch.optim.Adam:
    """Adam with betas (0.5, 0.9), eps 1e-8 (reference:
    codec_sq_fixbpp.py:510-517), the JAX package's optax.adam."""
    return torch.optim.Adam(params, lr=learning_rate, betas=ADAM_BETAS,
                            eps=ADAM_EPS)


@dataclasses.dataclass
class TrainState:
    """Everything a training step reads or updates.  Steps update it in
    place (modules, optimizers, counters, the generator)."""
    model: nn.Module
    disc: nn.Module
    lpips: nn.Module
    trainable: list
    opt_ae: torch.optim.Optimizer
    opt_disc: torch.optim.Optimizer
    generator: torch.Generator
    global_step: int = 0
    epoch_for_strategy: int = 0
    lmbda_idx: int = 0
    lmbda_list: Tuple[float, ...] = (1.0,)
    rate_floor: float = 0.0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def current_lmbda(self) -> float:
        """The lambda weight, as the float32 value the JAX state holds."""
        i = min(max(self.lmbda_idx, 0), len(self.lmbda_list) - 1)
        return float(np.float32(self.lmbda_list[i]))

    _SCHEDULE = ("global_step", "epoch_for_strategy", "lmbda_idx",
                 "lmbda_list", "rate_floor")

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "disc": self.disc.state_dict(),
                "opt_ae": self.opt_ae.state_dict(),
                "opt_disc": self.opt_disc.state_dict(),
                "generator": self.generator.get_state(),
                **{k: getattr(self, k) for k in self._SCHEDULE}}

    def load_state_dict(self, ck: dict) -> None:
        self.model.load_state_dict(ck["model"])
        self.disc.load_state_dict(ck["disc"])
        self.opt_ae.load_state_dict(ck["opt_ae"])
        self.opt_disc.load_state_dict(ck["opt_disc"])
        self.generator.set_state(ck["generator"].cpu())
        for k in self._SCHEDULE:
            setattr(self, k, ck[k])
