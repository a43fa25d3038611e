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

The JAX package's single-chip memory options have their counterparts here:
:func:`cast_frozen_params` stores the frozen leaves in bf16, and
:class:`MomentDtypeAdam` keeps Adam's first moments in bf16 (optax's
``mu_dtype``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Tuple

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


def cast_frozen_params(model: nn.Module, dtype: torch.dtype,
                       tune_titok: bool = False) -> None:
    """Store every frozen parameter of ``model`` (:func:`is_frozen_path`)
    in ``dtype``, in place: the JAX package's ``cast_frozen_params``.  They
    are inference-only; each module upcasts them where it computes in f32,
    as JAX's promotion does."""
    for path, p in named_codec_params(model):
        if is_frozen_path(path, tune_titok):
            p.data = p.data.to(dtype)


class MomentDtypeAdam(torch.optim.Optimizer):
    """Adam with its first moment stored in ``mu_dtype``, step for step as
    optax's ``adam(mu_dtype=...)`` (``scale_by_adam`` then
    ``scale_by_learning_rate``): mu is updated in f32 from the stored mu
    (``(1 - b1) g + b1 mu``, the product ``b1 mu`` taken in the stored
    dtype as optax's weakly typed scalar leaves it), the step is taken from
    that f32 value, and mu is then stored cast to ``mu_dtype``; nu stays
    f32.  Its state (``step``, ``exp_avg``, ``exp_avg_sq``) is in the
    checkpoint's ``state_dict``."""

    def __init__(self, params, lr: float, betas=ADAM_BETAS, eps: float = ADAM_EPS,
                 mu_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      mu_dtype=mu_dtype))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    # the step as torch.optim.Adam keeps it (a CPU f32
                    # scalar), so a checkpoint of either resumes in the other
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p, dtype=group["mu_dtype"])
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                st["step"] += 1
            count = float(states[0]["step"])
            grads = [p.grad for p in params]
            mus = [st["exp_avg"] for st in states]
            nus = [st["exp_avg_sq"] for st in states]
            mu32 = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(mu32, torch._foreach_mul(mus, b1))
            nu = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(nu, 1.0 - b2)
            torch._foreach_add_(nu, torch._foreach_mul(nus, b2))
            # optax's bias corrections, 1 - b ** count, in f32
            bc1 = float(1.0 - np.float32(b1) ** np.float32(count))
            bc2 = float(1.0 - np.float32(b2) ** np.float32(count))
            upd = torch._foreach_div(mu32, bc1)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(upd, den)
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)
            for m, m32, n, n32 in zip(mus, mu32, nus, nu):
                m.copy_(m32)
                n.copy_(n32)

    def load_state_dict(self, state_dict) -> None:
        # torch casts loaded state to each parameter's dtype; mu goes back
        # to its own (exact when it was saved in mu_dtype); the groups of a
        # torch.optim.Adam checkpoint carry no mu_dtype
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            group.setdefault("mu_dtype", self.defaults["mu_dtype"])
            for p in group["params"]:
                st = self.state.get(p)
                if st:
                    st["exp_avg"] = st["exp_avg"].to(group["mu_dtype"])


def make_optimizer(params, learning_rate: float, mu_dtype=None):
    """Adam with betas (0.5, 0.9), eps 1e-8 (reference:
    codec_sq_fixbpp.py:510-517), the JAX package's optax.adam:
    ``torch.optim.Adam``, or with ``mu_dtype`` (optax's argument of that
    name) :class:`MomentDtypeAdam`."""
    if mu_dtype is not None:
        return MomentDtypeAdam(params, learning_rate, mu_dtype=mu_dtype)
    return torch.optim.Adam(params, lr=learning_rate, betas=ADAM_BETAS,
                            eps=ADAM_EPS)


@dataclasses.dataclass
class TrainState:
    """Everything a training step reads or updates.  Steps update it in
    place (modules, optimizers, counters, the generator).

    ``data``: the data group the global batch is split over
    (:class:`~sic_tpu_torch.parallel.multihost.Group`; None in one
    process).  ``pipe``: the model's :class:`~sic_tpu_torch.models.hybrid.PPConfig`
    when its trunks run as pipeline stages; ``full_trainable`` then names
    the whole model's trainable leaves in :func:`partition`'s order (a
    checkpoint gathers the stages' in that order)."""
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
    data: Any = None
    pipe: Any = None
    full_trainable: Tuple[str, ...] = ()
    mesh: Any = None
    layout: Any = None
    fsdp: dict = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def tile(self):
        """The tile group the images' width is split over (None: none)."""
        return None if self.mesh is None else self.mesh.tile

    @property
    def grad_group(self):
        """The ranks that average their gradients: data (and tile)."""
        return self.data if self.mesh is None else self.mesh.grad_group

    @contextlib.contextmanager
    def step_scope(self):
        """A step's scope: whole FSDP parameters, and the width split of
        the mesh (each FSDP leaf goes back to its chunk at the step's
        :func:`sync_grads`, or at the end of the block)."""
        from ..parallel.collectives import tile_parallel
        for f in self.fsdp.values():
            f.unshard()
        try:
            with tile_parallel(self.tile):
                yield
        finally:
            for f in self.fsdp.values():
                f.reshard(reduce=False)

    def sync_grads(self, params, part: str = "model") -> None:
        """Average the gradients of ``params`` over the ranks that hold the
        same parameters (data and tile); the leaves of ``self.fsdp[part]``
        (an :class:`~sic_tpu_torch.parallel.mesh.FSDP`) are averaged over
        tile, then reduce-scattered over data, and go back to their
        chunks."""
        from ..parallel.multihost import reduce_grads
        params = list(params)
        fsdp = self.fsdp.get(part)
        if fsdp is None:
            reduce_grads(params, self.grad_group)
            return
        planned = {id(p) for _, p, _ in fsdp.leaves}
        reduce_grads([p for p in params if id(p) not in planned], self.grad_group)
        reduce_grads([p for p in params if id(p) in planned], self.tile)
        fsdp.reshard()

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
