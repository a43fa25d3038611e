"""Training losses (pure functions of the model outputs).

Counterparts of the JAX package's ``train/losses.py``: the feat-alignment
loss (reference: src/losses/feat_mse.py:24-45) and the VQ-LPIPS-GAN image
loss with the adaptive discriminator weight (reference:
src/taming/modules/losses/vqperceptual.py:37-162).  The adaptive weight
differentiates only the decoder's last convolution, re-applied to its
detached input, as the JAX package's nested ``jax.grad`` does.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over all positions; logits (..., K), integer labels (...)."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def feat_align_loss(feat_in, logits_in, feat_target, label_target,
                    vq_loss, sq_loss, *, mse_weight=1.0, ce_weight=0.25,
                    vq_weight=1.0, sq_weight=8.0, split="train"
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Stage-0/1 alignment loss (reference: feat_mse.py:32-45)."""
    mse = torch.mean((feat_in - feat_target) ** 2)
    ce = cross_entropy(logits_in, label_target)
    total = mse_weight * mse + ce_weight * ce + vq_weight * vq_loss \
        + sq_weight * sq_loss
    return total, {
        f"{split}/mse_loss": mse,
        f"{split}/ce_loss": ce,
        f"{split}/sq_loss": sq_loss,
        f"{split}/vq_loss": vq_loss,
        f"{split}/sq_lambda": torch.as_tensor(sq_weight),
    }


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real))
                  + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.softplus(-logits_real))
                  + torch.mean(F.softplus(logits_fake)))


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """(reference: vqperceptual.py:26-29)"""
    return value if global_step < threshold else weight


def adaptive_d_weight(last_kernel: torch.Tensor, nll_of_kernel: Callable,
                      g_of_kernel: Callable, *, disc_weight: float,
                      max_weight: float = 1e4,
                      reduce_grad: Callable = lambda g: g) -> torch.Tensor:
    """d_weight = ||grad_W nll|| / (||grad_W g|| + 1e-4), clamped and
    detached (reference: vqperceptual.py:67-78).  ``last_kernel`` is a
    leaf copy of the last convolution's weight.  ``reduce_grad`` takes each
    rank's gradient to the global batch's (the mean over a data group)
    before the norms are taken."""
    with torch.enable_grad():
        w = last_kernel.detach().requires_grad_(True)
        (nll_grads,) = torch.autograd.grad(nll_of_kernel(w), w)
        (g_grads,) = torch.autograd.grad(g_of_kernel(w), w)
    nll_grads, g_grads = reduce_grad(nll_grads), reduce_grad(g_grads)
    d_weight = (torch.linalg.vector_norm(nll_grads)
                / (torch.linalg.vector_norm(g_grads) + 1e-4))
    return torch.clamp(d_weight, 0.0, max_weight).detach() * disc_weight
