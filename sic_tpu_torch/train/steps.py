"""Training and validation steps of the three-stage schedule.

Counterpart of the JAX package's ``train/steps.py`` (reference: the
manual-optimization ``training_step`` of src/models/codec_sq_fixbpp.py:
701-829).  A step updates the :class:`~.state.TrainState` in place and
returns its logs as detached tensors.  The bottleneck's rate noise comes
from ``state.generator``, or from an explicit ``noise`` tensor (a test feeds
the JAX package's draw).

The discriminator's BatchNorm statistics move only on its own update (real
pass, then fake pass): the generator-side passes, the adaptive weight's two
included, normalise with batch statistics and keep nothing, as the JAX
steps discard what their ``mutable`` passes produce.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .losses import (adaptive_d_weight, adopt_weight, feat_align_loss,
                     hinge_d_loss, vanilla_d_loss)
from .state import TrainState, stage_grad_mask


@dataclasses.dataclass(frozen=True)
class FeatLossCfg:
    """(reference: config_test.yaml:72-76)"""
    mse_weight: float = 1.0
    ce_weight: float = 0.25
    vq_weight: float = 1.0
    rate_push_w: float = 1.0     # weight of the below-band rate hinge


@dataclasses.dataclass(frozen=True)
class ImgLossCfg:
    """(reference: config_test.yaml:64-70, vqperceptual.py:38-41)

    ``perceptual``: ``"lpips"`` (needs a VGG16 checkpoint to mean
    anything), ``"msssim"`` (1 - MS-SSIM, checkpoint-free) or ``"none"``.
    ``disc_loss``: ``"hinge"`` or ``"vanilla"`` (softplus).

    ``rate_push_w``: both stages add the below-band rate hinge
    ``rate_push_w * relu(rate_floor - bpp_noise)`` (the feat stages at
    ``FeatLossCfg.rate_push_w``).  The lambda * bpp term only pushes the
    rate down; once every symbol rounds to zero the hard-quant stream is
    empty and lambda has no lever left, so the hinge pushes the noise-proxy
    rate up exactly when it falls below the stage's band floor
    (``rate_floor`` 0 disables it).

    ``align_weight > 0`` keeps the feat stages' teacher-alignment terms
    (latent MSE and index CE against the frozen VQGAN teacher) in the pix
    objective at this weight, for a run that enters pix before alignment
    has converged (the reference's pix stage drops them, starting from a
    converged feat model: codec_sq_fixbpp.py:739-777)."""
    disc_start: int = 0
    disc_weight: float = 0.75
    disc_factor: float = 1.0
    codebook_weight: float = 1.0
    perceptual_weight: float = 1.0
    adaptive_disc_max: float = 1e4
    disc_num_layers: int = 3
    disc_ndf: int = 64
    disc_loss: str = "hinge"
    perceptual: str = "lpips"
    align_weight: float = 0.0
    rate_push_w: float = 1.0


def _last_conv_apply(h_pre, w, b):
    """Re-apply the decoder's final 3x3 convolution with weight ``w``
    (OIHW) to the NHWC activation ``h_pre``."""
    return F.conv2d(h_pre.permute(0, 3, 1, 2), w, b, padding=1).permute(0, 2, 3, 1)


def _detach(logs: Dict) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).detach() for k, v in logs.items()}


class TrainSteps:
    """``feat_step``, ``pix_step`` and ``eval_step`` for one loss
    configuration."""

    def __init__(self, feat_cfg: FeatLossCfg, img_cfg: ImgLossCfg):
        if img_cfg.perceptual not in ("lpips", "msssim", "none"):
            raise ValueError(f"unknown perceptual mode: {img_cfg.perceptual!r}")
        if img_cfg.disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"unknown disc_loss: {img_cfg.disc_loss!r}")
        self.feat_cfg, self.img_cfg = feat_cfg, img_cfg
        self.d_loss_fn = (hinge_d_loss if img_cfg.disc_loss == "hinge"
                          else vanilla_d_loss)

    def _nll(self, state: TrainState, x, x_hat):
        rec = torch.mean(torch.abs(x - x_hat))
        mode = self.img_cfg.perceptual
        if mode == "lpips":
            p = torch.mean(state.lpips(x, x_hat))
        elif mode == "msssim":
            from ..metrics import ms_ssim
            p = torch.mean(1.0 - ms_ssim(x, x_hat))
        else:
            p = torch.zeros((), dtype=x.dtype, device=x.device)
        return rec + self.img_cfg.perceptual_weight * p, rec, p

    @staticmethod
    def _noise_args(state: TrainState, noise: Optional[torch.Tensor]):
        return {"noise": noise, "generator": None if noise is not None
                else state.generator}

    # -- stage feat / feat_wo_bpp ---------------------------------------------
    def feat_step(self, state: TrainState, x: torch.Tensor,
                  noise: Optional[torch.Tensor] = None) -> Dict:
        cfg = self.feat_cfg
        model = state.model
        lmbda = state.current_lmbda()
        with torch.no_grad():
            teacher_latent, teacher_idx = model.encode_to_vqgan(x)
        out = model(x, need_full_decode=False, training=True,
                    **self._noise_args(state, noise))
        loss, logs = feat_align_loss(
            out["vqgan_latent"], out["logits"], teacher_latent, teacher_idx,
            out["vq_loss"], out["bpp_loss"], mse_weight=cfg.mse_weight,
            ce_weight=cfg.ce_weight, vq_weight=cfg.vq_weight, sq_weight=lmbda)
        rate_push = cfg.rate_push_w * F.relu(state.rate_floor - out["bpp_loss"])
        loss = loss + rate_push
        logs.update({"train/rate_push": rate_push, "train/align_loss": loss,
                     "train/bpp": out["bpp_loss"],
                     "train/bpp_hard_quant": out["bpp_hard_quant"],
                     "train/lambda": lmbda})
        state.opt_ae.zero_grad(set_to_none=True)
        loss.backward()
        stage_grad_mask(state.trainable, "feat")
        state.opt_ae.step()
        state.global_step += 1
        return _detach(logs)

    # -- stage pix: generator + discriminator ---------------------------------
    def pix_step(self, state: TrainState, x: torch.Tensor,
                 noise: Optional[torch.Tensor] = None) -> Dict:
        cfg = self.img_cfg
        model, disc = state.model, state.disc
        lmbda = state.current_lmbda()
        disc_factor = adopt_weight(cfg.disc_factor, state.global_step,
                                   cfg.disc_start)
        if cfg.align_weight > 0.0:
            with torch.no_grad():
                teacher_latent, teacher_idx = model.encode_to_vqgan(x)

        def g_of(xh):
            return -torch.mean(disc(xh, train=True))

        disc.requires_grad_(False)      # the generator loss moves no disc weight
        out = model(x, need_full_decode=True, training=True,
                    return_pre_out=True, **self._noise_args(state, noise))
        x_hat = out["x_hat"]
        nll, rec, p = self._nll(state, x, x_hat)
        g_loss = g_of(x_hat)
        conv_out = model.vqgan.decoder.conv_out
        h_pre, b_last = out["pre_out"].detach(), conv_out.bias.detach()
        d_weight = adaptive_d_weight(
            conv_out.weight,
            lambda w: self._nll(state, x, _last_conv_apply(h_pre, w, b_last))[0],
            lambda w: g_of(_last_conv_apply(h_pre, w, b_last)),
            disc_weight=cfg.disc_weight, max_weight=cfg.adaptive_disc_max)
        loss = (nll + d_weight * disc_factor * g_loss
                + cfg.codebook_weight * out["vq_loss"] + lmbda * out["bpp_loss"])
        rate_push = cfg.rate_push_w * F.relu(state.rate_floor - out["bpp_loss"])
        loss = loss + rate_push
        logs = {}
        if cfg.align_weight > 0.0:
            fc = self.feat_cfg
            align, _ = feat_align_loss(
                out["vqgan_latent"], out["logits"], teacher_latent, teacher_idx,
                out["vq_loss"], out["bpp_loss"], mse_weight=fc.mse_weight,
                ce_weight=fc.ce_weight, vq_weight=0.0, sq_weight=0.0)
            loss = loss + cfg.align_weight * align   # vq and rate are above
            logs["train/pix_align_loss"] = align
        logs.update({
            "train/rate_push": rate_push, "train/ae_loss": loss,
            "train/nll_loss": nll, "train/rec_loss": rec, "train/p_loss": p,
            "train/g_loss": g_loss, "train/d_weight": d_weight,
            "train/quant_loss": out["vq_loss"], "train/bpp": out["bpp_loss"],
            "train/bpp_hard_quant": out["bpp_hard_quant"],
            "train/lambda": lmbda, "train/disc_factor": disc_factor})
        state.opt_ae.zero_grad(set_to_none=True)
        loss.backward()
        stage_grad_mask(state.trainable, "pix")
        state.opt_ae.step()
        disc.requires_grad_(True)

        # discriminator update on the detached reconstruction (reference:
        # :763-777); its BatchNorm statistics move twice, real then fake
        x_hat = x_hat.detach()
        logits_real = disc(x, train=True, update_stats=True)
        logits_fake = disc(x_hat, train=True, update_stats=True)
        d_loss = disc_factor * self.d_loss_fn(logits_real, logits_fake)
        state.opt_disc.zero_grad(set_to_none=True)
        d_loss.backward()
        state.opt_disc.step()
        logs.update({"train/disc_loss": d_loss,
                     "train/logits_real": torch.mean(logits_real),
                     "train/logits_fake": torch.mean(logits_fake)})
        state.global_step += 1
        return _detach(logs)

    # -- validation -----------------------------------------------------------
    @torch.no_grad()
    def eval_step(self, state: TrainState, x: torch.Tensor) -> Dict:
        cfg = self.feat_cfg
        model = state.model
        lmbda = state.current_lmbda()
        teacher_latent, teacher_idx = model.encode_to_vqgan(x)
        out = model(x, need_full_decode=True, training=False)
        align, _ = feat_align_loss(
            out["vqgan_latent"], out["logits"], teacher_latent, teacher_idx,
            out["vq_loss"], out["bpp_loss"], mse_weight=cfg.mse_weight,
            ce_weight=cfg.ce_weight, vq_weight=cfg.vq_weight, sq_weight=lmbda,
            split="val")
        nll, rec, p = self._nll(state, x, out["x_hat"])
        # checkpoint-selection loss; the +100 outside stage pix is the
        # trainer's (reference: codec_sq_fixbpp.py:821-828)
        saved_loss = rec + lmbda * out["bpp_loss"] * 2.0
        return _detach({"val/align_loss": align, "val/rec_loss": rec,
                        "val/p_loss": p, "val/nll_loss": nll,
                        "val/bpp": out["bpp_loss"], "val/saved_loss": saved_loss})
