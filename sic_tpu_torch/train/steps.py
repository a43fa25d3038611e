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

Under data parallelism (``state.data``, a data group: each rank holds a
contiguous equal block of the global batch) a step computes what the
one-process step computes on the whole batch, as the JAX package's global
arrays do: the rate noise is the global batch's draw from the shared
generator, of which each rank takes its rows; the rate hinge's indicator
reads the global mean rate; the adaptive weight takes the norms of the
global gradients at the last convolution; the discriminator normalises
with the global batch statistics; gradients are averaged over the group
before each update; and the returned logs are global means, the same on
every rank.

On a process grid (``state.mesh``, :mod:`~sic_tpu_torch.parallel.mesh`)
a step runs in :meth:`~.state.TrainState.step_scope`: FSDP leaves whole,
the model's blocks split over ``model`` as the modules hold them, and the
images' width split over ``tile``.  Under the width split every loss term
is the whole image's: the mean absolute error and the perceptual slices'
spatial means are averaged over the ranks, the rate comes from the
gathered latent, the alignment terms and the discriminator (and so its
BatchNorm statistics and the GAN terms) take gathered maps, and the
adaptive weight takes the gradients' mean over the ranks.  Every rank then
holds the same loss, and each gradient is the mean of the ranks'
(``state.sync_grads``; :mod:`~sic_tpu_torch.parallel.collectives`).

Under a bf16 compute dtype (``create_train_state(dtype=torch.bfloat16)``)
the steps take the JAX steps' dtypes: the alignment terms (MSE, CE) of the
bf16 latent and logits are bf16 and the sums that meet an f32 term (the VQ
loss, the rates) f32; the reconstruction, the perceptual term and the
discriminator (f32 parameters) take the bf16 reconstruction promoted to
f32; the bottleneck and its rates stay f32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..entropy.fourpart import uniform_noise
from ..models.layers import conv_same
from ..parallel.collectives import tile_gather, tile_mean
from ..parallel.multihost import all_mean, global_mean, take_rows
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
    (OIHW) to the NHWC activation ``h_pre``, in ``w``'s (f32) dtype: under
    a bf16 compute dtype ``h_pre`` is bf16 and is promoted, as jnp's rule
    promotes mixed operands.  (The JAX package's ``lax`` convolution here
    refuses a bf16 ``h_pre`` beside the f32 kernel, so its pix step does
    not run under ``Codec(spec, jnp.bfloat16)``.)  On width slabs its
    halo comes from the neighbouring ranks."""
    return conv_same(h_pre.to(w.dtype), w, b)


def _detach(logs: Dict, data=None, device=None) -> Dict[str, torch.Tensor]:
    """The logs as detached tensors; with a data group, each the mean over
    its ranks (one all-reduce, on ``device``)."""
    logs = {k: torch.as_tensor(v).detach() for k, v in logs.items()}
    if data is None:
        return logs
    keys = sorted(logs)
    vec = all_mean(torch.stack([logs[k].float().to(device) for k in keys]), data)
    return {k: vec[i] for i, k in enumerate(keys)}


# the eval step's logs, in one order on every rank
EVAL_LOGS = ("val/align_loss", "val/bpp", "val/nll_loss", "val/p_loss",
             "val/rec_loss", "val/saved_loss")


def rate_noise_shape(spec, x_shape):
    """Shape of the bottleneck's rate noise for an (B, H, W, 3) image batch:
    the detail latent, at stride 2 * patch_size, with quant_dim channels."""
    B, H, W, _ = x_shape
    stride = 2 * spec.titok.patch_size
    return (B, H // stride, W // stride, spec.quant_dim)


def _align_inputs(out, teacher_latent, teacher_idx):
    """The alignment terms' maps, whole (gathered across a width split)."""
    return (tile_gather(out["vqgan_latent"]), tile_gather(out["logits"]),
            tile_gather(teacher_latent), tile_gather(teacher_idx))


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
        rec = tile_mean(torch.mean(torch.abs(x - x_hat)))
        mode = self.img_cfg.perceptual
        if mode == "lpips":
            p = torch.mean(state.lpips(x, x_hat))
        elif mode == "msssim":
            from ..metrics import ms_ssim
            p = torch.mean(1.0 - ms_ssim(tile_gather(x), tile_gather(x_hat)))
        else:
            p = torch.zeros((), dtype=x.dtype, device=x.device)
        return rec + self.img_cfg.perceptual_weight * p, rec, p

    @staticmethod
    def _noise_args(state: TrainState, x: torch.Tensor,
                    noise: Optional[torch.Tensor]):
        """The rate noise: ``noise``; else, under data parallelism, this
        rank's rows of the global batch's draw from ``state.generator``
        (every rank draws it, so the generators stay equal); else the
        model draws it from ``state.generator``."""
        if noise is None and state.data is not None:
            B, H, W, q = rate_noise_shape(state.model.spec, x.shape)
            rest = (H, W * (state.tile.size if state.tile else 1), q)
            full = uniform_noise((B * state.data.size, *rest), state.generator,
                                 x.device)
            noise = take_rows(full, state.data)
        return {"noise": noise, "generator": None if noise is not None
                else state.generator}

    # -- stage feat / feat_wo_bpp ---------------------------------------------
    def feat_step(self, state: TrainState, x: torch.Tensor,
                  noise: Optional[torch.Tensor] = None) -> Dict:
        with state.step_scope():
            return self._feat_step(state, x, noise)

    def _feat_step(self, state, x, noise):
        cfg = self.feat_cfg
        model = state.model
        lmbda = state.current_lmbda()
        with torch.no_grad():
            teacher_latent, teacher_idx = model.encode_to_vqgan(x)
        out = model(x, need_full_decode=False, training=True,
                    **self._noise_args(state, x, noise))
        latent, logits, t_latent, t_idx = _align_inputs(out, teacher_latent,
                                                        teacher_idx)
        loss, logs = feat_align_loss(
            latent, logits, t_latent, t_idx,
            out["vq_loss"], out["bpp_loss"], mse_weight=cfg.mse_weight,
            ce_weight=cfg.ce_weight, vq_weight=cfg.vq_weight, sq_weight=lmbda)
        rate_push = cfg.rate_push_w * F.relu(
            state.rate_floor - global_mean(out["bpp_loss"], state.data))
        loss = loss + rate_push
        logs.update({"train/rate_push": rate_push, "train/align_loss": loss,
                     "train/bpp": out["bpp_loss"],
                     "train/bpp_hard_quant": out["bpp_hard_quant"],
                     "train/lambda": lmbda})
        state.opt_ae.zero_grad(set_to_none=True)
        loss.backward()
        stage_grad_mask(state.trainable, "feat")
        state.sync_grads(p for _, p in state.trainable)
        state.opt_ae.step()
        state.global_step += 1
        return _detach(logs, state.data, state.device)

    # -- stage pix: generator + discriminator ---------------------------------
    def pix_step(self, state: TrainState, x: torch.Tensor,
                 noise: Optional[torch.Tensor] = None) -> Dict:
        with state.step_scope():
            return self._pix_step(state, x, noise)

    def _pix_step(self, state, x, noise):
        cfg = self.img_cfg
        model, disc = state.model, state.disc
        lmbda = state.current_lmbda()
        disc_factor = adopt_weight(cfg.disc_factor, state.global_step,
                                   cfg.disc_start)
        if cfg.align_weight > 0.0:
            with torch.no_grad():
                teacher_latent, teacher_idx = model.encode_to_vqgan(x)

        def g_of(xh):
            # the discriminator sees whole images (gathered across tiles)
            return -torch.mean(disc(tile_gather(xh), train=True))

        def mean_over_ranks(g):
            return all_mean(all_mean(g, state.tile), state.data)

        disc.requires_grad_(False)      # the generator loss moves no disc weight
        out = model(x, need_full_decode=True, training=True,
                    return_pre_out=True, **self._noise_args(state, x, noise))
        x_hat = out["x_hat"]
        nll, rec, p = self._nll(state, x, x_hat)
        g_loss = g_of(x_hat)
        conv_out = model.vqgan.decoder.conv_out
        h_pre, b_last = out["pre_out"].detach(), conv_out.bias.detach()
        d_weight = adaptive_d_weight(
            conv_out.weight,
            lambda w: self._nll(state, x, _last_conv_apply(h_pre, w, b_last))[0],
            lambda w: g_of(_last_conv_apply(h_pre, w, b_last)),
            disc_weight=cfg.disc_weight, max_weight=cfg.adaptive_disc_max,
            reduce_grad=mean_over_ranks)
        loss = (nll + d_weight * disc_factor * g_loss
                + cfg.codebook_weight * out["vq_loss"] + lmbda * out["bpp_loss"])
        rate_push = cfg.rate_push_w * F.relu(
            state.rate_floor - global_mean(out["bpp_loss"], state.data))
        loss = loss + rate_push
        logs = {}
        if cfg.align_weight > 0.0:
            fc = self.feat_cfg
            latent, logits, t_latent, t_idx = _align_inputs(out, teacher_latent,
                                                            teacher_idx)
            align, _ = feat_align_loss(
                latent, logits, t_latent, t_idx,
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
        state.sync_grads(p for _, p in state.trainable)
        state.opt_ae.step()
        disc.requires_grad_(True)

        # discriminator update on the detached reconstruction (reference:
        # :763-777); its BatchNorm statistics move twice, real then fake
        x_whole, x_hat = tile_gather(x), tile_gather(x_hat.detach())
        logits_real = disc(x_whole, train=True, update_stats=True)
        logits_fake = disc(x_hat, train=True, update_stats=True)
        d_loss = disc_factor * self.d_loss_fn(logits_real, logits_fake)
        state.opt_disc.zero_grad(set_to_none=True)
        d_loss.backward()
        state.sync_grads(disc.parameters(), "disc")
        state.opt_disc.step()
        logs.update({"train/disc_loss": d_loss,
                     "train/logits_real": torch.mean(logits_real),
                     "train/logits_fake": torch.mean(logits_fake)})
        state.global_step += 1
        return _detach(logs, state.data, state.device)

    # -- validation -----------------------------------------------------------
    @torch.no_grad()
    def eval_step(self, state: TrainState, x: torch.Tensor) -> Dict:
        with state.step_scope():
            return self._eval_step(state, x)

    def _eval_step(self, state, x):
        cfg = self.feat_cfg
        model = state.model
        lmbda = state.current_lmbda()
        teacher_latent, teacher_idx = model.encode_to_vqgan(x)
        out = model(x, need_full_decode=True, training=False)
        latent, logits, t_latent, t_idx = _align_inputs(out, teacher_latent,
                                                        teacher_idx)
        align, _ = feat_align_loss(
            latent, logits, t_latent, t_idx,
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
