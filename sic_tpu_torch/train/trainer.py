"""Host-side training loop: stage schedule, rate control, checkpoints.

Counterpart of the JAX package's ``train/trainer.py`` (reference:
codec_sq_fixbpp.py:554-593, 608-639): the epoch loop with per-epoch stage
selection, the validation-bpp lambda controller, stage-transition
checkpoints and the final ``last``.  Checkpoints are ``torch.save`` files
under the JAX package's names (``<stage>_epo_for_strategy_<epoch>``,
``last``) holding the models, both optimizers, the schedule and the noise
generator.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..config import CodecSpec
from ..models.codec import Codec, configure_numerics, resolve_device
from ..models.discriminator import NLayerDiscriminator
from ..models.lpips import LPIPS, load_lpips_weights
from ..weights import init_seeded, load_flax_params
from .state import TrainState, cast_frozen_params, make_optimizer, partition
from .steps import FeatLossCfg, ImgLossCfg, TrainSteps
from .strategy import TrainingStrategy


def create_train_state(spec: CodecSpec, strategy: TrainingStrategy,
                       seed: int = 0, feat_cfg: FeatLossCfg = FeatLossCfg(),
                       img_cfg: ImgLossCfg = ImgLossCfg(), codec_params=None,
                       device=None, lpips_lin: Optional[str] = None,
                       lpips_vgg: Optional[str] = None, tune_titok: bool = False,
                       dtype: Optional[torch.dtype] = None,
                       mu_dtype: Optional[torch.dtype] = None,
                       frozen_dtype: Optional[torch.dtype] = None,
                       donate: bool = False):
    """Models, optimizers and steps, on ``device`` (CUDA unless named).

    ``codec_params``: a flat ``params/...`` dict for the codec (default: the
    seeded initialisation).  ``lpips_lin``/``lpips_vgg``: torch checkpoints
    of the LPIPS calibration heads and the VGG16 backbone; with
    ``perceptual == "lpips"`` and no backbone the perceptual term scores a
    seeded network, and a warning says so.  ``tune_titok``: the TiTok
    encoder and decoder backbones train too.

    The JAX package's single-chip options, under its names and defaults
    (all f32 unless given): ``dtype`` the codec's compute dtype
    (``Codec(spec, dtype)``: f32 parameters computed in bf16);
    ``mu_dtype`` Adam's first-moment dtype (:class:`~.state.MomentDtypeAdam`);
    ``frozen_dtype`` the storage dtype of the frozen leaves
    (:func:`~.state.cast_frozen_params`).  ``donate`` is accepted and does
    nothing: PyTorch updates the state in place already, which is what
    JAX's buffer donation buys.  Returns (model, state, steps)."""
    del donate
    steps = TrainSteps(feat_cfg, img_cfg)     # a bad flag fails before the build
    dev = resolve_device(device)
    configure_numerics()
    with torch.device(dev):
        model = Codec(spec, dtype)
        disc = NLayerDiscriminator(img_cfg.disc_ndf, img_cfg.disc_num_layers)
        lpips = LPIPS()
    if codec_params is None:
        init_seeded(model, seed)
    else:
        stray = load_flax_params(model, codec_params)
        if stray:
            raise ValueError(f"{len(stray)} leaves fit no parameter, e.g. "
                             f"{sorted(stray)[:3]}")
    gens = [torch.Generator(device=dev).manual_seed(seed + i) for i in (1, 2, 3)]
    disc.init_weights(gens[0])
    lpips.init_weights(gens[1])
    load_lpips_weights(lpips, lpips_lin, lpips_vgg)
    lpips.requires_grad_(False)
    if img_cfg.perceptual == "lpips" and not lpips_vgg:
        warnings.warn(
            "perceptual='lpips' without --lpips_vgg: the VGG16 backbone is "
            "UNCALIBRATED (seeded weights) and the perceptual loss is "
            "meaningless. Pass a torchvision VGG16 checkpoint or train with "
            "perceptual='msssim'.", stacklevel=2)
    trainable = partition(model, tune_titok)
    if frozen_dtype is not None:
        cast_frozen_params(model, frozen_dtype, tune_titok)
    _, stage0 = strategy.stage_at(strategy.start_epoch)
    state = TrainState(
        model=model, disc=disc, lpips=lpips, trainable=trainable,
        opt_ae=make_optimizer([p for _, p in trainable], strategy.learning_rate,
                              mu_dtype),
        opt_disc=make_optimizer(disc.parameters(), strategy.learning_rate),
        generator=gens[2], epoch_for_strategy=strategy.start_epoch,
        lmbda_idx=stage0.init_lmbda_idx, lmbda_list=tuple(stage0.lmbda_list),
        rate_floor=float(np.float32(stage0.bpp_lower)))
    return model, state, steps


def save_checkpoint(ckpt_dir, state: TrainState, name: str) -> str:
    path = Path(ckpt_dir).resolve() / name
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state.state_dict(), path)
    return str(path)


def load_checkpoint(path, state: TrainState) -> TrainState:
    """Restore a :func:`save_checkpoint` file into ``state`` (in place)."""
    state.load_state_dict(torch.load(path, map_location=state.device,
                                     weights_only=False))
    return state


@dataclasses.dataclass
class Trainer:
    """Drives the three-stage schedule over data iterables.

    ``train_data`` / ``val_data`` are callables returning fresh iterables of
    (B, H, W, 3) float arrays in [-1, 1] per epoch."""
    model: Codec
    state: TrainState
    steps: TrainSteps
    strategy: TrainingStrategy
    ckpt_dir: Optional[str] = None
    log_fn: Callable[[Dict], None] = lambda logs: None
    log_every: int = 50

    def _batch(self, batch) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch, np.float32), device=self.state.device)

    def train_epoch(self, train_data: Iterable) -> str:
        """One epoch at the current schedule position; returns stage name."""
        epoch = self.state.epoch_for_strategy
        stage, _ = self.strategy.stage_at(epoch)
        step_fn = self.steps.pix_step if stage == "pix" else self.steps.feat_step
        for i, batch in enumerate(train_data):
            logs = step_fn(self.state, self._batch(batch))
            if i % self.log_every == 0:
                self.log_fn({k: float(v) for k, v in logs.items()}
                            | {"epoch": epoch, "stage": stage})
        return stage

    def validate(self, val_data: Iterable) -> Dict[str, float]:
        sums: Dict[str, float] = {}
        n = 0
        for batch in val_data:
            for k, v in self.steps.eval_step(self.state, self._batch(batch)).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        means = {k: v / max(n, 1) for k, v in sums.items()}
        stage, _ = self.strategy.stage_at(self.state.epoch_for_strategy)
        if stage != "pix":  # only final-stage checkpoints can win the monitor
            means["val/saved_loss"] = means.get("val/saved_loss", 0.0) + 100.0
        return means

    def end_of_epoch(self, val_metrics: Optional[Dict[str, float]] = None):
        """Advance the schedule; adjust lambda; write stage checkpoints."""
        st = self.state
        epoch = st.epoch_for_strategy
        stage, _ = self.strategy.stage_at(epoch)
        if val_metrics is not None and stage != "feat_wo_bpp":
            st.lmbda_idx = self.strategy.adjust_lmbda_idx(
                epoch, st.lmbda_idx, val_metrics["val/bpp"])
        next_stage, next_spec = self.strategy.stage_at(epoch + 1)
        if next_stage != stage:
            if self.ckpt_dir:
                save_checkpoint(self.ckpt_dir, st,
                                f"{stage}_epo_for_strategy_{epoch}")
            # a stage change resets the lambda schedule (reference: :571-575)
            # and re-arms the rate floor at the new stage's band edge
            st.lmbda_idx = next_spec.init_lmbda_idx
            st.lmbda_list = tuple(next_spec.lmbda_list)
            st.rate_floor = float(np.float32(next_spec.bpp_lower))
        st.epoch_for_strategy = epoch + 1

    @torch.no_grad()
    def log_images(self, batch) -> Dict[str, torch.Tensor]:
        """Reconstruction pairs for an image logger
        (reference: codec_sq_fixbpp.py:832-838)."""
        out = self.model(self._batch(batch), need_full_decode=True)
        return {"x": out["x"], "x_hat": out["x_hat"]}

    def fit(self, train_data_fn, val_data_fn, epochs: Optional[int] = None):
        total = epochs if epochs is not None else (
            self.strategy.total_epochs - self.state.epoch_for_strategy)
        for _ in range(total):
            t0 = time.time()
            stage = self.train_epoch(train_data_fn())
            val = self.validate(val_data_fn()) if val_data_fn else None
            self.end_of_epoch(val)
            self.log_fn({"epoch_done": self.state.epoch_for_strategy - 1,
                         "stage": stage, "epoch_s": time.time() - t0,
                         **({f"mean_{k}": v for k, v in val.items()} if val else {})})
        if self.ckpt_dir:
            save_checkpoint(self.ckpt_dir, self.state, "last")


def reset_schedule(state: TrainState, strategy: TrainingStrategy) -> None:
    """Restart the stage schedule of a resumed state (the reference's
    ``ignore_keys=['epoch_for_strategy', 'lmbda_idx', 'lmbda_list']``)."""
    state.epoch_for_strategy = strategy.start_epoch
    _, spec = strategy.stage_at(strategy.start_epoch)
    state.lmbda_idx, state.lmbda_list = spec.init_lmbda_idx, tuple(spec.lmbda_list)
