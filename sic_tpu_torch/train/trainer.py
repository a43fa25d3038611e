"""Host-side training loop: stage schedule, rate control, checkpoints.

Counterpart of the JAX package's ``train/trainer.py`` (reference:
codec_sq_fixbpp.py:554-593, 608-639): the epoch loop with per-epoch stage
selection, the validation-bpp lambda controller, stage-transition
checkpoints and the final ``last``.  Checkpoints are ``torch.save`` files
under the JAX package's names (``<stage>_epo_for_strategy_<epoch>``,
``last``) holding the models, both optimizers, the schedule and the noise
generator.

Across processes (``create_train_state(data=..., pp=...)``) the trainer is
the JAX package's multi-host one: every rank walks the same batch
sequence and takes its contiguous block of each batch (``data``);
validation and the lambda controller see the global batch's means, so
every rank makes the same decisions; checkpoints are written by global
rank 0 between barriers (under ``pp`` gathered from the stages into the
whole model's layout first); a barrier closes every epoch.

On a process grid (``create_train_state(mesh=..., fsdp=...)``: the JAX
CLI's ``--tp``, ``--tile`` and ``--fsdp``) each rank holds its heads of the
split blocks (``model``), its width slab of every batch (``tile``) and,
with ``fsdp``, its chunks of the large leaves and their Adam moments
(``data``); checkpoints and deployment parameters are gathered into the
one-process layout, and a resumed checkpoint is cut back to the rank's.
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
from ..models.hybrid import is_cell_leaf
from ..models.lpips import LPIPS, load_lpips_weights
from ..parallel.mesh import (FSDP, Layout, apply_tp, named_leaves,
                             param_names, shard_batch, tp_plan)
from ..parallel.multihost import (barrier, gather_to_first, global_rank,
                                  take_rows)
from ..weights import export_flax_params, init_seeded, load_flax_params
from .state import (TrainState, cast_frozen_params, is_frozen_path,
                    make_optimizer, named_codec_params, partition)
from .steps import EVAL_LOGS, FeatLossCfg, ImgLossCfg, TrainSteps
from .strategy import TrainingStrategy


def create_train_state(spec: CodecSpec, strategy: TrainingStrategy,
                       seed: int = 0, feat_cfg: FeatLossCfg = FeatLossCfg(),
                       img_cfg: ImgLossCfg = ImgLossCfg(), codec_params=None,
                       device=None, lpips_lin: Optional[str] = None,
                       lpips_vgg: Optional[str] = None, tune_titok: bool = False,
                       dtype: Optional[torch.dtype] = None,
                       mu_dtype: Optional[torch.dtype] = None,
                       frozen_dtype: Optional[torch.dtype] = None,
                       donate: bool = False, data=None, pp=None,
                       mesh=None, fsdp: bool = False):
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
    JAX's buffer donation buys.

    Across processes: ``data`` is the data group
    (:class:`~sic_tpu_torch.parallel.multihost.Group`) the global batch is
    split over, which the steps and the discriminator's statistics reduce
    over; ``pp`` a :class:`~sic_tpu_torch.models.hybrid.PPConfig`, whose
    stage keeps only its trunk cells (their parameters, gradients and Adam
    moments) after the whole model is initialised or loaded.

    On a process grid: ``mesh`` (:class:`~sic_tpu_torch.parallel.mesh.Mesh`
    over ``data``, ``model`` and ``tile``; its data group replaces
    ``data``) splits the model's attention and MLP blocks over ``model``
    (:func:`~sic_tpu_torch.parallel.mesh.apply_tp`) and the batches' width
    over ``tile``; ``fsdp`` keeps each rank's chunks of the codec's and the
    discriminator's leaves that the JAX package's FSDP rule splits over the
    data group (``tp_plan`` / ``fsdp_plan``; under ``pp`` the stage's own
    trunk cells stay whole, as ``pp_sharding`` leaves them).  Returns
    (model, state, steps)."""
    del donate
    steps = TrainSteps(feat_cfg, img_cfg)     # a bad flag fails before the build
    if mesh is not None:
        data = mesh.data
    dev = resolve_device(device)
    configure_numerics()
    with torch.device(dev):
        model = Codec(spec, dtype, pp)
        disc = NLayerDiscriminator(img_cfg.disc_ndf, img_cfg.disc_num_layers)
        lpips = LPIPS()
    if codec_params is None:
        init_seeded(model, seed)
    else:
        stray = load_flax_params(model, codec_params)
        if stray:
            raise ValueError(f"{len(stray)} leaves fit no parameter, e.g. "
                             f"{sorted(stray)[:3]}")
    full_trainable = ()
    if pp is not None:
        full_trainable = tuple("/".join(path) for path, _ in named_codec_params(model)
                               if not is_frozen_path(path, tune_titok))
        model.prune_to_stage()
    gens = [torch.Generator(device=dev).manual_seed(seed + i) for i in (1, 2, 3)]
    disc.init_weights(gens[0])
    disc.set_data_group(data)
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
    layout, shards = _shard(model, disc, mesh if mesh is not None else
                            _data_mesh(data), fsdp, pp is not None)
    _, stage0 = strategy.stage_at(strategy.start_epoch)
    state = TrainState(
        model=model, disc=disc, lpips=lpips, trainable=trainable,
        opt_ae=make_optimizer([p for _, p in trainable], strategy.learning_rate,
                              mu_dtype),
        opt_disc=make_optimizer(disc.parameters(), strategy.learning_rate),
        generator=gens[2], epoch_for_strategy=strategy.start_epoch,
        lmbda_idx=stage0.init_lmbda_idx, lmbda_list=tuple(stage0.lmbda_list),
        rate_floor=float(np.float32(stage0.bpp_lower)),
        data=data, pipe=pp, full_trainable=full_trainable, mesh=mesh,
        layout=layout, fsdp=shards)
    return model, state, steps


def _data_mesh(data):
    """A grid of the data group alone (the ``--pp`` runs' FSDP)."""
    from ..parallel.mesh import Mesh
    return None if data is None else Mesh((("data", data.size),), {"data": data})


def _shard(model, disc, mesh, fsdp: bool, pp: bool = False):
    """Split ``model`` over the mesh's model group and, with ``fsdp``, the
    large leaves of ``model`` and ``disc`` over its data group (under
    ``pp`` not the stage's trunk cells); returns the :class:`Layout` of the
    checkpoint's names and {"model", "disc"} -> :class:`FSDP`."""
    layout, shards = Layout(), {}
    if mesh is None:
        return layout, shards
    layout.model, layout.data = mesh.model, (mesh.data if fsdp else None)
    n_data = mesh.size("data") if fsdp else 1
    for part, module in (("model", model), ("disc", disc)):
        plan = tp_plan(module, mesh.size("model") if part == "model" else 1, n_data)
        dims = {tname: plan[key][1] for key, tname, *_ in named_leaves(module)
                if not (pp and is_cell_leaf(tname))}
        if part == "model":
            layout.tp.update({f"model.{k}": v
                              for k, v in apply_tp(module, mesh.model).items()})
        if fsdp and mesh.data is not None:
            shards[part] = FSDP(module.named_parameters(), dims, mesh.data)
            layout.fsdp.update({f"{part}.{k}": d for k, d in shards[part].dims.items()})
    return layout, shards


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    return obj


def _own_names(state: TrainState):
    return ["/".join(path) for path, _ in state.trainable]


def _gather_cells(mine, state: TrainState):
    """The stages' own cells' leaves (``mine`` maps name -> leaf), merged
    into stage 0's ``mine`` on stage 0 (None on the others): the other
    stages send their trunk cells' leaves, on the host; the rest of a
    stage is the same on every stage.  Collective over the stages."""
    part = None if state.pipe.stage == 0 else \
        {k: _cpu(v) for k, v in mine.items() if is_cell_leaf(k)}
    parts = gather_to_first(part, state.pipe.group)
    if parts is None:
        return None
    for p in parts[1:]:
        mine.update(p)
    return mine


def _opt_names(state: TrainState):
    """For each optimizer, its parameter index -> layout name."""
    names = param_names(state.model, "model.") | param_names(state.disc, "disc.")
    return {opt: {i: names[id(p)] for i, p in enumerate(
        p for g in getattr(state, opt).param_groups for p in g["params"])}
        for opt in ("opt_ae", "opt_disc")}


def _relayout(sd: dict, state: TrainState, convert) -> dict:
    """``sd`` (a state dict) with every split leaf and its Adam moments
    passed through ``convert(name, tensor)``, in one order on every rank."""
    layout = state.layout
    for part in ("model", "disc"):
        sd[part] = {k: convert(f"{part}.{k}", v) if f"{part}.{k}" in layout.tp
                    or f"{part}.{k}" in layout.fsdp else v
                    for k, v in sd[part].items()}
    for opt, names in _opt_names(state).items():
        st = sd[opt]["state"]
        for i in sorted(st):
            n = names[i]
            if n in layout.tp or n in layout.fsdp:
                st[i] = {k: convert(n, v) if isinstance(v, torch.Tensor) and v.dim()
                         else v for k, v in st[i].items()}
    return sd


def gathered_state_dict(state: TrainState) -> Optional[dict]:
    """``state.state_dict()`` in the one-process layout: the split leaves
    and their Adam moments gathered (collective over the mesh), and under
    ``pp`` the whole model's, on the first stage (None on the others):
    every stage's model leaves, and Adam's state re-indexed to the whole
    model's trainable order, so the file loads into a run with or without
    ``pp``.  Collective over the stages (and the data and model ranks
    under a layout)."""
    sd = state.state_dict()
    if state.layout:
        sd = _relayout(sd, state, state.layout.full)
    if state.pipe is None:
        return sd
    if state.data is not None and state.data.index != 0:
        return None
    names = _own_names(state)
    model = _gather_cells(sd["model"], state)
    opt = _gather_cells({names[i]: st for i, st in sd["opt_ae"]["state"].items()},
                        state)
    if model is None:
        return None
    full = state.full_trainable
    sd["model"] = model
    sd["opt_ae"] = {
        "state": {i: opt[n] for i, n in enumerate(full) if n in opt},
        "param_groups": [dict(g, params=list(range(len(full))))
                         for g in sd["opt_ae"]["param_groups"]]}
    return sd


def gathered_flax_params(state: TrainState) -> Optional[dict]:
    """The codec's flat ``params/...`` dict (:func:`export_flax_params`)
    in the one-process layout; under ``pp`` every stage's leaves, on the
    first stage of the first data index (None elsewhere).  Collective over
    the stages (and the mesh's ranks under a layout)."""
    if state.layout:
        named = [(f"model.{n}", p) for n, p in state.model.named_parameters()]
        with state.layout.whole_params(named):
            flat = export_flax_params(state.model)
    else:
        flat = export_flax_params(state.model)
    if state.pipe is None:
        return flat
    if state.data is not None and state.data.index != 0:
        return None
    return _gather_cells(flat, state)


def save_checkpoint(ckpt_dir, state: TrainState, name: str) -> str:
    """Write ``state`` as ``<ckpt_dir>/<name>``.  Across processes every
    rank calls it: the ranks gather their state, global rank 0 writes,
    and all wait at a barrier until it has."""
    path = Path(ckpt_dir).resolve() / name
    sd = gathered_state_dict(state)
    if global_rank() == 0:
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(sd, path)
    barrier(f"checkpoint {name}")
    return str(path)


def _stage_view(ck: dict, state: TrainState) -> dict:
    """A whole model's checkpoint cut to this stage's leaves."""
    own = state.model.state_dict()
    ck = dict(ck, model={k: v for k, v in ck["model"].items() if k in own})
    index = {n: i for i, n in enumerate(_own_names(state))}
    opt = ck["opt_ae"]
    ck["opt_ae"] = {
        "state": {index[n]: opt["state"][i] for i, n in enumerate(state.full_trainable)
                  if n in index and i in opt["state"]},
        "param_groups": [dict(g, params=list(range(len(index))))
                         for g in opt["param_groups"]]}
    return ck


def load_checkpoint(path, state: TrainState) -> TrainState:
    """Restore a :func:`save_checkpoint` file into ``state`` (in place);
    under ``pp`` this stage's part of it, under a layout this rank's
    chunks and heads of it."""
    if state.pipe is None:
        ck = torch.load(path, map_location=state.device, weights_only=False)
    else:
        ck = _stage_view(torch.load(path, map_location="cpu", weights_only=False),
                         state)
    if state.layout:
        ck = _relayout(ck, state, state.layout.local)
    state.load_state_dict(ck)
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
        """This rank's rows (and, on a mesh, its width slab) of a global
        batch, on the device."""
        x = np.asarray(batch, np.float32)
        part = shard_batch(x, self.state.mesh) if self.state.mesh is not None \
            else take_rows(x, self.state.data)
        return torch.as_tensor(np.ascontiguousarray(part), device=self.state.device)

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
        """Means over the batches of each batch's eval logs.  Across
        processes a batch's log is the mean over its rows (each rank's
        batch mean weighted by its share of the rows), summed over the
        ranks once at the end: every rank gets the one-process means."""
        st = self.state
        sums = dict.fromkeys(EVAL_LOGS, 0.0)
        n = 0
        for batch in val_data:
            x = self._batch(batch)
            if len(x):
                w = len(x) / len(batch)
                for k, v in self.steps.eval_step(st, x).items():
                    sums[k] += w * float(v)
            n += 1
        if st.data is not None:
            import torch.distributed as dist
            vec = torch.tensor([sums[k] for k in EVAL_LOGS], dtype=torch.float64,
                               device=st.device)
            dist.all_reduce(vec, group=st.data.group)
            sums = dict(zip(EVAL_LOGS, vec.tolist()))
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
        with self.state.step_scope():
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
            # re-align the ranks: rank 0's checkpoints and logs must not let
            # the others run minutes ahead into a collective's timeout
            barrier(f"epoch_{self.state.epoch_for_strategy}")
        if self.ckpt_dir:
            save_checkpoint(self.ckpt_dir, self.state, "last")


def reset_schedule(state: TrainState, strategy: TrainingStrategy) -> None:
    """Restart the stage schedule of a resumed state (the reference's
    ``ignore_keys=['epoch_for_strategy', 'lmbda_idx', 'lmbda_list']``)."""
    state.epoch_for_strategy = strategy.start_epoch
    _, spec = strategy.stage_at(strategy.start_epoch)
    state.lmbda_idx, state.lmbda_list = spec.init_lmbda_idx, tuple(spec.lmbda_list)
