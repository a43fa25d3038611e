"""train CLI: the three-stage schedule on one device.

    python -m sic_tpu_torch.cli.train --train_dir IMGS [--val_dir IMGS]
        [--base_config CONFIG.yaml | --qp 0..3 [--tiny]]
        [--train_px 256|512] [--batch_size 2] [--epochs N]
        [--ckpt_dir ./ckpts] [--resume CKPT] [--reset_schedule]
        [--perceptual lpips|msssim|none] [--lpips_lin vgg.pth]
        [--lpips_vgg vgg16.pth] [--tiny] [--insert_pos ...] [--seed 0]
        [--device cuda] [--log_dir LOGS] [--f32_frozen] [--no_donate]

Drives ``feat_wo_bpp`` -> ``feat`` -> ``pix`` from a reference-layout YAML
(its spec, training strategy, loss configs, ``tune_titok`` and
``save_mem``, which recomputes the trunk and cross blocks in the backward)
or a QP preset (the 512-px presets start in ``pix``) with the
validation-bpp lambda controller, writes
``torch.save`` checkpoints into ``--ckpt_dir`` at every stage change and at
the end (``last``), and finally ``deploy_params.npz``: the codec's
parameters in the flat ``params/...`` layout (f32) that the compress and
decompress CLIs read with ``--ckpt_path``.

On CUDA it trains as the JAX CLI trains on an accelerator: Adam's first
moments and the frozen backbones stored in bf16 (``--f32_frozen`` keeps
the backbones in f32); on the CPU both stay f32.  The codec computes in
f32 in both, as the JAX CLI's does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

_NOT_YET = ("Not offered yet (ROADMAP queue 1 item 10): --world_size/--rank/"
            "--coordinator, --tp/--tile/--fsdp/--pp: this trains in one "
            "process on one device.")


def accelerator_dtypes(device, f32_frozen: bool = False):
    """(mu_dtype, frozen_dtype) of the JAX CLI's rule (``on_tpu =
    platform != "cpu"``): bf16 Adam moments and bf16 frozen storage on an
    accelerator (here CUDA), unless ``f32_frozen`` for the latter; None
    (f32) for both on the CPU."""
    on_accel = torch.device(device if device is not None else "cuda").type != "cpu"
    mu = torch.bfloat16 if on_accel else None
    frozen = None if (f32_frozen or not on_accel) else torch.bfloat16
    return mu, frozen


def main(argv=None):
    ap = argparse.ArgumentParser(description="sic_tpu_torch train", epilog=_NOT_YET)
    ap.add_argument("--base_config", default=None,
                    help="reference-layout training YAML (spec, strategy, "
                         "loss configs, tune_titok); excludes --qp and --tiny")
    ap.add_argument("--qp", type=int, default=None, choices=(0, 1, 2, 3),
                    help="rate preset instead of a YAML (default 0)")
    ap.add_argument("--train_px", type=int, default=256, choices=(256, 512))
    ap.add_argument("--train_list", help="txt file of training image paths")
    ap.add_argument("--val_list")
    ap.add_argument("--train_dir", help="image directory alternative to --train_list")
    ap.add_argument("--val_dir")
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--ckpt_dir", default="./ckpts")
    ap.add_argument("--log_dir", default=None,
                    help="write TensorBoard event files and scalars.jsonl "
                         "here (reference: Lightning's TB logger)")
    ap.add_argument("--resume", default=None,
                    help="training checkpoint to resume, or a params .npz "
                         "(deploy_params.npz) for a params-only warm start")
    ap.add_argument("--reset_schedule", action="store_true",
                    help="resume weights but restart the stage schedule")
    ap.add_argument("--perceptual", default=None, choices=("lpips", "msssim", "none"),
                    help="pix-stage perceptual term (default lpips; msssim "
                         "needs no VGG16 checkpoint)")
    ap.add_argument("--lpips_lin", help="torch checkpoint of the LPIPS "
                    "calibration heads (vgg.pth)")
    ap.add_argument("--lpips_vgg", help="torchvision VGG16 state dict")
    ap.add_argument("--tiny", action="store_true", help="tiny spec for smoke runs")
    ap.add_argument("--insert_pos", type=int, nargs="+", default=None,
                    help="trunk cross-attention insert positions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--no_donate", action="store_true",
                    help="accepted as the JAX CLI's flag; PyTorch updates "
                         "the state in place, with or without it")
    ap.add_argument("--f32_frozen", action="store_true",
                    help="keep the frozen backbones in f32 (default bf16 "
                         "on CUDA)")
    args = ap.parse_args(argv)

    from ..config import flagship_spec, load_config, qp_strategy, tiny_spec
    from ..data import ImageDataset
    from ..train import (FeatLossCfg, ImgLossCfg, Trainer, create_train_state,
                         load_checkpoint)
    from ..train.trainer import reset_schedule
    from ..weights import export_flax_params, load_npz

    if args.base_config:
        if args.tiny or args.qp is not None:
            ap.error("--base_config names the model and the strategy: give "
                     "it without --tiny and --qp")
        cfg = load_config(args.base_config)
        if cfg.strategy is None:
            ap.error(f"{args.base_config} has no training_strategy")
        spec, strategy = cfg.spec, cfg.strategy
        feat_cfg, img_cfg, tune_titok = cfg.feat_cfg, cfg.img_cfg, cfg.tune_titok
    else:
        spec = tiny_spec() if args.tiny else flagship_spec()
        strategy = qp_strategy(args.qp or 0, args.train_px)
        feat_cfg, img_cfg, tune_titok = FeatLossCfg(), ImgLossCfg(), False
    if args.insert_pos is not None:
        spec = dataclasses.replace(spec, insert_pos_enc=tuple(args.insert_pos),
                                   insert_pos_dec=tuple(args.insert_pos))
    if args.perceptual is not None:
        img_cfg = dataclasses.replace(img_cfg, perceptual=args.perceptual)
    print(f"[train] perceptual mode: {img_cfg.perceptual}"
          + ("" if img_cfg.perceptual != "lpips" or args.lpips_vgg
             else " (UNCALIBRATED: no --lpips_vgg)"), file=sys.stderr)

    if args.train_list:
        train_ds = ImageDataset.from_list_file(args.train_list, args.train_px, True)
    elif args.train_dir:
        train_ds = ImageDataset.from_dir(args.train_dir, args.train_px, True)
    else:
        ap.error("need --train_list or --train_dir")
    val_ds = None
    if args.val_list:
        val_ds = ImageDataset.from_list_file(args.val_list, args.train_px, False)
    elif args.val_dir:
        val_ds = ImageDataset.from_dir(args.val_dir, args.train_px, False)

    mu_dtype, frozen_dtype = accelerator_dtypes(args.device, args.f32_frozen)
    model, state, steps = create_train_state(
        spec, strategy, args.seed, feat_cfg=feat_cfg, img_cfg=img_cfg,
        device=args.device, lpips_lin=args.lpips_lin, lpips_vgg=args.lpips_vgg,
        tune_titok=tune_titok, mu_dtype=mu_dtype, frozen_dtype=frozen_dtype,
        donate=not args.no_donate)
    if args.resume:
        if str(args.resume).endswith(".npz"):
            # params-only warm start: optimizer and schedule start fresh
            stray = load_npz(model, args.resume)
            if stray:
                raise ValueError(f"{len(stray)} leaves of {args.resume} fit "
                                 "no parameter")
            print(f"[train] params-only warm start from {args.resume}",
                  file=sys.stderr)
        else:
            load_checkpoint(args.resume, state)
        if args.reset_schedule:
            reset_schedule(state, strategy)

    writer = None
    if args.log_dir:
        from ..utils.tb_writer import MetricsWriter
        writer = MetricsWriter(args.log_dir)
        tb_log = writer.as_log_fn()

    def log_fn(d):
        print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                          for k, v in d.items()}), file=sys.stderr, flush=True)
        if writer is not None:
            tb_log(d)

    trainer = Trainer(model, state, steps, strategy, ckpt_dir=args.ckpt_dir,
                      log_fn=log_fn)

    def train_data():
        return train_ds.batches(args.batch_size, epoch=state.epoch_for_strategy)

    def val_data():
        return val_ds.batches(args.batch_size, shuffle=False)

    try:
        trainer.fit(train_data, val_data if val_ds else None, epochs=args.epochs)
    finally:
        if writer is not None:
            writer.close()
    deploy = Path(args.ckpt_dir) / "deploy_params.npz"
    np.savez(deploy, **export_flax_params(model))
    print(f"[train] deployment params -> {deploy}", file=sys.stderr)
    print(f"[OK] training done; checkpoints in {args.ckpt_dir}", file=sys.stderr)
    return {"ckpt_dir": str(args.ckpt_dir), "deploy_params": str(deploy),
            "global_step": state.global_step,
            "epoch_for_strategy": state.epoch_for_strategy,
            "mu_dtype": str(mu_dtype), "frozen_dtype": str(frozen_dtype),
            "remat": spec.remat}


if __name__ == "__main__":
    main()
