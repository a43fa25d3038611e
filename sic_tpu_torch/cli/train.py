"""train CLI: the three-stage schedule, in one process or several.

    python -m sic_tpu_torch.cli.train --train_dir IMGS [--val_dir IMGS]
        [--base_config CONFIG.yaml | --qp 0..3 [--tiny]]
        [--train_px 256|512] [--batch_size 2] [--epochs N]
        [--ckpt_dir ./ckpts] [--resume CKPT] [--reset_schedule]
        [--perceptual lpips|msssim|none] [--lpips_lin vgg.pth]
        [--lpips_vgg vgg16.pth] [--tiny] [--insert_pos ...] [--seed 0]
        [--device cuda] [--log_dir LOGS] [--f32_frozen] [--no_donate]
        [--world_size N --rank R --coordinator HOST:PORT]
        [--pp P [--pp_microbatch M]] [--tp T] [--tile S] [--fsdp]

Across processes (``--world_size``, ``--rank``, ``--coordinator``, by
default ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR:MASTER_PORT``) the
processes form a (world/pp, pp) grid: data parallelism over the first axis
(each rank takes its contiguous block of every batch; batch means and
statistics are the global batch's), GPipe over the second (``--pp``: the
hybrid trunks' cells split into pipeline stages, ``--pp_microbatch``
microbatches, one a stage by default; a partial final batch is dropped).
With ``--tp`` / ``--tile`` the grid is (world/(tp*tile) data) x (tp model)
x (tile tile), the JAX CLI's mesh over processes: ``--tp`` splits the
attention and MLP blocks head-aligned over ``model``, ``--tile`` the
images' width over ``tile`` (``parallel/mesh.py``); ``--fsdp`` keeps each
data rank's chunks of the large leaves and their Adam moments, with or
without ``--pp``.  Unlike the JAX CLI, whose mesh is one process's
devices, these flags compose with ``--world_size``: the ranks are
processes, one card each or sharing one.
Only rank 0 logs and writes files.  Each rank runs on
``cuda:(LOCAL_RANK or rank) % device_count`` unless ``--device`` names
one; ranks sharing a card talk over gloo, one card a rank over NCCL.

Drives ``feat_wo_bpp`` -> ``feat`` -> ``pix`` from a reference-layout YAML
(its spec, training strategy, loss configs, ``tune_titok`` and
``save_mem``, which recomputes the trunk and cross blocks in the backward)
or a QP preset (the 512-px presets start in ``pix``) with the
validation-bpp lambda controller, writes
``torch.save`` checkpoints into ``--ckpt_dir`` at every stage change and at
the end (``last``), and finally ``deploy_params.npz``: the codec's
parameters in the flat ``params/...`` layout (f32) that the compress and
decompress CLIs read with ``--ckpt_path`` (under ``--pp``, ``--tp``,
``--tile`` and ``--fsdp`` gathered into the one-process layout; not
written by a run that is only data-parallel across processes, as the JAX
CLI writes it from every run but a multi-host data-parallel one).

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
    ap = argparse.ArgumentParser(description="sic_tpu_torch train")
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
    ap.add_argument("--world_size", type=int, default=None,
                    help="processes (default: WORLD_SIZE env)")
    ap.add_argument("--rank", type=int, default=None,
                    help="this process's rank (default: RANK env)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 "
                         "(default: MASTER_ADDR:MASTER_PORT env)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks: the attention and MLP "
                         "blocks split head-aligned over a 'model' axis")
    ap.add_argument("--tile", type=int, default=1,
                    help="spatial-parallel ranks: the images' width split "
                         "over a 'tile' axis (convolution halos exchanged)")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-shard the large leaves and their Adam moments "
                         "over the data axis (gathered for each step)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages: the hybrid trunks' cells split "
                         "over --pp processes (GPipe); the rest of the "
                         "processes carry data parallelism")
    ap.add_argument("--pp_microbatch", type=int, default=None,
                    help="pipeline microbatches (default: pp stages)")
    args = ap.parse_args(argv)
    if args.pp > 1 and (args.tp > 1 or args.tile > 1):
        ap.error("--pp composes with data parallelism; not with --tp/--tile")

    from ..config import flagship_spec, load_config, qp_strategy, tiny_spec
    from ..data import ImageDataset
    from ..models.hybrid import PPConfig, cell_partition
    from ..parallel import (barrier, codec_params_canonicalize, grid_groups,
                            make_mesh, rank_device, setup_distributed, shutdown)
    from ..parallel.multihost import resolve_world
    from ..train import (FeatLossCfg, ImgLossCfg, Trainer, create_train_state,
                         load_checkpoint)
    from ..train.trainer import gathered_flax_params, reset_schedule

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

    # the process grid: (world/pp data) x (pp pipe), checked before any
    # rank waits for the others
    rank, world, _ = resolve_world(args.rank, args.world_size, args.coordinator)
    data_ways = world
    if args.pp > 1:
        # both trunks must partition: a YAML may set in_pos_dec apart from
        # in_pos_enc
        n_cells = None
        for side, ipos in (("encoder", spec.insert_pos_enc),
                           ("decoder", spec.insert_pos_dec)):
            n = spec.titok.num_layers // cell_partition(spec.titok.num_layers,
                                                        ipos)
            if n % args.pp:
                ap.error(f"{side} trunk has {n} pipeline cells; --pp must "
                         f"divide it (got {args.pp})")
            n_cells = n if side == "encoder" else n_cells
        if world % args.pp:
            ap.error(f"{world} processes not divisible by pp={args.pp}")
        data_ways = world // args.pp
        mb = args.pp_microbatch or args.pp
        per_mb = args.batch_size // mb if args.batch_size % mb == 0 else 0
        if not per_mb or per_mb % data_ways:
            ap.error(f"--batch_size {args.batch_size} must be a multiple of "
                     f"microbatches*data = {mb}*{data_ways} "
                     "(each microbatch shards over the data axis)")
    elif args.tp > 1 or args.tile > 1:
        ways = args.tp * args.tile
        if world % ways:
            ap.error(f"{world} processes not divisible by tp*tile={ways}")
        data_ways = world // ways
        if args.batch_size % data_ways:
            ap.error(f"--batch_size {args.batch_size} must divide by the "
                     f"data-axis size {data_ways}")
        if args.train_px % args.tile:
            ap.error(f"--train_px {args.train_px} must divide by --tile "
                     f"{args.tile}")
    elif world > 1 and args.batch_size % world:
        ap.error(f"--batch_size {args.batch_size} must divide by "
                 f"world_size {world}")
    device = args.device if world == 1 else rank_device(rank, args.device)
    rank, world = setup_distributed(rank, world, args.coordinator, device,
                                    placed=args.device is None)
    mesh = None
    if args.pp > 1 or not (args.tp > 1 or args.tile > 1 or args.fsdp):
        data, pipe = grid_groups(args.pp)
    else:
        mesh = make_mesh((data_ways, args.tp, args.tile), ("data", "model", "tile"))
        data, pipe = mesh.data, None
        print(f"[train] mesh {dict(mesh.shape)}"
              + (" + ZeRO over data" if args.fsdp else ""), file=sys.stderr)
    pp_cfg = None
    if args.pp > 1:
        pp_cfg = PPConfig(pipe, args.pp_microbatch)
        print(f"[train] pipeline parallel: {args.pp} stages x "
              f"{data_ways} data, {n_cells} cells", file=sys.stderr)
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

    mu_dtype, frozen_dtype = accelerator_dtypes(device, args.f32_frozen)
    warm = None
    if args.resume and str(args.resume).endswith(".npz"):
        # params-only warm start: optimizer and schedule start fresh; a
        # stacked trunk_cells npz (a JAX --pp run's) is converted first
        with np.load(args.resume) as z:
            warm = codec_params_canonicalize({k: z[k] for k in z.files}, spec)
    model, state, steps = create_train_state(
        spec, strategy, args.seed, feat_cfg=feat_cfg, img_cfg=img_cfg,
        codec_params=warm, device=device, lpips_lin=args.lpips_lin,
        lpips_vgg=args.lpips_vgg, tune_titok=tune_titok, mu_dtype=mu_dtype,
        frozen_dtype=frozen_dtype, donate=not args.no_donate, data=data,
        pp=pp_cfg, mesh=mesh, fsdp=args.fsdp)
    if args.resume:
        if warm is not None:
            print(f"[train] params-only warm start from {args.resume}",
                  file=sys.stderr)
        else:
            load_checkpoint(args.resume, state)
        if args.reset_schedule:
            reset_schedule(state, strategy)

    writer = None
    if args.log_dir and rank == 0:
        from ..utils.tb_writer import MetricsWriter
        writer = MetricsWriter(args.log_dir)
        tb_log = writer.as_log_fn()

    def log_fn(d):
        print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                          for k, v in d.items()}), file=sys.stderr, flush=True)
        if writer is not None:
            tb_log(d)

    # the logs are global means on every rank; rank 0 alone prints them
    trainer = Trainer(model, state, steps, strategy, ckpt_dir=args.ckpt_dir,
                      log_fn=log_fn if rank == 0 else (lambda d: None))

    # a pipeline splits every batch into equal microbatches: a partial final
    # batch is dropped, as GPipe schedulers drop it
    def full(batches):
        return (b for b in batches
                if pp_cfg is None or len(b) == args.batch_size)

    def train_data():
        return full(train_ds.batches(args.batch_size,
                                     epoch=state.epoch_for_strategy))

    def val_data():
        return full(val_ds.batches(args.batch_size, shuffle=False))

    try:
        trainer.fit(train_data, val_data if val_ds else None, epochs=args.epochs)
    finally:
        if writer is not None:
            writer.close()
    deploy = None
    if world == 1 or args.pp > 1 or mesh is not None:
        # as the JAX CLI: from every run but a multi-host data-parallel one
        # (its --pp and mesh runs are one process); the named layout the
        # deploy CLIs load, gathered from the stages, heads and chunks
        flat = gathered_flax_params(state)
        if rank == 0:
            deploy = Path(args.ckpt_dir) / "deploy_params.npz"
            np.savez(deploy, **flat)
            print(f"[train] deployment params -> {deploy}", file=sys.stderr)
    # align the ranks before exit: rank 0's trailing writes must land first
    barrier("end_of_training")
    shutdown()
    if rank == 0:
        print(f"[OK] training done; checkpoints in {args.ckpt_dir}",
              file=sys.stderr)
    return {"ckpt_dir": str(args.ckpt_dir),
            "deploy_params": None if deploy is None else str(deploy),
            "rank": rank, "world": world, "pp": args.pp, "tp": args.tp,
            "tile": args.tile, "fsdp": args.fsdp,
            "global_step": state.global_step,
            "epoch_for_strategy": state.epoch_for_strategy,
            "mu_dtype": str(mu_dtype), "frozen_dtype": str(frozen_dtype),
            "remat": spec.remat}


if __name__ == "__main__":
    main()
