"""compress CLI: images -> searchable ``.c2df`` bitstreams + vector index.

    python -m sic_tpu_torch.cli.compress --dataset_dir DIR --save_dir OUT
        [--ckpt_path params.npz] [--clip_ckpt open_clip.pt]
        [--base_config CONFIG.yaml | --spec flagship|small|tiny]
        [--device cuda | --gpu_idx N] [--dtype auto|float32|bfloat16]
        [--quant none|int8] [--batch_size 8] [--stream_part 4] [--bpe_path merges.txt.gz]
        [--world_size N --rank R --coordinator HOST:PORT]

Same output layout as the reference's compress script (reference:
src/compress.py:203-333): per image pad to 256 (replicate),
``encode_only_batched`` per padded-shape bucket, CLIP embed + u8/zstd pack,
``pack_c2df`` into ``OUT/bitstreams``, raw clip vecs into ``OUT/clip_vecs``
and a flat-IP index in both FAISS layouts into ``OUT/faiss``.

Across processes (``--world_size``, ``--rank``, ``--coordinator``, by
default ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR:MASTER_PORT``; the
reference's torchrun variables) each rank encodes its share into the
shared ``OUT``, and after a barrier rank 0 builds the index from every
rank's files.  The share is a set of whole device batches: every rank
plans the one-process run's batches (padded-shape buckets, in image
order) and takes every ``world``-th, so each batch, and each stream's
bytes, is what one process would make (a batched network pass rounds
differently at another batch size or membership).  The JAX CLI splits by
image instead (``shard_list``), which its batch-invariant device passes
allow.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..container import pack_c2df
from ..data import list_images, load_image
from ..models import get_padding_size, pad_replicate
from ..retrieval import VectorIndex
from ._common import (add_device_args, add_dtype_arg, add_quant_arg, cli_config,
                      cli_device, init_func, load_clip_codec, load_runtime,
                      progress)


def c2df_header(rt, clip_meta: dict, hw, pads) -> dict:
    """The ``.c2df`` header of one encoded image (the service writes the
    same): CLIP metadata, the image size and padding, the semantic
    stream's wire format and the h stream's coding contract."""
    return {
        "version": 2,
        "model_id": clip_meta.get("model_id", ""),
        "embed_dim": int(clip_meta.get("dim", 0)),
        "quant_type": clip_meta.get("quant", "u8_symmetric_-1_1"),
        "image_hw": [int(hw[0]), int(hw[1])],
        "padding": [int(p) for p in pads],
        # wire format of the semantic stream
        "z_coder": rt.z_format,
        # h-stream coding contract: a decode replays the chain at this
        # coding batch
        "coding_batch": rt.h_coder.coding_batch,
    }


def build_index_from_saved(save_dir, model_id: str = "") -> int:
    """Rebuild the flat-IP index from every clip vec saved under
    ``save_dir`` that has its bitstream, in sorted name order (reference:
    compress.py:295-306)."""
    save_dir = Path(save_dir)
    bit_dir, clip_dir, index_dir = (save_dir / "bitstreams",
                                    save_dir / "clip_vecs",
                                    save_dir / "faiss")
    db = None
    count = 0
    for npy in sorted(clip_dir.glob("*.npy")):
        doc_id = bit_dir / f"{npy.stem}.c2df"
        if not doc_id.exists():
            continue
        vec = np.load(npy)
        if db is None:
            db = VectorIndex(dim=int(vec.shape[0]))
        db.add(vec, str(doc_id))
        count += 1
    if db is not None:
        db.persist(index_dir, meta={"dim": db.dim, "metric": "ip",
                                    "model_id": model_id})
    return count


def plan_batches(paths, tile_px: int = 256, batch_size: int = 8):
    """The device batches of a run over ``paths``, in the order it encodes
    them: images join the bucket of their padded shape in path order; a
    full bucket is a batch; the partial buckets follow, in the order they
    were opened.  Reads image sizes only."""
    from PIL import Image
    buckets, batches = {}, []
    for path in paths:
        with Image.open(path) as im:
            W, H = im.size
        _, r, _, b = get_padding_size(H, W, tile_px)
        shape = (H + b, W + r)
        buckets.setdefault(shape, []).append(path)
        if len(buckets[shape]) >= batch_size:
            batches.append(buckets.pop(shape))
    return batches + list(buckets.values())


def compress_dir(rt, clip_codec, dataset_dir, save_dir, tile_px: int = 256,
                 batch_size: int = 8, shard=(0, 1), build_index: bool = True):
    """Encode every image of ``dataset_dir``: images are bucketed by padded
    shape and encoded in device batches of up to ``batch_size`` (one pass,
    per-image bitstreams).  ``shard=(rank, world)`` takes every
    ``world``-th batch of :func:`plan_batches`, from ``rank``; pass
    ``build_index=False`` across processes and let rank 0 call
    :func:`build_index_from_saved` after a barrier.  Returns the number of
    images this call encoded."""
    save_dir = Path(save_dir)
    bit_dir = save_dir / "bitstreams"
    clip_dir = save_dir / "clip_vecs"
    for d in (bit_dir, clip_dir, save_dir / "faiss"):
        d.mkdir(parents=True, exist_ok=True)
    rank, world = shard
    batches = plan_batches(list_images(dataset_dir), tile_px,
                           batch_size)[rank::world]
    count = 0
    for batch in progress(batches, desc="compress"):
        imgs = [load_image(path) for path in batch]   # (H, W, 3) in [-1, 1]
        pads = [get_padding_size(img.shape[0], img.shape[1], tile_px)
                for img in imgs]
        x = torch.cat([pad_replicate(torch.from_numpy(img)[None], p)
                       for img, p in zip(imgs, pads)])
        enc_results = rt.encode_only_batched(x)
        for path, img, p, enc_result in zip(batch, imgs, pads, enc_results):
            clip_vec = clip_codec.image_to_unit_vec(img)
            clip_stream, clip_meta = clip_codec.quantize_u8_and_compress(clip_vec)
            enc_result["clip_stream"] = clip_stream
            enc_result["clip_meta"] = clip_meta
            header = c2df_header(rt, clip_meta, img.shape[:2], p)
            (bit_dir / f"{path.stem}.c2df").write_bytes(pack_c2df(enc_result, header))
            np.save(clip_dir / f"{path.stem}.npy", clip_vec)
            count += 1
    if build_index:
        build_index_from_saved(save_dir, model_id=clip_codec.model_id)
    return count


def main(argv=None):
    parser = argparse.ArgumentParser(description="sic_tpu_torch compress")
    parser.add_argument("--dataset_dir", required=True,
                        help="directory of images (searched recursively)")
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--ckpt_path", help="flat params/... .npz of the JAX "
                        "package's parameter tree")
    parser.add_argument("--clip_ckpt", default=None,
                        help="open_clip torch checkpoint for CLIP weights")
    parser.add_argument("--bpe_path", default=None,
                        help="the CLIP tokenizer's BPE merges file")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="device batch per padded-shape bucket")
    parser.add_argument("--stream_part", type=int, default=None,
                        help="rANS substreams per h stream (default: "
                             "SIC_STREAM_PART, else 4)")
    parser.add_argument("--base_config", help="reference-layout YAML config "
                        "(configs/*.yaml); excludes --spec")
    parser.add_argument("--spec", choices=["flagship", "small", "tiny"],
                        default=None, help="model preset (default flagship)")
    add_device_args(parser)
    add_dtype_arg(parser)
    add_quant_arg(parser)
    parser.add_argument("--world_size", type=int, default=None,
                        help="number of processes (default: WORLD_SIZE env)")
    parser.add_argument("--rank", type=int, default=None,
                        help="this process's rank (default: RANK env)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0 "
                             "(default: MASTER_ADDR:MASTER_PORT env)")
    args = parser.parse_args(argv)

    from ..parallel import barrier, rank_device, setup_distributed, shutdown
    from ..parallel.multihost import resolve_world
    init_func()
    t0 = time.time()
    spec = cli_config(parser, args).spec
    rank, world, _ = resolve_world(args.rank, args.world_size, args.coordinator)
    device = cli_device(args)
    if world > 1:
        explicit = device is not None
        device = rank_device(rank, device)
        rank, world = setup_distributed(rank, world, args.coordinator, device,
                                        placed=not explicit)
    rt = load_runtime(args.ckpt_path, spec, device=device,
                      stream_part=args.stream_part, dtype=args.dtype,
                      quant=args.quant)
    try:
        clip_codec = load_clip_codec(args.clip_ckpt, args.bpe_path, device)
        n = compress_dir(rt, clip_codec, args.dataset_dir, args.save_dir,
                         tile_px=spec.tile_px, batch_size=args.batch_size,
                         shard=(rank, world), build_index=(world == 1))
    finally:
        rt.close()
    if world > 1:
        barrier("compress_done")        # every rank's files on disk
        if rank == 0:
            build_index_from_saved(args.save_dir, model_id=clip_codec.model_id)
        barrier("index_done")           # no rank leaves before the merge
        shutdown()
    print(f"[OK] rank {rank}/{world} compressed {n} images in "
          f"{time.time() - t0:.1f}s -> {args.save_dir}", file=sys.stderr)
    return {"images": n, "rank": rank, "world": world,
            "encode_path_counts": dict(rt.encode_path_counts)}


if __name__ == "__main__":
    main()
