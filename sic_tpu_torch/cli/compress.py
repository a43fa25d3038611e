"""compress CLI: images -> searchable ``.c2df`` bitstreams + vector index.

    python -m sic_tpu_torch.cli.compress --dataset_dir DIR --save_dir OUT
        [--ckpt_path params.npz] [--clip_ckpt open_clip.pt]
        [--base_config CONFIG.yaml | --spec flagship|small|tiny]
        [--device cuda | --gpu_idx N] [--dtype auto|float32|bfloat16]
        [--quant none|int8] [--batch_size 8] [--stream_part 4] [--bpe_path merges.txt.gz]

Same output layout as the reference's compress script (reference:
src/compress.py:203-333): per image pad to 256 (replicate),
``encode_only_batched`` per padded-shape bucket, CLIP embed + u8/zstd pack,
``pack_c2df`` into ``OUT/bitstreams``, raw clip vecs into ``OUT/clip_vecs``
and a flat-IP index in both FAISS layouts into ``OUT/faiss``.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..container import pack_c2df
from ..data import list_images, load_image, shard_list
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


def compress_dir(rt, clip_codec, dataset_dir, save_dir, tile_px: int = 256,
                 batch_size: int = 8, shard=(0, 1)):
    """Encode every image of ``dataset_dir``: images are bucketed by padded
    shape and encoded in device batches of up to ``batch_size`` (one pass,
    per-image bitstreams).  ``shard=(rank, world)`` takes every
    ``world``-th image from ``rank``.  Returns the number of images."""
    save_dir = Path(save_dir)
    bit_dir = save_dir / "bitstreams"
    clip_dir = save_dir / "clip_vecs"
    for d in (bit_dir, clip_dir, save_dir / "faiss"):
        d.mkdir(parents=True, exist_ok=True)
    paths = shard_list(list_images(dataset_dir), *shard)
    count = 0
    buckets = {}

    def flush(shape):
        nonlocal count
        batch = buckets.pop(shape, [])
        if not batch:
            return
        enc_results = rt.encode_only_batched(torch.cat([b[2] for b in batch]))
        for (path, img, _), enc_result in zip(batch, enc_results):
            H, W = img.shape[:2]
            pads = get_padding_size(H, W, tile_px)
            clip_vec = clip_codec.image_to_unit_vec(img)
            clip_stream, clip_meta = clip_codec.quantize_u8_and_compress(clip_vec)
            enc_result["clip_stream"] = clip_stream
            enc_result["clip_meta"] = clip_meta
            header = c2df_header(rt, clip_meta, (H, W), pads)
            (bit_dir / f"{path.stem}.c2df").write_bytes(pack_c2df(enc_result, header))
            np.save(clip_dir / f"{path.stem}.npy", clip_vec)
            count += 1

    for path in progress(paths, desc="compress"):
        img = load_image(path)                       # (H, W, 3) in [-1, 1]
        pads = get_padding_size(img.shape[0], img.shape[1], tile_px)
        x = pad_replicate(torch.from_numpy(img)[None], pads)
        shape = tuple(x.shape[1:3])
        buckets.setdefault(shape, []).append((path, img, x))
        if len(buckets[shape]) >= batch_size:
            flush(shape)
    for shape in list(buckets):
        flush(shape)
    build_index_from_saved(save_dir, model_id=clip_codec.model_id)
    return count


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="sic_tpu_torch compress",
        epilog="Not offered yet: the multi-process flags (--world_size, "
               "--rank, --coordinator; ROADMAP queue 1 item 10): this runs "
               "one process on one device.")
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
    args = parser.parse_args(argv)

    init_func()
    t0 = time.time()
    spec = cli_config(parser, args).spec
    device = cli_device(args)
    rt = load_runtime(args.ckpt_path, spec, device=device,
                      stream_part=args.stream_part, dtype=args.dtype,
                      quant=args.quant)
    try:
        clip_codec = load_clip_codec(args.clip_ckpt, args.bpe_path, device)
        n = compress_dir(rt, clip_codec, args.dataset_dir, args.save_dir,
                         tile_px=spec.tile_px, batch_size=args.batch_size)
    finally:
        rt.close()
    print(f"[OK] compressed {n} images in {time.time() - t0:.1f}s "
          f"-> {args.save_dir}", file=sys.stderr)
    return {"images": n, "encode_path_counts": dict(rt.encode_path_counts)}


if __name__ == "__main__":
    main()
