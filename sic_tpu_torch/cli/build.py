"""build CLI: a vector index from ``.c2df`` files or from raw images.

    python -m sic_tpu_torch.cli.build build --c2df_dir DIR --index_dir OUT
    python -m sic_tpu_torch.cli.build build-images --image_dir DIR
        --index_dir OUT [--clip_ckpt open_clip.pt] [--batch_size 32]
        [--device cuda]
    python -m sic_tpu_torch.cli.build download --out_dir DIR --desired N

Same subcommands as the JAX package's CLI (reference: src/build.py:245-307):
``build`` decodes the clip streams of a ``.c2df`` directory (no model; its
index files equal the JAX package's byte for byte), ``build-images`` runs
the CLIP image tower in batches on ``--device`` (CUDA unless named),
``download`` fetches a Picsum corpus and needs network egress.
"""
from __future__ import annotations

import argparse
import random
import sys
import traceback
from pathlib import Path

import numpy as np

from ..container import unpack_c2df
from ..data import IMG_EXTS, list_images
from ..retrieval import VectorIndex, decode_clip_stream, preprocess_image
from ._common import load_clip_codec, progress


def build_index_from_c2df_dir(c2df_dir, index_dir) -> int:
    """(reference: build.py:71-103)"""
    files = sorted(Path(c2df_dir).glob("*.c2df"))
    if not files:
        raise FileNotFoundError(f"no .c2df files in {c2df_dir}")
    index = None
    model_id = ""
    for path in progress(files, desc="build"):
        enc_result, _ = unpack_c2df(path)
        vec = decode_clip_stream(enc_result["clip_stream"],
                                 enc_result["clip_meta"])
        model_id = (enc_result.get("clip_meta") or {}).get("model_id", model_id)
        if index is None:
            index = VectorIndex(dim=vec.shape[0])
        index.add(vec, str(path))
    index.persist(index_dir, meta={"dim": index.dim, "metric": "ip",
                                   "model_id": model_id})
    return index.ntotal


def ensure_images_count(image_dir, desired: int, auto_download: bool = False,
                        download_dir=None, size: str = "512x512", seed=None,
                        timeout: int = 20, exts=IMG_EXTS) -> None:
    """Fill an image-dir shortfall from Picsum (reference: build.py:160-172),
    counting with the extension filter the caller selects with."""
    have = 0
    for d in {Path(image_dir), Path(download_dir or image_dir)}:
        if d.exists():
            have += len(list_images(d, exts))
    if have >= desired or not auto_download:
        return
    need = desired - have
    dd = download_dir or image_dir
    print(f"[INFO] Not enough images (have {have} < required {desired}); "
          f"auto-downloading {need} images to {dd}")
    got = download_random_picsum(need, dd, size=size, seed=seed,
                                 timeout=timeout)
    print(f"[INFO] Download complete: added {got} images")


def build_index_from_image_dir(image_dir, index_dir, clip_ckpt=None,
                               bpe_path=None, batch_size: int = 32,
                               exts=IMG_EXTS, limit=None, random_pick=False,
                               seed=None, model_id=None, desired=None,
                               auto_download=False, download_dir=None,
                               download_size: str = "512x512",
                               timeout: int = 20, device=None) -> int:
    """(reference: build.py:209-240)"""
    if desired is not None and auto_download:
        ensure_images_count(image_dir, desired, auto_download=True,
                            download_dir=download_dir, size=download_size,
                            seed=seed, timeout=timeout, exts=exts)
    paths = list_images(image_dir, exts)
    if download_dir and Path(download_dir).resolve() != \
            Path(image_dir).resolve() and Path(download_dir).exists():
        # a separate --download_dir is indexed too, or the images fetched
        # to meet --desired would never be used
        paths = sorted(set(paths) | set(list_images(download_dir, exts)))
    if not paths:
        raise FileNotFoundError(f"no images in {image_dir}")
    # --desired wins over --limit as the selection count (build.py:219-225)
    target_n = desired if (desired is not None and desired > 0) else limit
    if target_n is not None and 0 < target_n < len(paths):
        if random_pick:
            paths = random.Random(seed).sample(paths, target_n)
        else:
            paths = paths[:target_n]

    cc = load_clip_codec(clip_ckpt, bpe_path, device)
    if model_id and model_id != cc.model_id:
        print(f"[WARN] --model_id {model_id!r} requested but this build has "
              f"no model zoo; the loaded tower is {cc.model_id!r} "
              "(bring matching weights via --clip_ckpt)", file=sys.stderr)
    from PIL import Image
    index = VectorIndex(dim=cc.spec.embed_dim)
    for s in progress(range(0, len(paths), batch_size),
                      total=(len(paths) + batch_size - 1) // batch_size,
                      desc="build-images"):
        chunk = paths[s:s + batch_size]
        batch = np.stack([preprocess_image(Image.open(p)) for p in chunk])
        index.add_batch(cc.images_to_unit_vecs(batch), [str(p) for p in chunk])
    # the requested id goes into meta (build.py:238), so that search loads
    # the matching tower later
    index.persist(index_dir, meta={"dim": index.dim, "metric": "ip",
                                   "model_id": model_id or cc.model_id})
    return index.ntotal


def download_random_picsum(need: int, out_dir, size="512x512", seed=None,
                           timeout=20) -> int:
    """Picsum corpus bootstrap (reference: build.py:137-158).  Needs
    network egress; each failed fetch is reported and skipped."""
    import urllib.request
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    w, h = size.split("x") if "x" in size else (size, size)
    rng = random.Random(seed)
    got = 0
    for _ in range(need):
        sid = rng.randint(0, 10 ** 9)
        url = f"https://picsum.photos/seed/{sid}/{int(w)}/{int(h)}"
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                (out_dir / f"picsum_{sid}.jpg").write_bytes(r.read())
            got += 1
        except Exception as e:
            print(f"[WARN] download failed: {e}", file=sys.stderr)
    return got


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="SIC build tool (build / build-images / download)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ap_dl = sub.add_parser("download")
    ap_dl.add_argument("--out_dir", type=Path, required=True)
    ap_dl.add_argument("--desired", type=int, required=True)
    ap_dl.add_argument("--size", type=str, default="512x512")
    ap_dl.add_argument("--seed", type=int, default=None)
    ap_dl.add_argument("--timeout", type=int, default=20)

    ap_build = sub.add_parser("build")
    ap_build.add_argument("--c2df_dir", type=Path, required=True)
    ap_build.add_argument("--index_dir", type=Path, required=True)

    ap_bimg = sub.add_parser("build-images")
    ap_bimg.add_argument("--image_dir", type=Path, required=True)
    ap_bimg.add_argument("--index_dir", type=Path, required=True)
    ap_bimg.add_argument("--clip_ckpt", type=str, default=None)
    ap_bimg.add_argument("--bpe_path", type=str, default=None)
    ap_bimg.add_argument("--batch_size", type=int, default=32)
    ap_bimg.add_argument("--exts", type=str, default="jpg,jpeg,png,webp,bmp")
    ap_bimg.add_argument("--limit", type=int, default=None)
    ap_bimg.add_argument("--random", action="store_true")
    ap_bimg.add_argument("--seed", type=int, default=None)
    ap_bimg.add_argument("--model_id", type=str, default=None,
                         help="e.g. ViT-B-32:laion2b_s34b_b79k (recorded in "
                              "meta.json; weights come from --clip_ckpt)")
    ap_bimg.add_argument("--desired", type=int, default=None,
                         help="target image count; wins over --limit")
    ap_bimg.add_argument("--auto_download", action="store_true",
                         help="fill any shortfall vs --desired from Picsum")
    ap_bimg.add_argument("--download_dir", type=Path, default=None)
    ap_bimg.add_argument("--download_size", type=str, default="512x512")
    ap_bimg.add_argument("--timeout", type=int, default=20)
    ap_bimg.add_argument("--device", default=None,
                         help="torch device (default: cuda; 'cpu' to run there)")

    args = ap.parse_args(argv)
    try:
        if args.cmd == "download":
            have = len(list_images(args.out_dir)) if args.out_dir.exists() else 0
            need = max(0, args.desired - have)
            if need <= 0:
                print(f"[INFO] already have {have} images")
                return
            got = download_random_picsum(need, args.out_dir, args.size,
                                         args.seed, args.timeout)
            print(f"[OK] downloaded {got} images (total {have + got})")
        elif args.cmd == "build":
            n = build_index_from_c2df_dir(args.c2df_dir, args.index_dir)
            print(f"[OK] built index over {n} bitstreams -> {args.index_dir}")
        elif args.cmd == "build-images":
            exts = tuple("." + e.strip().lstrip(".")
                         for e in args.exts.split(",") if e.strip())
            n = build_index_from_image_dir(
                args.image_dir, args.index_dir, args.clip_ckpt, args.bpe_path,
                batch_size=args.batch_size, exts=exts, limit=args.limit,
                random_pick=args.random, seed=args.seed,
                model_id=args.model_id, desired=args.desired,
                auto_download=args.auto_download,
                download_dir=args.download_dir,
                download_size=args.download_size, timeout=args.timeout,
                device=args.device)
            print(f"[OK] built index over {n} images -> {args.index_dir}")
    except Exception as e:
        print(f"[ERROR] {e}")
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
