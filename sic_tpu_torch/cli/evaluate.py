"""evaluate CLI: rate-distortion over an image directory.

    python -m sic_tpu_torch.cli.evaluate --dataset_dir IMGS
        [--base_config CONFIG.yaml | --spec flagship|small|tiny]
        [--ckpt_path params.npz] [--lpips_lin vgg.pth --lpips_vgg vgg16.pth]
        [--device cuda] [--dtype auto|float32|bfloat16] [--quant none|int8]

Counterpart of the JAX package's ``cli/evaluate.py``: each image makes a
full round trip through real bitstreams (``CodecRuntime.encode_decode``),
and one JSON line per image gives its bpp (total, semantic and detail
streams), PSNR, MS-SSIM (images of at least 176 px a side) and, with LPIPS
weights, LPIPS; a last line gives the means.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..data import list_images, load_image
from ..metrics import ms_ssim, psnr
from ..models import get_padding_size, pad_replicate
from ._common import (add_dtype_arg, add_quant_arg, cli_config, init_func,
                      load_runtime, progress)


@torch.no_grad()
def evaluate_dir(rt, dataset_dir, lpips_fn=None, out=None):
    """One JSON record an image of ``dataset_dir`` and a summary line to
    ``out`` (default stdout); returns the summary."""
    out = out or sys.stdout
    paths = list_images(dataset_dir)
    if not paths:
        raise FileNotFoundError(f"no images in {dataset_dir}")
    sums = {}
    for path in progress(paths, desc="evaluate"):
        img = load_image(path)
        H, W = img.shape[:2]
        pads = get_padding_size(H, W, rt.spec.tile_px)
        x = pad_replicate(torch.from_numpy(img)[None], pads)
        x_hat, bpp, _ = rt.encode_decode(x, (H, W))
        x_hat = x_hat[:, :H, :W]
        x_ref = torch.from_numpy(img)[None].to(x_hat.device)
        rec = {
            "path": str(path), "hw": [H, W],
            "bpp": round(bpp["total_bpp"], 6),
            "z_bpp": round(bpp["z_bpp"], 6),
            "h_bpp": round(bpp["h_bpp"], 6),
            "psnr": round(float(psnr(x_ref, x_hat)[0]), 4),
        }
        if min(H, W) >= 176:
            rec["ms_ssim"] = round(float(ms_ssim(x_ref, x_hat)[0]), 5)
        if lpips_fn is not None:
            rec["lpips"] = round(float(lpips_fn(x_ref, x_hat)[0]), 5)
        print(json.dumps(rec), file=out, flush=True)
        for k, v in rec.items():
            if isinstance(v, (int, float)) and k != "hw":
                sums.setdefault(k, []).append(v)
    summary = {"type": "summary", "n": len(paths),
               **{f"mean_{k}": round(float(np.mean(v)), 6)
                  for k, v in sums.items()}}
    print(json.dumps(summary), file=out, flush=True)
    return summary


def main(argv=None, out=None):
    init_func()
    ap = argparse.ArgumentParser(description="sic_tpu_torch evaluate")
    ap.add_argument("--base_config", default=None,
                    help="reference-layout YAML config; excludes --spec")
    ap.add_argument("--spec", choices=["flagship", "small", "tiny"],
                    default=None, help="model preset (default flagship)")
    ap.add_argument("--ckpt_path", default=None,
                    help="flat params/... .npz of the JAX package's tree")
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--lpips_lin", default=None,
                    help="LPIPS calibration heads (torch .pth)")
    ap.add_argument("--lpips_vgg", default=None,
                    help="torchvision VGG16 state dict")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    add_dtype_arg(ap)
    add_quant_arg(ap)
    args = ap.parse_args(argv)

    spec = cli_config(ap, args).spec
    rt = load_runtime(args.ckpt_path, spec, device=args.device, dtype=args.dtype,
                      quant=args.quant)
    lpips_fn = None
    if args.lpips_lin and not args.lpips_vgg:
        print("[WARN] --lpips_lin without --lpips_vgg: the VGG16 backbone "
              "is UNCALIBRATED (seeded weights); reported lpips values are "
              "not comparable to the reference's", file=sys.stderr)
    if args.lpips_lin or args.lpips_vgg:
        from ..models.lpips import LPIPS, load_lpips_weights
        with torch.device(rt.device):
            lp = LPIPS()
        lp.init_weights(torch.Generator(device=rt.device).manual_seed(0))
        load_lpips_weights(lp, args.lpips_lin, args.lpips_vgg)
        lpips_fn = lp.eval().requires_grad_(False)
    try:
        return evaluate_dir(rt, args.dataset_dir, lpips_fn, out=out)
    finally:
        rt.close()


if __name__ == "__main__":
    main()
