"""decompress CLI: ``.c2df`` bitstreams -> PNG reconstructions.

    python -m sic_tpu_torch.cli.decompress --dataset_dir DIR --save_dir OUT
        [--ckpt_path params.npz]
        [--base_config CONFIG.yaml | --spec flagship|small|tiny]
        [--device cuda | --gpu_idx N] [--dtype auto|float32|bfloat16]
        [--quant none|int8] [--batch_size 8] [--stream_part N (ignored: streams carry theirs)]

(reference: src/decompress.py:79-140 — unpack, decode_only, negative-pad
crop, save.)  Same-shaped files are decoded in device-batched groups of up
to ``--batch_size`` (1: each file alone, as the service decodes a single
request).  A header without ``z_coder`` is a reference file: its semantic
stream is torchac-coded.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from ..container import sanitize_enc_result_types, unpack_c2df
from ._common import (add_device_args, add_dtype_arg, add_quant_arg, cli_config,
                      cli_device, load_runtime, save_png)


def _crop_and_save(save_dir, stem, img, header):
    l, r, t, b = header.get("padding", [0, 0, 0, 0])
    H, W = img.shape[:2]
    img = img[t:H - b if b else H, l:W - r if r else W]
    save_png(Path(save_dir) / f"{stem}.png", img)


def decompress_dir(rt, dataset_dir, save_dir, batch_size: int = 8) -> int:
    """Decode every ``*.c2df`` of ``dataset_dir`` into ``save_dir``; files
    of one geometry and coding contract share a batched decode."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(Path(dataset_dir).glob("*.c2df"))
    buckets = {}

    def flush(key):
        group = buckets.pop(key, [])
        if len(group) == 1:
            stem, enc, header = group[0]
            x = rt.decode_only(**enc, output="u8")
            _crop_and_save(save_dir, stem, x[0], header)
        elif group:
            x = rt.decode_only_batched([enc for _, enc, _ in group], output="u8")
            for i, (stem, _enc, header) in enumerate(group):
                _crop_and_save(save_dir, stem, x[i], header)

    for path in files:
        enc, header = unpack_c2df(path)
        enc = sanitize_enc_result_types(enc)
        enc["z_coder"] = header.get("z_coder", "torchac")
        # files without the marker predate the coding contract and were
        # coded at their own batch of 1
        enc["coding_batch"] = int(header.get("coding_batch", 1))
        key = (tuple(enc["stack_shape"]), tuple(enc["feat_shape"]),
               int(enc["token_length"]), enc["coding_batch"])
        buckets.setdefault(key, []).append((path.stem, enc, header))
        if len(buckets[key]) >= batch_size:
            flush(key)
    for key in list(buckets):
        flush(key)
    return len(files)


def main(argv=None):
    parser = argparse.ArgumentParser(description="sic_tpu_torch decompress")
    parser.add_argument("--dataset_dir", required=True,
                        help="directory of .c2df files")
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--ckpt_path", help="flat params/... .npz of the JAX "
                        "package's parameter tree")
    parser.add_argument("--base_config", help="reference-layout YAML config "
                        "(configs/*.yaml); excludes --spec")
    parser.add_argument("--spec", choices=["flagship", "small", "tiny"],
                        default=None, help="model preset (default flagship)")
    add_device_args(parser)
    parser.add_argument("--batch_size", type=int, default=8,
                        help="files of one geometry decoded together")
    parser.add_argument("--stream_part", type=int, default=None,
                        help="accepted as the reference's flag; decoding "
                             "ignores it: each stream carries its own part "
                             "count")
    add_dtype_arg(parser)
    add_quant_arg(parser)
    args = parser.parse_args(argv)

    t0 = time.time()
    spec = cli_config(parser, args).spec
    rt = load_runtime(args.ckpt_path, spec, device=cli_device(args),
                      stream_part=args.stream_part, dtype=args.dtype,
                      quant=args.quant)
    try:
        n = decompress_dir(rt, args.dataset_dir, args.save_dir,
                           batch_size=args.batch_size)
    finally:
        rt.close()
    print(f"[OK] decompressed {n} files in {time.time() - t0:.1f}s "
          f"-> {args.save_dir}", file=sys.stderr)
    return n


if __name__ == "__main__":
    main()
