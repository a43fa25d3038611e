"""search CLI: query-text / query-image / query-c2df over a built index.

    python -m sic_tpu_torch.cli.search query-c2df --index_dir DIR --c2df F
        [--topk 10] [--device cuda]
    python -m sic_tpu_torch.cli.search query-text --index_dir DIR --text T
        [--clip_ckpt open_clip.pt] [--bpe_path merges.txt.gz]
    python -m sic_tpu_torch.cli.search query-image --index_dir DIR --image F

Same subcommands and JSON on stdout as the JAX package's CLI (reference:
src/search.py:126-175).  ``query-c2df`` needs no model: the query vector is
decoded from the bitstream's clip payload (search.py:24-41).  The index
searches on ``--device`` (CUDA unless named), where the CLIP towers run
too.  ``query-image`` reads the file as the JAX CLI does, through [-1, 1]
floats, which lowers pixel values 1-63 by one before the CLIP
preprocessing; the service, as the JAX one, hands CLIP the PIL image.
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path

import numpy as np

from ..container import unpack_c2df
from ..retrieval import VectorIndex, decode_clip_stream
from ._common import load_clip_codec


def encode_c2df_query(c2df_path) -> np.ndarray:
    enc_result, _ = unpack_c2df(c2df_path)
    if "clip_stream" not in enc_result or "clip_meta" not in enc_result:
        raise ValueError(
            f"{c2df_path} has no clip_stream/clip_meta; cannot search")
    return decode_clip_stream(enc_result["clip_stream"],
                              enc_result["clip_meta"])


def do_search(q, index: VectorIndex, topk: int = 10):
    """One query -> [(doc id, score), ...], best first, missing slots
    dropped."""
    scores, ids = index.search(q, k=topk)
    return [(index.ids[int(i)], float(s)) for s, i in zip(scores[0], ids[0])
            if i >= 0]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="query-text / query-image / query-c2df")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--index_dir", type=Path, required=True)
        p.add_argument("--topk", type=int, default=10)
        p.add_argument("--device", default=None,
                       help="torch device (default: cuda; 'cpu' to run there)")

    ap_qt = sub.add_parser("query-text", help="searching with text")
    common(ap_qt)
    ap_qt.add_argument("--text", type=str, required=True)
    ap_qi = sub.add_parser("query-image", help="searching with image")
    common(ap_qi)
    ap_qi.add_argument("--image", type=Path, required=True)
    for p in (ap_qt, ap_qi):
        p.add_argument("--clip_ckpt", type=str, default=None)
        p.add_argument("--bpe_path", type=str, default=None)
    ap_qc = sub.add_parser("query-c2df", help="searching with .c2df")
    common(ap_qc)
    ap_qc.add_argument("--c2df", type=Path, required=True)

    args = ap.parse_args(argv)
    try:
        index, _meta = VectorIndex.load(args.index_dir, device=args.device)
        if args.cmd == "query-text":
            cc = load_clip_codec(args.clip_ckpt, args.bpe_path, args.device)
            q = cc.text_to_unit_vec(args.text)[0]
        elif args.cmd == "query-image":
            from ..data import load_image
            cc = load_clip_codec(args.clip_ckpt, args.bpe_path, args.device)
            q = cc.image_to_unit_vec(load_image(args.image))
        else:
            q = encode_c2df_query(args.c2df)
        results = do_search(q, index, topk=args.topk)
        print(json.dumps([{"path": p, "score": s} for p, s in results],
                         ensure_ascii=False, indent=2))
    except Exception as e:
        print(f"[ERROR] {e}")
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
