#!/usr/bin/env python3
"""Convert trained codec parameters between the two packages' formats.

    python tools/convert_params.py to-npz   SRC_ORBAX_DIR DST.npz   [--spec tiny|small|flagship | --base_config CFG.yaml]
    python tools/convert_params.py to-orbax SRC.npz       DST_DIR
    python tools/convert_params.py maskgit-to-npz SRC.msgpack DST.npz

``to-npz``: an orbax parameter checkpoint of the JAX package (the train
CLI's ``deploy_params`` directory, ``sic_tpu.checkpoint.save_codec_params``;
a training-state checkpoint works too) -> the flat ``params/...`` npz that
the PyTorch port's CLIs read with ``--ckpt_path``.  Every leaf is written
as f32: a leaf stored in bf16 (the JAX CLI keeps frozen backbones in bf16
on an accelerator) is upcast, which is exact.  ``--spec`` (or
``--base_config``) names the model whose parameter tree the restore
expects (default flagship).

``to-orbax``: a port npz (the port's train CLI writes ``deploy_params.npz``)
-> an orbax checkpoint that ``sic_tpu.checkpoint.load_codec_params`` and
the JAX package's CLIs (``--ckpt_path``) restore.

``maskgit-to-npz``: a flax-msgpack ``MaskGITGenerator`` parameter file
(what the JAX generate CLI's ``--maskgit_ckpt`` reads) -> the flat npz that
the port's generate CLI reads with ``--maskgit_ckpt``; f32 leaves.

Runs where the JAX package and orbax are installed (this script imports
``sic_tpu``, ``jax`` and ``orbax``); the port itself imports none of them,
and the machine that runs only the port need not have them.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def orbax_to_flat(src, spec) -> dict:
    """An orbax codec-params checkpoint -> flat ``params/...`` f32 arrays."""
    from flax.traverse_util import flatten_dict

    from sic_tpu.checkpoint import load_codec_params
    tree = load_codec_params(src, spec)
    return {k: np.asarray(v, np.float32)
            for k, v in flatten_dict(tree, sep="/").items()}


def flat_to_orbax(flat, dst) -> str:
    """Flat ``params/...`` arrays -> an orbax checkpoint at ``dst``."""
    from flax.traverse_util import unflatten_dict

    from sic_tpu.checkpoint import save_codec_params
    return save_codec_params(dst, unflatten_dict(
        {k: np.asarray(v) for k, v in flat.items()}, sep="/"))


def msgpack_to_flat(src) -> dict:
    """A flax-msgpack parameter file (``flax.serialization.to_bytes`` of
    ``{"params": ...}``) -> flat ``params/...`` f32 arrays."""
    from flax.serialization import msgpack_restore
    from flax.traverse_util import flatten_dict
    tree = msgpack_restore(Path(src).read_bytes())
    return {k: np.asarray(v, np.float32)
            for k, v in flatten_dict(tree, sep="/").items()}


def _spec(args):
    from sic_tpu import config
    if args.base_config:
        return config.load_config(args.base_config).spec
    return getattr(config, f"{args.spec}_spec")()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Runs where the JAX package (sic_tpu), jax and orbax are "
               "installed.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    to_npz = sub.add_parser("to-npz", help="JAX orbax checkpoint -> port npz")
    to_npz.add_argument("src", help="orbax checkpoint directory")
    to_npz.add_argument("dst", help="output .npz")
    group = to_npz.add_mutually_exclusive_group()
    group.add_argument("--spec", choices=["flagship", "small", "tiny"],
                       default="flagship", help="model preset (default flagship)")
    group.add_argument("--base_config", help="reference-layout YAML config")
    to_orbax = sub.add_parser("to-orbax", help="port npz -> JAX orbax checkpoint")
    to_orbax.add_argument("src", help="input .npz (params/... keys)")
    to_orbax.add_argument("dst", help="output orbax checkpoint directory")
    maskgit = sub.add_parser("maskgit-to-npz",
                             help="flax-msgpack MaskGIT generator -> port npz")
    maskgit.add_argument("src", help="flax-msgpack parameter file")
    maskgit.add_argument("dst", help="output .npz")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    if args.cmd in ("to-npz", "maskgit-to-npz"):
        flat = orbax_to_flat(args.src, _spec(args)) if args.cmd == "to-npz" \
            else msgpack_to_flat(args.src)
        np.savez(args.dst, **flat)
        print(f"[OK] {len(flat)} leaves -> {args.dst}", file=sys.stderr)
    else:
        with np.load(args.src) as z:
            flat = {k: z[k] for k in z.files}
        print(f"[OK] {len(flat)} leaves -> {flat_to_orbax(flat, args.dst)}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
