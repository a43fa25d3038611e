"""Shared CLI plumbing: config, runtime and CLIP construction, determinism,
progress and PNG output."""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..config import CodecSpec, flagship_spec
from ..models import Codec, CodecRuntime, resolve_device
from ..models.codec import resolve_dtype
from ..weights import init_seeded, load_npz


def build_model(spec: CodecSpec, device,
                ckpt_path: Optional[str] = None) -> Codec:
    """The codec on ``device``, from a flat ``params/...`` npz or, without
    one, from the seeded initialisation."""
    with torch.device(device):
        model = Codec(spec)
    if ckpt_path:
        stray = sorted(load_npz(model, ckpt_path))
        if stray:
            raise ValueError(f"{len(stray)} checkpoint leaves fit no parameter "
                             f"of the codec, e.g. {stray[:3]}")
    else:
        init_seeded(model)
    return model.eval().requires_grad_(False)


def load_spec_and_cfg(base_config: Optional[str]):
    """A reference-layout YAML's config, or without one the flagship
    preset with the default loss configs and no strategy."""
    from ..config import LoadedConfig, load_config
    from ..train.steps import FeatLossCfg, ImgLossCfg
    if base_config:
        return load_config(base_config)
    return LoadedConfig(flagship_spec(), None, FeatLossCfg(), ImgLossCfg())


def cli_config(parser, args):
    """The config a CLI runs: ``--base_config``'s, or the ``--spec`` preset
    (flagship when neither is given).  Both at once name the model twice
    and are refused."""
    from .. import config
    if args.base_config and args.spec:
        parser.error("--base_config and --spec both name the model: give one")
    cfg = load_spec_and_cfg(args.base_config)
    if args.spec:
        cfg = dataclasses.replace(cfg, spec=getattr(config, f"{args.spec}_spec")())
    return cfg


def load_runtime(ckpt_path: Optional[str] = None, spec: Optional[CodecSpec] = None,
                 device=None, stream_part: Optional[int] = None,
                 base_config: Optional[str] = None,
                 z_format: str = "rans", dtype=None,
                 quant: Optional[str] = None) -> CodecRuntime:
    """A CodecRuntime on ``device`` (CUDA unless named), of ``spec`` or of
    the YAML ``base_config`` (not both; flagship without either).

    ``dtype``: the networks' compute dtype.  ``None`` (or ``"auto"``)
    follows the JAX package's ``load_runtime``: bf16 on an accelerator
    (here CUDA), fp32 on the CPU; ``"float32"`` / ``"bfloat16"`` (or the
    torch dtypes) pick one.  The coding chain is fp32 in both.
    ``stream_part``: rANS substreams per stream this runtime writes (None:
    the ``SIC_STREAM_PART`` environment variable, else 4, as the JAX
    package's ``load_runtime``); decoding reads the count from each
    stream.  ``z_format``: the semantic
    stream's format it writes.  ``quant``: ``"int8"`` serves W8A8,
    ``"none"`` float (None: the ``SIC_QUANT`` environment variable, else
    none, as the JAX package's ``load_runtime``).  Without ``ckpt_path`` it
    warns and uses the seeded initialisation, as the JAX CLI does."""
    if spec is not None and base_config:
        raise ValueError("give spec or base_config, not both")
    dev = resolve_device(device)
    spec = spec or load_spec_and_cfg(base_config).spec
    if not ckpt_path:
        print("[WARN] no --ckpt_path given; running with random weights",
              file=sys.stderr)
    model = build_model(spec, dev, ckpt_path)
    if stream_part is None:
        stream_part = int(os.environ.get("SIC_STREAM_PART", "4"))
    if quant is None:
        quant = os.environ.get("SIC_QUANT", "none")
    return CodecRuntime(spec, model, stream_part=stream_part, z_format=z_format,
                        dtype=resolve_dtype(dtype, dev), quant=quant)


def add_device_args(parser) -> None:
    """``--device`` and the reference's ``--gpu_idx``."""
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' to run there)")
    parser.add_argument("--gpu_idx", type=int, default=None,
                        help="the card to run on, cuda:N (the reference's "
                             "flag); --device wins when both are given")


def cli_device(args):
    """The device of ``add_device_args``' flags: ``--device``, else
    ``cuda:<gpu_idx>``, else None (CUDA)."""
    if args.device is not None or args.gpu_idx is None:
        return args.device
    return f"cuda:{args.gpu_idx}"


def add_dtype_arg(parser) -> None:
    """``--dtype``: the CLIs' counterpart of the JAX ``load_runtime``'s
    dtype, surfaced as ``--device`` surfaces its platform."""
    parser.add_argument("--dtype", choices=["auto", "float32", "bfloat16"],
                        default="auto",
                        help="compute dtype of the networks (default auto: "
                             "bfloat16 on CUDA, float32 on the CPU, as the "
                             "JAX package picks); the coding chain is fp32")


def load_clip_codec(clip_ckpt: Optional[str] = None,
                    bpe_path: Optional[str] = None, device=None):
    """The CLIP codec (both towers) on ``device``, from an open_clip
    checkpoint or, without one, from the seeded initialisation (with a
    warning, as the JAX CLI does); ``bpe_path`` is the tokenizer's merges
    file (without it, the hashed fallback)."""
    from ..retrieval import ClipCodec, port_open_clip_weights
    state = port_open_clip_weights(clip_ckpt) if clip_ckpt else None
    if state is None:
        print("[WARN] no --clip_ckpt given; CLIP embeddings are "
              "non-calibrated (random weights)", file=sys.stderr)
    return ClipCodec(state, device=device, bpe_path=bpe_path)


def add_quant_arg(parser) -> None:
    """``--quant``, the JAX CLIs' flag."""
    parser.add_argument("--quant", choices=["none", "int8"], default=None,
                        help="serve the networks W8A8 int8 on the int8 tensor "
                             "cores (streams stay decodable across modes); "
                             "default: SIC_QUANT, else none")


def init_func(seed: int = 0) -> None:
    """Determinism hook (reference: src/compress.py:314-319)."""
    np.random.seed(seed)
    torch.manual_seed(seed)


def progress(iterable, total=None, desc=""):
    """Yield from ``iterable``, printing the rate about 20 times."""
    total = total if total is not None else (
        len(iterable) if hasattr(iterable, "__len__") else None)
    t0 = time.time()
    for i, item in enumerate(iterable):
        yield item
        if total and (i + 1) % max(1, total // 20) == 0:
            rate = (i + 1) / (time.time() - t0)
            print(f"[{desc}] {i + 1}/{total} ({rate:.2f}/s)", file=sys.stderr,
                  flush=True)


def save_png(path, img) -> None:
    """(H, W, 3) uint8 pixels, or floats in [-1, 1], -> PNG file."""
    from PIL import Image
    a = img.cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    u8 = a if a.dtype == np.uint8 else \
        np.clip((a + 1.0) * 127.5, 0, 255).astype(np.uint8)
    Image.fromarray(u8).save(path)
