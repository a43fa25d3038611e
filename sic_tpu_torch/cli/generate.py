"""generate CLI: class-conditional image synthesis from the MaskGIT prior.

    python -m sic_tpu_torch.cli.generate --save_dir OUT [--classes 0,1,2]
        [--model titok_l32 | titok_s128]
        [--titok_ckpt tokenizer_titok_l32.bin] [--maskgit_ckpt params.npz]
        [--steps 8] [--guidance_scale 3.0] [--temperature 4.5] [--seed 0]
        [--tiny] [--device cuda | --gpu_idx N]

Counterpart of the JAX package's ``cli/generate.py``: iterative
confidence-based sampling of TiTok's latent tokens, one image a class id
(classifier-free guidance, a gumbel-noised argmax, the arccos mask
schedule), then the pixel decode through the standalone TiTok pixel path
(reference: titok/titok.py:133-143); pixels clipped to [0, 1] and written
as ``sample_class{c}_{i}.png``.  It runs in fp32 on the card unless
``--device cpu`` is given.

``--model`` picks the tokenizer, the generator and the sampler's
defaults: ``titok_l32`` (the default; TiTok-L-32 and the MaskGIT
generator, 8 steps, constant guidance 3.0, temperature 4.5) or
``titok_s128`` (TiTok-S-128 and the U-ViT generator of
``models/maskgit_uvit.py``, 64 steps, power-cosine guidance 6.9,
temperature 2.8, softmax-temperature annealing: the setting of the
benchmark's ``titok-s128-uvit`` configuration).  ``--steps``,
``--guidance_scale`` and ``--temperature`` override them.

Weights: ``--titok_ckpt`` reads the reference torch file through the
port's copy of the reference map (``port_titok.py``), at the pixel spec's
own depth.  ``--maskgit_ckpt`` reads a flat ``params/...`` ``.npz`` of the
generator; the JAX CLI reads flax msgpack there, which this package does
not decode (``python tools/convert_params.py maskgit-to-npz`` converts
one).  Without them the weights are seeded (with a warning), which still
drives every stage.  TiTok-S-128's checkpoints are refused: no key map
has been checked against the published files.  The noise comes from a
``torch.Generator`` seeded by ``--seed``: it is not ``jax.random``'s, so
seeded samples differ from the JAX CLI's unless ``--temperature 0``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..config import TiTokSpec, tiny_spec, titok_s128_spec
from ..models import configure_numerics, resolve_device
from ..models.maskgit import MaskGITGenerator, MaskGITSpec, generate
from ..models.maskgit_uvit import UViTGenerator, UViTSpec
from ..models.maskgit_vqgan import MaskGITVQGANSpec
from ..models.titok import TiTok
from ..weights import init_seeded, load_flax_params, load_npz
from ._common import add_device_args, cli_device


# the sampler's defaults of each --model: the published settings, which
# portbench/configs/titok-l32-maskgit.json and titok-s128-uvit.json run
SAMPLING = {
    "titok_l32": dict(num_sample_steps=8, guidance_scale=3.0,
                      randomize_temperature=4.5),
    "titok_s128": dict(num_sample_steps=64, guidance_scale=6.9,
                       randomize_temperature=2.8, guidance_decay="power-cosine",
                       softmax_temperature_annealing=True),
}


def titok_specs(tiny: bool, model: str = "titok_l32") -> Tuple[TiTokSpec, MaskGITVQGANSpec]:
    """TiTok's and the pixel tokenizer's specs: TiTok-L (``titok_s128``:
    TiTok-S-128) and the MaskGIT VQGAN, or the test-scale pair (the JAX
    CLI's ``--tiny``; one for both models)."""
    if not tiny:
        ts = titok_s128_spec() if model == "titok_s128" else TiTokSpec()
        return ts, MaskGITVQGANSpec()
    # GroupNorm in the pixel CNN runs 32 groups (reference parity), so even
    # the tiny spec keeps channels at multiples of 32
    return tiny_spec().titok, MaskGITVQGANSpec(
        hidden_channels=32, channel_mult=(1, 2), num_res_blocks=1,
        z_channels=32, num_embeddings=32, embedding_dim=32)


def generator_spec(titok_spec: TiTokSpec, tiny: bool,
                   model: str = "titok_l32") -> MaskGITSpec:
    """The generator's spec: MaskGIT's, or for ``titok_s128`` the U-ViT's."""
    if model == "titok_s128":
        if tiny:
            return UViTSpec(codebook_size=titok_spec.codebook_size,
                            condition_num_classes=10,
                            image_seq_len=titok_spec.num_latent_tokens,
                            hidden=64, num_layers=2, num_heads=2,
                            intermediate_size=256)
        return UViTSpec(codebook_size=titok_spec.codebook_size,
                        image_seq_len=titok_spec.num_latent_tokens)
    if tiny:
        return MaskGITSpec(codebook_size=titok_spec.codebook_size,
                           condition_num_classes=10,
                           image_seq_len=titok_spec.num_latent_tokens,
                           hidden=64, num_layers=2, num_heads=2)
    return MaskGITSpec(codebook_size=titok_spec.codebook_size,
                       image_seq_len=titok_spec.num_latent_tokens)


def _no_stray(stray: set, what: str) -> None:
    if stray:
        stray = sorted(stray)
        raise ValueError(f"{len(stray)} {what} leaves fit no parameter, "
                         f"e.g. {stray[:3]}")


def load_titok(titok_ckpt, tiny: bool, device, model: str = "titok_l32") -> TiTok:
    """TiTok on ``device`` (fp32, eval), from a reference torch checkpoint
    or seeded."""
    ts, pix = titok_specs(tiny, model)
    with torch.device(device):
        model = TiTok(ts, pix)
    if titok_ckpt:
        from ..port_titok import load_torch_state_dict, port_titok
        flat = port_titok(load_torch_state_dict(titok_ckpt), ts.num_layers,
                          num_resolutions=pix.num_resolutions,
                          num_res_blocks=pix.num_res_blocks)
        _no_stray(load_flax_params(model, flat), "TiTok checkpoint")
    else:
        print("[WARN] no --titok_ckpt given; pixel decode runs with random "
              "weights", file=sys.stderr)
        init_seeded(model, seed=0)
    return model.eval().requires_grad_(False)


def load_generator(maskgit_ckpt, titok_spec: TiTokSpec, tiny: bool,
                   device, model: str = "titok_l32") -> nn.Module:
    """The generator on ``device`` (fp32, eval): MaskGIT's from a flat
    ``params/...`` npz or seeded; the U-ViT (``titok_s128``) seeded."""
    cls = UViTGenerator if model == "titok_s128" else MaskGITGenerator
    with torch.device(device):
        gen = cls(generator_spec(titok_spec, tiny, model))
    if maskgit_ckpt:
        _no_stray(load_npz(gen, maskgit_ckpt), "generator checkpoint")
    else:
        print("[WARN] no --maskgit_ckpt given; sampling runs with random "
              "weights", file=sys.stderr)
        init_seeded(gen, seed=1)
    return gen.eval().requires_grad_(False)


def write_samples(pixels: torch.Tensor, classes, save_dir) -> list:
    """Pixels (B, H, W, 3), clipped to [0, 1], -> ``sample_class{c}_{i}.png``
    as ``(p * 255 + 0.5)`` u8 (the JAX CLI's rounding)."""
    from PIL import Image
    pixels = np.clip(pixels.float().cpu().numpy(), 0.0, 1.0)
    out = Path(save_dir)
    out.mkdir(parents=True, exist_ok=True)
    names = []
    for i, c in enumerate(classes):
        name = f"sample_class{int(c)}_{i}.png"
        Image.fromarray((pixels[i] * 255.0 + 0.5).astype(np.uint8)).save(out / name)
        names.append(name)
    return names


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Sample images from the MaskGIT prior over TiTok tokens")
    ap.add_argument("--save_dir", type=str, required=True)
    ap.add_argument("--classes", type=str, default="0",
                    help="comma-separated class ids, one image per entry")
    ap.add_argument("--titok_ckpt", type=str, default=None,
                    help="tokenizer_titok_l32.bin (torch)")
    ap.add_argument("--maskgit_ckpt", type=str, default=None,
                    help="flat params/... .npz of MaskGITGenerator "
                         "(tools/convert_params.py maskgit-to-npz)")
    ap.add_argument("--model", choices=sorted(SAMPLING), default="titok_l32",
                    help="tokenizer, generator and sampler defaults")
    ap.add_argument("--steps", type=int, default=None,
                    help="sampler steps (8; titok_s128: 64)")
    ap.add_argument("--guidance_scale", type=float, default=None,
                    help="3.0; titok_s128: 6.9, power-cosine, annealed")
    ap.add_argument("--temperature", type=float, default=None,
                    help="4.5; titok_s128: 2.8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="test-scale specs (CPU-friendly)")
    add_device_args(ap)
    args = ap.parse_args(argv)
    if args.model == "titok_s128" and (args.titok_ckpt or args.maskgit_ckpt):
        ap.error("--titok_ckpt / --maskgit_ckpt: TiTok-S-128 and U-ViT "
                 "checkpoints are not loadable yet (no key map has been "
                 "checked against the published files); leave both out to "
                 "run seeded weights")
    sampling = dict(SAMPLING[args.model])
    for key, value in (("num_sample_steps", args.steps),
                       ("guidance_scale", args.guidance_scale),
                       ("randomize_temperature", args.temperature)):
        if value is not None:
            sampling[key] = value

    dev = resolve_device(cli_device(args))
    configure_numerics()
    titok = load_titok(args.titok_ckpt, args.tiny, dev, args.model)
    gen = load_generator(args.maskgit_ckpt, titok.spec, args.tiny, dev, args.model)

    classes = [int(c) for c in args.classes.split(",") if c.strip()]
    cond = torch.tensor(classes, dtype=torch.long, device=dev)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    tokens = generate(gen, g, cond, **sampling)
    with torch.no_grad():
        pixels = titok.decode_tokens(tokens)
    names = write_samples(pixels, classes, args.save_dir)
    print(f"[OK] wrote {len(names)} samples -> {args.save_dir}")
    return names


if __name__ == "__main__":
    main()
