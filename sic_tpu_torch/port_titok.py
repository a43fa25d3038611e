"""Reference TiTok checkpoints -> the port's flat ``params/...`` dict.

The port's own copy of the part of the JAX package's reference-checkpoint
map (``sic_tpu/port.py``) that the full TiTok tokenizer and the
MaskGIT-VQGAN tokenizer need: the reference names and layouts (torch
``state_dict`` of ``titok/titok.py``) go to the JAX package's flax names,
flattened with ``/``, which ``weights.load_flax_params`` loads into
:class:`~sic_tpu_torch.models.titok.TiTok` or
:class:`~sic_tpu_torch.models.titok.PretrainedTokenizer`.  Conventions:

- Conv2d OIHW -> HWIO ``kernel``; Linear (out, in) -> ``kernel`` (in, out);
- a 1x1 Conv used as a token projection -> a Dense ``kernel``;
- ``nn.MultiheadAttention``'s packed ``in_proj`` / ``out_proj`` -> the
  ``MultiheadSelfAttention`` leaves;
- LayerNorm / GroupNorm ``weight`` -> ``scale``.

The rest of the JAX package's map (the hybrid codec, the VQGAN, FeatMerge,
the discriminator) and the primitives both use are in ``port.py``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

# load_torch_state_dict is this module's name for callers of the TiTok map
from .port import (_resnet, flatten, load_torch_state_dict,  # noqa: F401
                   t_conv, t_conv1x1_as_dense, t_lin, t_norm, t_rab)


# -- the MaskGIT-VQGAN and TiTok maps (sic_tpu/port.py:313-430) ----------------

def port_maskgit_encoder(sd, p, num_resolutions: int = 5,
                         num_res_blocks: int = 2):
    """(reference: titok/maskgit_vqgan.py:159-198)"""
    out = {"conv_in": t_conv(sd, f"{p}.conv_in"),
           "norm_out": t_norm(sd, f"{p}.norm_out"),
           "conv_out": t_conv(sd, f"{p}.conv_out")}
    for i in range(num_resolutions):
        for j in range(num_res_blocks):
            out[f"down_{i}_block_{j}"] = _resnet(sd, f"{p}.down.{i}.block.{j}")
    for j in range(num_res_blocks):
        out[f"mid_{j}"] = _resnet(sd, f"{p}.mid.{j}")
    return out


def port_maskgit_decoder(sd, p, num_resolutions: int = 5,
                         num_res_blocks: int = 2):
    """(reference: titok/maskgit_vqgan.py:201-266; the state dict's
    ``up.{i}`` is block_idx after the double reversal at :225-229)"""
    out = {"conv_in": t_conv(sd, f"{p}.conv_in"),
           "norm_out": t_norm(sd, f"{p}.norm_out"),
           "conv_out": t_conv(sd, f"{p}.conv_out")}
    for j in range(num_res_blocks):
        out[f"mid_{j}"] = _resnet(sd, f"{p}.mid.{j}")
    for i in range(num_resolutions):
        for j in range(num_res_blocks):
            out[f"up_{i}_block_{j}"] = _resnet(sd, f"{p}.up.{i}.block.{j}")
        if i != 0:
            out[f"up_{i}_upsample_conv"] = t_conv(sd, f"{p}.up.{i}.upsample_conv")
    return out


def port_pretrained_tokenizer(sd, num_resolutions: int = 5,
                              num_res_blocks: int = 2) -> Dict[str, np.ndarray]:
    """The frozen MaskGIT-VQGAN tokenizer (reference: titok/titok.py:30-52),
    flat."""
    return flatten({
        "encoder": port_maskgit_encoder(sd, "encoder", num_resolutions,
                                        num_res_blocks),
        "decoder": port_maskgit_decoder(sd, "decoder", num_resolutions,
                                        num_res_blocks),
        "quantize": {"embedding": sd["quantize.embedding.weight"]},
    })


def port_titok_encoder(sd, p, num_layers: int):
    """Plain TiTokEncoder (reference: titok/blocks.py:71-144)."""
    out = {
        "patch_embed": t_conv(sd, f"{p}.patch_embed"),
        "class_embedding": sd[f"{p}.class_embedding"],
        "positional_embedding": sd[f"{p}.positional_embedding"],
        "latent_token_positional_embedding":
            sd[f"{p}.latent_token_positional_embedding"],
        "ln_pre": t_norm(sd, f"{p}.ln_pre"),
        "ln_post": t_norm(sd, f"{p}.ln_post"),
        "conv_out": t_conv1x1_as_dense(sd, f"{p}.conv_out"),
    }
    for i in range(num_layers):
        out[f"transformer_{i}"] = t_rab(sd, f"{p}.transformer.{i}")
    return out


def port_titok_decoder(sd, p, num_layers: int):
    """Plain TiTokDecoder with the pixel ffn head
    (reference: titok/blocks.py:147-224)."""
    out = {
        "decoder_embed": t_lin(sd, f"{p}.decoder_embed"),
        "class_embedding": sd[f"{p}.class_embedding"],
        "positional_embedding": sd[f"{p}.positional_embedding"],
        "mask_token": sd[f"{p}.mask_token"],
        "latent_token_positional_embedding":
            sd[f"{p}.latent_token_positional_embedding"],
        "ln_pre": t_norm(sd, f"{p}.ln_pre"),
        "ln_post": t_norm(sd, f"{p}.ln_post"),
        "ffn_fc1": t_conv1x1_as_dense(sd, f"{p}.ffn.0"),
        "ffn_fc2": t_conv1x1_as_dense(sd, f"{p}.ffn.2"),
    }
    for i in range(num_layers):
        out[f"transformer_{i}"] = t_rab(sd, f"{p}.transformer.{i}")
    return out


def port_titok(sd, num_layers: int, num_resolutions: int = 5,
               num_res_blocks: int = 2) -> Dict[str, np.ndarray]:
    """A full TiTok checkpoint -> the port's flat TiTok params
    (reference module layout: titok/titok.py:73-103)."""
    return flatten({
        "encoder": port_titok_encoder(sd, "encoder", num_layers),
        "decoder": port_titok_decoder(sd, "decoder", num_layers),
        "latent_tokens": sd["latent_tokens"],
        "quantize": {"embedding": sd["quantize.embedding.weight"]},
        "pixel_quantize": {"embedding": sd["pixel_quantize.embedding.weight"]},
        "pixel_decoder": port_maskgit_decoder(sd, "pixel_decoder",
                                              num_resolutions, num_res_blocks),
    })
