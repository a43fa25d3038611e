"""Reference torch checkpoints -> the port's flat ``params/...`` dicts.

The port's own copy of the JAX package's reference-checkpoint map
(``sic_tpu/port.py``): a reference state dict (torch names and layouts of
the reference's ``Codec``, VQGAN or discriminator) goes to the JAX
package's flax names, flattened with ``/``, which
``weights.load_flax_params`` loads into the port's
:class:`~sic_tpu_torch.models.Codec`,
:class:`~sic_tpu_torch.models.VQGAN` or
:class:`~sic_tpu_torch.models.discriminator.NLayerDiscriminator`.  So a
reference ``.ckpt`` runs in ``CodecRuntime`` on a machine with neither
flax nor JAX::

    flat = port_codec_checkpoint("reference_codec.ckpt", spec)
    model = Codec(spec); load_flax_params(model, flat)

Conventions translated:

- Conv2d OIHW -> HWIO ``kernel``; Linear (out, in) -> ``kernel`` (in, out);
- a 1x1 Conv used as a token projection -> a Dense ``kernel``;
- ``nn.MultiheadAttention``'s packed ``in_proj`` / ``out_proj`` -> the
  ``MultiheadSelfAttention`` leaves;
- LayerNorm / GroupNorm ``weight`` -> ``scale``;
- per-channel (1, C, 1, 1) / (b, C, 1, 1) parameters -> (C,) / (b, C).

Buffers that the port derives (Swin shift masks, relative indices) are not
read.  The TiTok and MaskGIT-VQGAN maps are in ``port_titok.py``, on the
primitives here.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """A torch checkpoint (a state dict, or a dict holding one under
    ``state_dict``) as f32 numpy arrays."""
    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.detach().cpu().float().numpy() for k, v in sd.items()}


def flatten(tree: dict, prefix: str = "params") -> Dict[str, np.ndarray]:
    """A nested flax-named tree -> ``{"params/a/b/leaf": array}``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


# -- primitive converters (sic_tpu/port.py:25-155) -----------------------------

def t_conv(sd, p):
    out = {"kernel": sd[f"{p}.weight"].transpose(2, 3, 1, 0)}
    if f"{p}.bias" in sd:
        out["bias"] = sd[f"{p}.bias"]
    return out


def t_lin(sd, p, bias: bool = True):
    """Linear (out, in) -> Dense kernel (in, out); ``bias=False`` leaves
    out a bias the state dict holds beside a bias-free Dense (the Swin
    blocks' ``to_qkv``)."""
    out = {"kernel": sd[f"{p}.weight"].T}
    if bias and f"{p}.bias" in sd:
        out["bias"] = sd[f"{p}.bias"]
    return out


def t_conv1x1_as_dense(sd, p):
    out = {"kernel": sd[f"{p}.weight"][:, :, 0, 0].T}
    if f"{p}.bias" in sd:
        out["bias"] = sd[f"{p}.bias"]
    return out


def t_norm(sd, p):
    return {"scale": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]}


def t_mha(sd, p):
    """nn.MultiheadAttention -> MultiheadSelfAttention."""
    return {"in_proj": {"kernel": sd[f"{p}.in_proj_weight"].T,
                        "bias": sd[f"{p}.in_proj_bias"]},
            "out_proj": t_lin(sd, f"{p}.out_proj")}


def t_rab(sd, p):
    """ResidualAttentionBlock (reference: titok/blocks.py:26-64)."""
    out = {"ln_1": t_norm(sd, f"{p}.ln_1"), "attn": t_mha(sd, f"{p}.attn")}
    if f"{p}.ln_2.weight" in sd:
        out["ln_2"] = t_norm(sd, f"{p}.ln_2")
        out["mlp"] = {"c_fc": t_lin(sd, f"{p}.mlp.c_fc"),
                      "c_proj": t_lin(sd, f"{p}.mlp.c_proj")}
    return out


# -- the codec's modules (sic_tpu/port.py:81-310) -------------------------------

def _resnet(sd, q):
    """A taming / MaskGIT ResnetBlock."""
    out = {"norm1": t_norm(sd, f"{q}.norm1"), "conv1": t_conv(sd, f"{q}.conv1"),
           "norm2": t_norm(sd, f"{q}.norm2"), "conv2": t_conv(sd, f"{q}.conv2")}
    if f"{q}.nin_shortcut.weight" in sd:
        out["nin_shortcut"] = t_conv(sd, f"{q}.nin_shortcut")
    return out


def t_swin_block(sd, p):
    """SwinBlock (reference: blocks/swin_transformer.py:131-156)."""
    ab = f"{p}.attention_block"
    return {
        "norm_attn": t_norm(sd, f"{p}.norm_attn"),
        "attention_block": {
            "to_qkv": t_lin(sd, f"{ab}.to_qkv", bias=False),
            "pos_embedding": sd[f"{ab}.pos_embedding"],
            "to_out": t_lin(sd, f"{ab}.to_out"),
        },
        "norm_mlp": t_norm(sd, f"{p}.norm_mlp"),
        "mlp_fc1": t_lin(sd, f"{p}.mlp_block.net.0"),
        "mlp_fc2": t_lin(sd, f"{p}.mlp_block.net.2"),
    }


def t_swin_stack(sd, p, n, base: int = 1):
    """A get_swin Sequential: blocks at indices base..base+n-1 (the BCHW
    rearrange wrappers take 0 and -1 with auto_bchw, reference:
    codec_sq_fixbpp.py:33-45)."""
    return {f"block_{i}": t_swin_block(sd, f"{p}.{base + i}") for i in range(n)}


def t_convnext(sd, p):
    """(reference: blocks/conv_blocks.py:48-81)"""
    out = {
        "layer_scale": sd[f"{p}.layer_scale"].reshape(-1),
        "conv": t_conv(sd, f"{p}.conv"),
        "norm": t_norm(sd, f"{p}.norm"),
        "mlp_fc1": t_lin(sd, f"{p}.mlp.0"),
        "mlp_fc2": t_lin(sd, f"{p}.mlp.2"),
    }
    if f"{p}.short.weight" in sd:  # Conv1d (out, in, 1)
        out["short"] = {"kernel": sd[f"{p}.short.weight"][:, :, 0].T,
                        "bias": sd[f"{p}.short.bias"]}
    return out


def t_depthconvblock4(sd, p):
    """(reference: blocks/dcvc.py:57-66; inner names block.0 / block.1)"""
    depth = {
        "conv1": t_conv(sd, f"{p}.block.0.conv1.0"),
        "depth_conv": t_conv(sd, f"{p}.block.0.depth_conv"),
        "conv2": t_conv(sd, f"{p}.block.0.conv2"),
    }
    if f"{p}.block.0.adaptor.weight" in sd:
        depth["adaptor"] = t_conv(sd, f"{p}.block.0.adaptor")
    return {"depth": depth,
            "ffn": {"conv": t_conv(sd, f"{p}.block.1.conv"),
                    "conv_out": t_conv(sd, f"{p}.block.1.conv_out")}}


def t_cross(sd, p, num_attns):
    """Interactive_crossAttn_type4 (reference: models/cross_blocks.py:39-98)."""
    out = {
        "titok_pos_emb": sd[f"{p}.titok_pos_emb"][:, 0, :],
        "feat_pos_emb": sd[f"{p}.feat_pos_emb"][:, 0, :],
        "titok_compress_proj": t_lin(sd, f"{p}.titok_compress_proj"),
        "titok_decompress_fc": t_lin(sd, f"{p}.titok_decompress_proj.0"),
        "titok_decompress_ln": t_norm(sd, f"{p}.titok_decompress_proj.1"),
        "feat_add_ln": t_norm(sd, f"{p}.feat_add.0"),
        "feat_add_fc": t_lin(sd, f"{p}.feat_add.1"),
        "zero_add": t_lin(sd, f"{p}.zero_add"),
    }
    for j in range(num_attns):
        out[f"attn_{j}"] = t_rab(sd, f"{p}.attn.{j}")
    return out


def t_featblock(sd, p):
    """Swin x2 + ConvNeXt x2 (reference: codec_sq_fixbpp.py:75-79)."""
    return {"swin": t_swin_stack(sd, f"{p}.0", 2, base=1),
            "convnext_0": t_convnext(sd, f"{p}.1"),
            "convnext_1": t_convnext(sd, f"{p}.2")}


def _trunk(sd, p, out, num_layers, insert_pos, num_attns):
    """The transformer layers, and the cross blocks and feature refiners at
    the insert positions inside the trunk (the modules drop the others, as
    the JAX package's do)."""
    for i in range(num_layers):
        out[f"transformer_{i}"] = t_rab(sd, f"{p}.transformer.{i}")
    for i in (i for i in insert_pos if i < num_layers):
        out[f"inter_blocks_{i}"] = t_cross(sd, f"{p}.inter_blocks.{i}", num_attns)
        out[f"feat_blocks_{i}"] = t_featblock(sd, f"{p}.feat_blocks.{i}")
    return out


def port_hybrid_encoder(sd, p, num_layers: int, insert_pos: Sequence[int],
                        num_attns: int):
    """(reference: codec_sq_fixbpp.py:48-183 + titok/blocks.py:71-144)"""
    out = {
        "patch_embed": t_conv(sd, f"{p}.patch_embed"),
        "class_embedding": sd[f"{p}.class_embedding"],
        "positional_embedding": sd[f"{p}.positional_embedding"],
        "latent_token_positional_embedding":
            sd[f"{p}.latent_token_positional_embedding"],
        "ln_pre": t_norm(sd, f"{p}.ln_pre"),
        "ln_post": t_norm(sd, f"{p}.ln_post"),
        "conv_out": t_conv1x1_as_dense(sd, f"{p}.conv_out"),
        "pix_emb_proj": t_conv1x1_as_dense(sd, f"{p}.pix_emb_proj"),
        "feat_in": t_swin_stack(sd, f"{p}.feat_in", 4, base=1),
        "feat_out_swin": t_swin_stack(sd, f"{p}.feat_out.0", 2, base=1),
        "feat_out_down": t_conv(sd, f"{p}.feat_out.1"),
        "feat_out_ln": t_norm(sd, f"{p}.feat_out.3"),
        "feat_out_fc": t_lin(sd, f"{p}.feat_out.4"),
    }
    return _trunk(sd, p, out, num_layers, insert_pos, num_attns)


def port_hybrid_decoder(sd, p, num_layers: int, insert_pos: Sequence[int],
                        num_attns: int):
    """(reference: codec_sq_fixbpp.py:186-300 + titok/blocks.py:147-224)"""
    out = {
        "decoder_embed": t_lin(sd, f"{p}.decoder_embed"),
        "class_embedding": sd[f"{p}.class_embedding"],
        "positional_embedding": sd[f"{p}.positional_embedding"],
        "mask_token": sd[f"{p}.mask_token"],
        "latent_token_positional_embedding":
            sd[f"{p}.latent_token_positional_embedding"],
        "ln_pre": t_norm(sd, f"{p}.ln_pre"),
        "ln_post": t_norm(sd, f"{p}.ln_post"),
        "feat_up_conv": t_conv(sd, f"{p}.init_feat_up.0"),
        "feat_up_swin": t_swin_stack(sd, f"{p}.init_feat_up.2", 4, base=1),
    }
    return _trunk(sd, p, out, num_layers, insert_pos, num_attns)


def port_bottleneck(sd, p):
    """(reference: models/sq_bottleneck.py:55-100)"""
    out = {
        "enc_q": sd[f"{p}.enc_q"][:, :, 0, 0],
        "dec_q": sd[f"{p}.dec_q"][:, :, 0, 0],
        "factorized_prior_vec": sd[f"{p}.factorized_prior_vec"][:, :, 0, 0],
        "y_spatial_prior_reduction": t_conv(sd, f"{p}.y_spatial_prior_reduction"),
    }
    for name, n in (("enc_trans_0", 2), ("enc_trans_1", 2),
                    ("dec_trans_0", 2), ("dec_trans_1", 2),
                    ("y_prior_fusion", 2), ("y_spatial_prior", 3)):
        for i in range(n):
            out[f"{name}_{i}"] = t_depthconvblock4(sd, f"{p}.{name}.{i}")
    for i in range(3):
        out[f"y_spatial_prior_adaptors_{i}"] = t_depthconvblock4(
            sd, f"{p}.y_spatial_prior_adaptor_{i + 1}")
    return out


def port_vqgan(sd, p, ch_mult: Tuple[int, ...], num_res_blocks: int,
               attn_resolutions: Tuple[int, ...], resolution: int,
               use_attn: bool = True):
    """(reference: taming/modules/diffusionmodules/model.py:342-537,
    taming/models/vqgan.py:28-36)"""
    def attn(q):
        return {"norm": t_norm(sd, f"{q}.norm"), "q": t_conv(sd, f"{q}.q"),
                "k": t_conv(sd, f"{q}.k"), "v": t_conv(sd, f"{q}.v"),
                "proj_out": t_conv(sd, f"{q}.proj_out")}

    n_res = len(ch_mult)

    def ends(q):
        out = {"conv_in": t_conv(sd, f"{q}.conv_in"),
               "mid_block_1": _resnet(sd, f"{q}.mid.block_1"),
               "mid_block_2": _resnet(sd, f"{q}.mid.block_2"),
               "norm_out": t_norm(sd, f"{q}.norm_out"),
               "conv_out": t_conv(sd, f"{q}.conv_out")}
        if use_attn:
            out["mid_attn_1"] = attn(f"{q}.mid.attn_1")
        return out

    def encoder(q):
        out = ends(q)
        curr = resolution
        for i in range(n_res):
            for j in range(num_res_blocks):
                out[f"down_{i}_block_{j}"] = _resnet(sd, f"{q}.down.{i}.block.{j}")
                if use_attn and curr in attn_resolutions:
                    out[f"down_{i}_attn_{j}"] = attn(f"{q}.down.{i}.attn.{j}")
            if i != n_res - 1:
                out[f"down_{i}_downsample"] = {
                    "conv": t_conv(sd, f"{q}.down.{i}.downsample.conv")}
                curr //= 2
        return out

    def decoder(q):
        out = ends(q)
        curr = resolution // (2 ** (n_res - 1))
        for i in reversed(range(n_res)):
            for j in range(num_res_blocks + 1):
                out[f"up_{i}_block_{j}"] = _resnet(sd, f"{q}.up.{i}.block.{j}")
                if use_attn and curr in attn_resolutions:
                    out[f"up_{i}_attn_{j}"] = attn(f"{q}.up.{i}.attn.{j}")
            if i != 0:
                out[f"up_{i}_upsample"] = {
                    "conv": t_conv(sd, f"{q}.up.{i}.upsample.conv")}
                curr *= 2
        return out

    q = f"{p}." if p else ""       # "": a taming VQModel's own state dict
    return {"encoder": encoder(f"{q}encoder"),
            "decoder": decoder(f"{q}decoder"),
            "quantize": {"embedding": sd[f"{q}quantize.embedding.weight"]},
            "quant_conv": t_conv(sd, f"{q}quant_conv"),
            "post_quant_conv": t_conv(sd, f"{q}post_quant_conv")}


def port_featmerge(sd, p):
    """(reference: codec_sq_fixbpp.py:395-439; the auto_bchw=False stacks
    sit behind an explicit Rearrange, so their blocks start at index 0)"""
    return {
        "titok_in": t_swin_stack(sd, f"{p}.titok_in.1", 2, base=0),
        "feat_in": t_swin_stack(sd, f"{p}.feat_in.1", 2, base=0),
        "merge_fc1": t_lin(sd, f"{p}.merge.0"),
        "merge_ln": t_norm(sd, f"{p}.merge.1"),
        "merge_fc2": t_lin(sd, f"{p}.merge.3"),
        "merge_swin": t_swin_stack(sd, f"{p}.merge.4", 4, base=0),
        "ffn_ln": t_norm(sd, f"{p}.ffn.0"),
        "ffn_fc1": t_lin(sd, f"{p}.ffn.1"),
        "ffn_fc2": t_lin(sd, f"{p}.ffn.3"),
    }


# -- whole models (sic_tpu/port.py:431-478) --------------------------------------

def port_discriminator(sd, p: str = "", n_layers: int = 3) -> Dict[str, np.ndarray]:
    """NLayerDiscriminator (reference: taming/modules/discriminator/
    model.py:17-67; a Sequential ``main`` with BatchNorm between convs),
    flat: ``params/...`` and the BatchNorm statistics as
    ``batch_stats/<bn>/{mean,var}``."""
    q = f"{p}." if p else ""
    params = {"conv_0": t_conv(sd, f"{q}main.0")}
    stats = {}
    idx = 2
    for n in range(1, n_layers + 1):
        params[f"conv_{n}"] = {"kernel": sd[f"{q}main.{idx}.weight"].transpose(2, 3, 1, 0)}
        bn = f"{q}main.{idx + 1}"
        params[f"bn_{n}"] = t_norm(sd, bn)
        stats[f"bn_{n}"] = {"mean": sd[f"{bn}.running_mean"],
                            "var": sd[f"{bn}.running_var"]}
        idx += 3
    params["conv_out"] = t_conv(sd, f"{q}main.{idx}")
    return {**flatten(params), **flatten(stats, "batch_stats")}


def port_vqgan_state_dict(sd, spec, p: str = "") -> Dict[str, np.ndarray]:
    """A reference VQGAN (taming ``VQModel``) state dict -> the port's flat
    :class:`~sic_tpu_torch.models.VQGAN` params, at ``spec``
    (a ``VQGANSpec``)."""
    return flatten(port_vqgan(sd, p, spec.ch_mult, spec.num_res_blocks,
                              spec.attn_resolutions, spec.resolution,
                              spec.use_attn))


def port_codec_state_dict(sd: Dict[str, np.ndarray], spec) -> Dict[str, np.ndarray]:
    """A full reference Codec state dict -> the port's flat Codec params
    (reference module layout: codec_sq_fixbpp.py:442-491: hybrid_codec.*,
    vqgan.*, prior_fusion.*)."""
    t = spec.titok
    hc = {
        "encoder": port_hybrid_encoder(sd, "hybrid_codec.encoder", t.num_layers,
                                       spec.insert_pos_enc, spec.num_attns),
        "decoder": port_hybrid_decoder(sd, "hybrid_codec.decoder", t.num_layers,
                                       spec.insert_pos_dec, spec.num_attns),
        "latent_tokens": sd["hybrid_codec.latent_tokens"],
        "quantize": {"embedding": sd["hybrid_codec.quantize.embedding.weight"]},
        "quantize_feat": port_bottleneck(sd, "hybrid_codec.quantize_feat"),
    }
    v = spec.vqgan
    return flatten({
        "hybrid_codec": hc,
        "vqgan": port_vqgan(sd, "vqgan", v.ch_mult, v.num_res_blocks,
                            v.attn_resolutions, v.resolution, v.use_attn),
        "prior_fusion": port_featmerge(sd, "prior_fusion"),
    })


def port_codec_checkpoint(path, spec) -> Dict[str, np.ndarray]:
    """A reference Codec checkpoint file -> the port's flat Codec params."""
    return port_codec_state_dict(load_torch_state_dict(path), spec)
