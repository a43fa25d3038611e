"""The port's reference-checkpoint map (``sic_tpu_torch/port.py``) against
the JAX package's ``sic_tpu/port.py``, on the CPU.

``/root/reference`` is not mounted, so the reference-format state dicts are
built here from flax-named leaves by :func:`reference_state_dict`, the
inverse of the map written independently of it from the reference's
module layout (the names each porter cites).  Each test: the port's flat
leaves equal the JAX map's flattened, leaf for leaf, and equal the leaves
the state dict was made from; and the golden params, through a torch
checkpoint file in the reference format, decode ``golden.c2df`` in the port
within the JAX package's own golden bound.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from sic_tpu_torch import config as tcfg
from sic_tpu_torch.weights import export_flax_params, init_seeded, load_flax_params
from test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "golden"

# flax segment -> reference segment, where only the name changes
_RENAMES = {
    "titok_decompress_fc": "titok_decompress_proj.0",
    "titok_decompress_ln": "titok_decompress_proj.1",
    "feat_add_ln": "feat_add.0", "feat_add_fc": "feat_add.1",
    "feat_out_down": "feat_out.1", "feat_out_ln": "feat_out.3",
    "feat_out_fc": "feat_out.4", "feat_up_conv": "init_feat_up.0",
    "mid_block_1": "mid.block_1", "mid_block_2": "mid.block_2",
    "mid_attn_1": "mid.attn_1", "convnext_0": "1", "convnext_1": "2",
}
_PRIOR_FUSION = {"merge_fc1": "merge.0", "merge_ln": "merge.1",
                 "merge_fc2": "merge.3", "ffn_ln": "ffn.0", "ffn_fc1": "ffn.1",
                 "ffn_fc2": "ffn.3"}
_DEPTH_CONV = {("depth", "conv1"): "block.0.conv1.0",
               ("depth", "depth_conv"): "block.0.depth_conv",
               ("depth", "conv2"): "block.0.conv2",
               ("depth", "adaptor"): "block.0.adaptor",
               ("ffn", "conv"): "block.1.conv", ("ffn", "conv_out"): "block.1.conv_out"}
_CONV1X1 = ("pix_emb_proj",)    # token projections the reference writes as 1x1 convs


def _ref_path(path):
    """The reference module path of a flax module path (a tuple)."""
    out, i = [], 0
    while i < len(path):
        seg = path[i]
        parent = path[i - 1] if i else None
        nxt = path[i + 1] if i + 1 < len(path) else None
        m = re.fullmatch(r"block_(\d+)", seg)
        if m:
            k = int(m[1])
            if path[0] == "prior_fusion":            # Rearrange, then the blocks
                out.append(f"1.{k}" if parent in ("titok_in", "feat_in") else str(k))
            else:                                   # rearrange wrappers at 0 and -1
                out.append(str(k + 1))
        elif seg in ("swin",):
            out.append("0")
        elif seg == "feat_out_swin":
            out.append("feat_out.0")
        elif seg == "feat_up_swin":
            out.append("init_feat_up.2")
        elif seg == "merge_swin":
            out.append("merge.4")
        elif path[0] == "prior_fusion" and seg in _PRIOR_FUSION and parent == "prior_fusion":
            out.append(_PRIOR_FUSION[seg])
        elif (seg, nxt) in _DEPTH_CONV:
            out.append(_DEPTH_CONV[(seg, nxt)])
            i += 1
        elif re.fullmatch(r"y_spatial_prior_adaptors_(\d+)", seg):
            out.append(f"y_spatial_prior_adaptor_{int(seg.rsplit('_', 1)[1]) + 1}")
        elif re.fullmatch(r"(down|up)_(\d+)_(block|attn)_(\d+)", seg):
            a, b, c, d = re.fullmatch(r"(down|up)_(\d+)_(block|attn)_(\d+)", seg).groups()
            out.append(f"{a}.{b}.{c}.{d}")
        elif re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", seg):
            a, b, c = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", seg).groups()
            out.append(f"{a}.{b}.{c}")
        elif re.fullmatch(r".+_\d+", seg) and seg.rsplit("_", 1)[0] in (
                "transformer", "inter_blocks", "feat_blocks", "attn", "y_prior_fusion",
                "y_spatial_prior", "enc_trans_0", "enc_trans_1", "dec_trans_0",
                "dec_trans_1"):
            out.extend(seg.rsplit("_", 1))
        elif seg == "mlp_fc1" and parent != "prior_fusion":
            out.append("mlp.0" if "convnext" in (parent or "") else "mlp_block.net.0")
        elif seg == "mlp_fc2" and parent != "prior_fusion":
            out.append("mlp.2" if "convnext" in (parent or "") else "mlp_block.net.2")
        else:
            out.append(_RENAMES.get(seg, seg))
        i += 1
    return ".".join(out)


def reference_state_dict(flat, prefix=""):
    """A reference-format state dict of flat ``params/...`` (and
    ``batch_stats/...``) leaves of the codec, the VQGAN or the
    discriminator."""
    sd = {}
    for key, v in flat.items():
        coll, *path, leaf = key.split("/")
        path = tuple(path)
        name = _ref_path(path) if path else ""
        if prefix:
            name = f"{prefix}.{name}" if name else prefix
        if coll == "batch_stats":
            sd[f"{name}.running_{leaf}"] = v
        elif path and path[-1] == "in_proj":
            sd[f"{name.rsplit('.', 1)[0]}.in_proj_{'weight' if leaf == 'kernel' else 'bias'}"] = \
                v.T if leaf == "kernel" else v
        elif leaf == "kernel" and v.ndim == 4:
            sd[f"{name}.weight"] = v.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and path[-1] in ("conv_out", *_CONV1X1) and path[0] == "hybrid_codec":
            sd[f"{name}.weight"] = v.T[:, :, None, None]
        elif leaf == "kernel" and path[-1] == "short":
            sd[f"{name}.weight"] = v.T[:, :, None]          # Conv1d (out, in, 1)
        elif leaf == "kernel":
            sd[f"{name}.weight"] = v.T
        elif leaf in ("scale",):
            sd[f"{name}.weight"] = v
        elif leaf == "embedding":
            sd[f"{name}.embedding.weight"] = v
        elif leaf in ("titok_pos_emb", "feat_pos_emb"):
            sd[f"{name}.{leaf}"] = v[:, None, :]
        elif leaf in ("enc_q", "dec_q", "factorized_prior_vec"):
            sd[f"{name}.{leaf}"] = v[:, :, None, None]
        elif leaf == "layer_scale":
            sd[f"{name}.{leaf}"] = v.reshape(1, -1, 1, 1)
        else:
            sd[f"{name}.{leaf}" if name else leaf] = v
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def _jax_flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _check(ours, theirs, made_from):
    assert sorted(ours) == sorted(theirs) == sorted(made_from)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
        np.testing.assert_array_equal(ours[k], made_from[k], err_msg=k)


SPEC_KW = dict(insert_pos_enc=(0, 1), insert_pos_dec=(0, 1))


@pytest.fixture(scope="module")
def codec_leaves():
    """The seeded tiny codec with cross blocks at layers 0 and 1, flat."""
    from sic_tpu_torch.models import Codec
    model = Codec(tcfg.tiny_spec(**SPEC_KW))
    init_seeded(model, 5)
    return export_flax_params(model)


def test_codec_map_matches_the_jax_package(codec_leaves):
    """port_codec_state_dict, leaf for leaf, against sic_tpu.port's; a bias
    the state dict holds beside the bias-free Swin to_qkv is left out (the
    map's t_lin(..., bias=False))."""
    from sic_tpu import port as jport
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu_torch import port
    sd = reference_state_dict(codec_leaves)
    qkv = [k for k in sd if k.endswith("attention_block.to_qkv.weight")]
    assert len(qkv) > 10
    for k in qkv:
        sd[k.replace(".weight", ".bias")] = np.ones(sd[k].shape[0], np.float32)
    ours = port.port_codec_state_dict(sd, tcfg.tiny_spec(**SPEC_KW))
    theirs = _jax_flat(jport.port_codec_state_dict(sd, jtiny(**SPEC_KW)))
    _check(ours, theirs, codec_leaves)


def test_codec_checkpoint_file_loads_into_the_codec(codec_leaves, tmp_path):
    """torch.save of the reference-format tensors under "state_dict" ->
    port_codec_checkpoint -> the Codec's parameters, every leaf consumed."""
    from sic_tpu_torch import port
    from sic_tpu_torch.models import Codec
    path = tmp_path / "codec.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               reference_state_dict(codec_leaves).items()}}, path)
    model = Codec(tcfg.tiny_spec(**SPEC_KW))
    assert not load_flax_params(model, port.port_codec_checkpoint(
        path, tcfg.tiny_spec(**SPEC_KW)))
    for k, v in export_flax_params(model).items():
        np.testing.assert_array_equal(v, codec_leaves[k], err_msg=k)


def test_golden_params_through_the_reference_format(tmp_path):
    """The golden params as a reference checkpoint file, mapped by the port
    and run by CodecRuntime: golden.c2df decodes within the JAX package's
    golden bound (tests/test_golden_fixtures.py)."""
    from sic_tpu_torch import port
    from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
    from sic_tpu_torch.models import Codec, CodecRuntime
    from test_torch_codec import _golden_bound
    with np.load(GOLDEN / "params.npz") as z:
        flat = {k: z[k] for k in z.files}
    path = tmp_path / "golden.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               reference_state_dict(flat).items()}}, path)
    spec = tcfg.tiny_spec()
    model = Codec(spec)
    assert not load_flax_params(model, port.port_codec_checkpoint(path, spec))
    rt = CodecRuntime(spec, model.eval().requires_grad_(False))
    try:
        enc, header = unpack_c2df(GOLDEN / "golden.c2df")
        u8 = rt.decode_only(**sanitize_enc_result_types(enc), z_coder=header["z_coder"],
                            coding_batch=header["coding_batch"], output="u8")
    finally:
        rt.close()
    _golden_bound(u8[0].numpy(), np.load(GOLDEN / "expected_u8.npz")["u8"])


def test_vqgan_map(tmp_path):
    """A standalone VQGAN (a taming VQModel's own state dict, no prefix)
    through port_vqgan_state_dict; the same tensors under the codec's
    ``vqgan.`` prefix through sic_tpu.port.port_vqgan."""
    from sic_tpu import port as jport
    from sic_tpu_torch import port
    from sic_tpu_torch.models import VQGAN
    spec = tcfg.tiny_spec().vqgan
    model = VQGAN(spec)
    init_seeded(model, 6)
    flat = export_flax_params(model)
    ours = port.port_vqgan_state_dict(reference_state_dict(flat), spec)
    theirs = _jax_flat({"params": jport.port_vqgan(
        reference_state_dict(flat, "vqgan"), "vqgan", spec.ch_mult,
        spec.num_res_blocks, spec.attn_resolutions, spec.resolution, spec.use_attn)})
    _check(ours, theirs, flat)
    fresh = VQGAN(spec)
    assert not load_flax_params(fresh, ours)


def test_discriminator_map():
    """NLayerDiscriminator: parameters and the BatchNorm statistics
    (batch_stats) through port_discriminator, against sic_tpu.port's
    (params, batch_stats) pair."""
    from sic_tpu import port as jport
    from sic_tpu_torch import port
    from sic_tpu_torch.models.discriminator import NLayerDiscriminator
    model = NLayerDiscriminator(ndf=16)
    init_seeded(model, 7)
    with torch.no_grad():
        for name, b in model.named_buffers():
            b.copy_(torch.rand(b.shape) + (0.5 if name.endswith("var") else 0.0))
    flat = export_flax_params(model)
    assert any(k.startswith("batch_stats/") for k in flat)
    sd = _sequential(reference_state_dict(flat, "main"))
    ours = port.port_discriminator(sd)
    params, stats = jport.port_discriminator({f"loss.discriminator.{k}": v
                                              for k, v in sd.items()},
                                             "loss.discriminator")
    theirs = {**_jax_flat({"params": params}), **_jax_flat({"batch_stats": stats})}
    _check(ours, theirs, flat)
    fresh = NLayerDiscriminator(ndf=16)
    assert not load_flax_params(fresh, ours)


def _sequential(sd):
    """The discriminator's flax names -> its reference Sequential ``main``:
    conv_0 at 0, then (conv_n, bn_n) at 3n - 1 and 3n, conv_out last."""
    out = {}
    for k, v in sd.items():
        m = re.fullmatch(r"main\.(conv|bn)_(\d+)\.(.+)", k)
        if m:
            kind, n, leaf = m[1], int(m[2]), m[3]
            idx = 0 if n == 0 else 3 * n - 1 + (kind == "bn")
            out[f"main.{idx}.{leaf}"] = v
            continue
        m = re.fullmatch(r"main\.conv_out\.(.+)", k)
        assert m, k
        out[f"main.LAST.{m[1]}"] = v
    last = max(int(k.split(".")[1]) for k in out if not k.startswith("main.LAST")) + 2
    return {k.replace("main.LAST", f"main.{last}"): v for k, v in out.items()}
