"""The port's TiTok tokenizer and MaskGIT-VQGAN pixel path against the JAX
package's, on the CPU.

The JAX modules are initialised once (module-scoped fixtures), their
biases and norm parameters perturbed from numpy so that no leaf is zero
or one, and the same flat ``params/...`` leaves go into the port through
``weights.load_flax_params``; the same numpy inputs go through both.
Tolerances: each module 1e-4 (f32; the frameworks sum in other orders),
the soft decode 1e-5, the whole tokenizer 1e-3 (pixels and latents);
discrete outputs (TiTok token ids, pixel-codebook indices) exactly.
Sequence attention runs through its plain version on both sides
(``_seq_attn_reference`` in the JAX package, as its CPU path does).

Specs: ``tiny_spec().titok`` with 64-px tiles (grid 4), and the generate
CLI's tiny pixel spec (32 channels, multipliers (1, 2), one block a
level, 32 codes of 32).
"""
import dataclasses
import re

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import jax
import jax.numpy as jnp

from sic_tpu_torch.config import tiny_spec
from sic_tpu_torch.cli.generate import titok_specs
from sic_tpu_torch.weights import load_flax_params
from test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

MODULE_TOL = 1e-4
SOFT_TOL = 1e-5
SLICE_TOL = 1e-3
TILE = 64


def _close(a, b, tol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def _perturbed(variables, seed):
    """Flat f32 numpy leaves of a JAX init, with every bias and norm scale
    moved by N(0, 0.02) noise (flax initialises them to 0 and 1)."""
    rng = np.random.default_rng(seed)
    flat = {k: np.asarray(v, np.float32)
            for k, v in flatten_dict(variables, sep="/").items()}
    for k, v in flat.items():
        if k.endswith(("/bias", "/scale")):
            flat[k] = (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32)
    return flat


def _tree(flat, prefix="params/"):
    """The JAX variables of the leaves under ``prefix`` (a module's own)."""
    sub = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    return {"params": unflatten_dict({k: jnp.asarray(v) for k, v in sub.items()},
                                     sep="/")}


def _port(module, flat, prefix="params/"):
    """``module`` with the leaves under ``prefix``; every leaf consumed."""
    sub = {"params/" + k[len(prefix):]: v for k, v in flat.items()
           if k.startswith(prefix)}
    assert not load_flax_params(module, sub)
    return module.eval()


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def specs():
    ts, pix = titok_specs(tiny=True)
    return dataclasses.replace(ts, tile_px=TILE), pix


@pytest.fixture(scope="module")
def jax_titok(specs):
    """The JAX TiTok, its perturbed flat leaves, and the port's twin."""
    from sic_tpu.models.hybrid import TiTokSpec as JSpec
    from sic_tpu.models.maskgit_vqgan import MaskGITVQGANSpec as JPix
    from sic_tpu.models.titok import TiTok as JTiTok
    from sic_tpu_torch.models.titok import TiTok
    ts, pix = specs
    jm = JTiTok(JSpec(**dataclasses.asdict(ts)), JPix(**dataclasses.asdict(pix)))
    flat = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                       jnp.zeros((1, TILE, TILE, 3))), 1)
    return jm, flat, _port(TiTok(ts, pix), flat)


@pytest.fixture(scope="module")
def jax_tokenizer(specs):
    from sic_tpu.models.maskgit_vqgan import MaskGITVQGANSpec as JPix
    from sic_tpu.models.titok import PretrainedTokenizer as JTok
    from sic_tpu_torch.models.titok import PretrainedTokenizer
    pix = specs[1]
    jm = JTok(JPix(**dataclasses.asdict(pix)))
    flat = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(2),
                                       jnp.zeros((1, 16, 16, 3))), 3)
    return jm, flat, _port(PretrainedTokenizer(pix), flat)


# -- modules -------------------------------------------------------------------

@pytest.mark.parametrize("block", ["mid_0", "up_0_block_0"])
def test_pixel_resnet_block(jax_titok, specs, block):
    """mid_0: equal channels (64 -> 64); up_0_block_0: 64 -> 32, whose 1x1
    shortcut reads the block's output (the upstream quirk)."""
    from sic_tpu.models.maskgit_vqgan import PixelResnetBlock as JBlock
    from sic_tpu_torch.models.maskgit_vqgan import PixelResnetBlock
    _, flat, _ = jax_titok
    out_ch = 64 if block == "mid_0" else 32
    m = _port(PixelResnetBlock(64, out_ch), flat, f"params/pixel_decoder/{block}/")
    assert hasattr(m, "nin_shortcut") == (out_ch != 64)
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 64)).astype(np.float32)
    ref = JBlock(out_ch).apply(_tree(flat, f"params/pixel_decoder/{block}/"),
                               jnp.asarray(x))
    _close(m(torch.from_numpy(x)), ref, MODULE_TOL)


def test_pixel_encoder(jax_tokenizer, specs):
    from sic_tpu.models.maskgit_vqgan import MaskGITVQGANSpec as JPix
    from sic_tpu.models.maskgit_vqgan import PixelEncoder as JEnc
    jm, flat, tok = jax_tokenizer
    x = _images((2, 16, 16, 3), 5)
    ref = JEnc(JPix(**dataclasses.asdict(specs[1]))).apply(
        _tree(flat, "params/encoder/"), jnp.asarray(x))
    _close(tok.encoder(torch.from_numpy(x)), ref, MODULE_TOL)


@pytest.mark.parametrize("return_latent", [False, True])
def test_pixel_decoder(jax_titok, specs, return_latent):
    from sic_tpu.models.maskgit_vqgan import MaskGITVQGANSpec as JPix
    from sic_tpu.models.maskgit_vqgan import PixelDecoder as JDec
    _, flat, titok = jax_titok
    z = np.random.default_rng(6).standard_normal((2, 4, 4, 32)).astype(np.float32)
    ref = JDec(JPix(**dataclasses.asdict(specs[1]))).apply(
        _tree(flat, "params/pixel_decoder/"), jnp.asarray(z),
        return_latent=return_latent)
    got = titok.pixel_decoder(torch.from_numpy(z), return_latent=return_latent)
    if return_latent:
        assert got[1].shape == (2, 8, 8, 32)
        for a, b in zip(got, ref):
            _close(a, b, MODULE_TOL)
    else:
        _close(got, ref, MODULE_TOL)


def test_pixel_quantizer_and_soft_decode(jax_titok, specs):
    """Nearest-code indices exactly, the codebook entries they pick, and
    the f32 soft decode within 1e-5."""
    from sic_tpu.models.maskgit_vqgan import PixelQuantizer as JQ
    _, flat, titok = jax_titok
    pix = specs[1]
    jq = JQ(pix.num_embeddings, pix.embedding_dim)
    v = _tree(flat, "params/pixel_quantize/")
    rng = np.random.default_rng(7)
    z = (0.05 * rng.standard_normal((2, 4, 4, 32))).astype(np.float32)
    zq_ref, idx_ref = jq.apply(v, jnp.asarray(z))
    zq, idx = titok.pixel_quantize(torch.from_numpy(z))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    _close(zq, zq_ref, 0)
    codes = idx.reshape(2, 16)
    _close(titok.pixel_quantize.get_codebook_entry(codes),
           jq.apply(v, jnp.asarray(codes.numpy()), method=jq.get_codebook_entry), 0)
    logits = (3 * rng.standard_normal((2, 4, 4, 32))).astype(np.float32)
    _close(titok.pixel_quantize.soft_decode(torch.from_numpy(logits)),
           jq.apply(v, jnp.asarray(logits), method=jq.soft_decode), SOFT_TOL)


def test_titok_encoder_vit_and_token_ids(jax_titok, specs):
    """The encoder's tokens within 1e-4 (the "fake 2D" channel scramble
    included) and the L2 quantizer's ids on them exactly."""
    from sic_tpu.models.hybrid import TiTokSpec as JSpec
    from sic_tpu.models.quantizer import L2VectorQuantizer as JQ
    from sic_tpu.models.titok import TiTokEncoderViT as JEnc
    _, flat, titok = jax_titok
    ts = specs[0]
    x = _images((2, TILE, TILE, 3), 8)
    lat = flat["params/latent_tokens"]
    ref = jax.jit(JEnc(JSpec(**dataclasses.asdict(ts))).apply)(
        _tree(flat, "params/encoder/"), jnp.asarray(x), jnp.asarray(lat))
    z = titok.encoder(torch.from_numpy(x), torch.from_numpy(lat))
    _close(z, ref, MODULE_TOL)
    _, res = JQ(ts.codebook_size, ts.token_size).apply(
        _tree(flat, "params/quantize/"), ref)
    np.testing.assert_array_equal(titok.quantize.encode_indices(z).numpy(),
                                  np.asarray(res["min_encoding_indices"]))


def test_titok_decoder_vit(jax_titok, specs):
    from sic_tpu.models.hybrid import TiTokSpec as JSpec
    from sic_tpu.models.titok import TiTokDecoderViT as JDec
    _, flat, titok = jax_titok
    ts, pix = specs
    z = np.random.default_rng(9).standard_normal((2, ts.num_latent_tokens,
                                                  ts.token_size)).astype(np.float32)
    ref = JDec(JSpec(**dataclasses.asdict(ts)), pix.num_embeddings).apply(
        _tree(flat, "params/decoder/"), jnp.asarray(z))
    got = titok.decoder(torch.from_numpy(z))
    assert got.shape == (2, ts.grid_size, ts.grid_size, pix.num_embeddings)
    _close(got, ref, MODULE_TOL)


# -- the slice -----------------------------------------------------------------

@torch.no_grad()
def test_titok_forward_and_decode_tokens(jax_titok):
    """Image -> tokens -> image: token ids exactly, pixels within 1e-3;
    decode_tokens on those ids likewise."""
    jm, flat, titok = jax_titok
    v = _tree(flat)
    x = _images((2, TILE, TILE, 3), 10)
    ref_img, ref_res = jm.apply(v, jnp.asarray(x))
    img, res = titok(torch.from_numpy(x))
    ids = res["min_encoding_indices"]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_res["min_encoding_indices"]))
    _close(img, ref_img, SLICE_TOL)
    _close(titok.decode_tokens(ids),
           jm.apply(v, jnp.asarray(ids.numpy()), method=jm.decode_tokens), SLICE_TOL)


@torch.no_grad()
def test_titok_forward_latent_concat(jax_titok):
    """A 2x2-tile image: tiles tokenized, the logit grid stitched and
    decoded once; image and latent within 1e-3."""
    jm, flat, titok = jax_titok
    x = _images((1, 2 * TILE, 2 * TILE, 3), 11)
    ref_img, ref_lat = jax.jit(lambda v, x: jm.apply(
        v, x, method=jm.forward_latent_concat))(_tree(flat), jnp.asarray(x))
    img, lat = titok.forward_latent_concat(torch.from_numpy(x))
    assert img.shape == (1, 16, 16, 3) and lat.shape == (1, 16, 16, 32)
    _close(img, ref_img, SLICE_TOL)
    _close(lat, ref_lat, SLICE_TOL)


@torch.no_grad()
def test_pretrained_tokenizer(jax_tokenizer):
    """encode: z_q and indices (exactly); decode and decode_from_indices."""
    jm, flat, tok = jax_tokenizer
    v = _tree(flat)
    x = _images((2, 16, 16, 3), 12)
    zq_ref, idx_ref = jm.apply(v, jnp.asarray(x), method=jm.encode)
    zq, idx = tok.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    _close(zq, zq_ref, MODULE_TOL)
    _close(tok.decode(zq), jm.apply(v, zq_ref, method=jm.decode), SLICE_TOL)
    _close(tok.decode_from_indices(idx),
           jm.apply(v, idx_ref, method=jm.decode_from_indices), SLICE_TOL)
    img, idx2 = tok(torch.from_numpy(x))
    assert torch.equal(idx2, idx)
    _close(img, jm.apply(v, jnp.asarray(x))[0], SLICE_TOL)


# -- the reference map ---------------------------------------------------------

_CONV1X1 = ("conv_out", "ffn_fc1", "ffn_fc2")


def reference_state_dict(flat):
    """The reference-format (torch ``titok/titok.py``) state dict of flat
    ``params/...`` TiTok or MaskGIT-VQGAN leaves: the inverse of the
    reference map, written independently of it."""
    sd = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")[1:]
        ref = []
        for seg in path:
            m = re.fullmatch(r"(up|down)_(\d+)_block_(\d+)", seg)
            if m:
                ref += [m[1], m[2], "block", m[3]]
            elif re.fullmatch(r"up_(\d+)_upsample_conv", seg):
                ref += ["up", seg.split("_")[1], "upsample_conv"]
            elif re.fullmatch(r"(transformer|mid)_\d+", seg):
                ref += seg.rsplit("_", 1)
            else:
                ref.append({"ffn_fc1": "ffn.0", "ffn_fc2": "ffn.2"}.get(seg, seg))
        name = ".".join(ref)
        if path and path[-1] == "in_proj":
            base = name.rsplit(".", 1)[0]
            sd[f"{base}.in_proj_weight" if leaf == "kernel"
               else f"{base}.in_proj_bias"] = v.T if leaf == "kernel" else v
        elif leaf == "kernel":
            if v.ndim == 4:
                w = v.transpose(3, 2, 0, 1)
            elif path[-1] in _CONV1X1:
                w = v.T[:, :, None, None]
            else:
                w = v.T
            sd[f"{name}.weight"] = w
        elif leaf == "scale":
            sd[f"{name}.weight"] = v
        elif leaf == "embedding":
            sd[f"{name}.embedding.weight"] = v
        else:
            sd[f"{name}.{leaf}" if name else leaf] = v
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def test_reference_map_matches_the_jax_package(jax_titok, jax_tokenizer, specs):
    """A synthetic reference-format TiTok state dict (and a MaskGIT-VQGAN
    one) through ``sic_tpu.port`` and through the port's copy: every
    flattened leaf equal, and each back to the leaves it was made from."""
    from sic_tpu import port as jport
    from sic_tpu_torch import port_titok
    ts, pix = specs
    depth = dict(num_resolutions=pix.num_resolutions,
                 num_res_blocks=pix.num_res_blocks)
    for flat, fn in ((jax_titok[1], "port_titok"),
                     (jax_tokenizer[1], "port_pretrained_tokenizer")):
        sd = reference_state_dict(flat)
        args = (sd, ts.num_layers) if fn == "port_titok" else (sd,)
        ours = getattr(port_titok, fn)(*args, **depth)
        theirs = flatten_dict(getattr(jport, fn)(*args, **depth), sep="/")
        assert sorted(ours) == sorted(theirs) == sorted(flat)
        for k in ours:
            np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)
            np.testing.assert_array_equal(ours[k], flat[k], err_msg=k)


def test_reference_checkpoint_loads_through_the_file(jax_titok, specs, tmp_path):
    """torch.save of the reference-format tensors -> load_torch_state_dict
    -> port_titok -> the TiTok's parameters, leaf for leaf."""
    from sic_tpu_torch.models.titok import TiTok
    from sic_tpu_torch.port_titok import load_torch_state_dict, port_titok
    from sic_tpu_torch.weights import export_flax_params
    _, flat, _ = jax_titok
    ts, pix = specs
    path = tmp_path / "titok.bin"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               reference_state_dict(flat).items()}}, path)
    m = TiTok(ts, pix)
    assert not load_flax_params(m, port_titok(
        load_torch_state_dict(path), ts.num_layers,
        num_resolutions=pix.num_resolutions, num_res_blocks=pix.num_res_blocks))
    for k, v in export_flax_params(m).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)


def test_tiny_titok_spec_is_the_generate_clis():
    ts, pix = titok_specs(tiny=True)
    assert ts == tiny_spec().titok and ts.tile_px == 256
    assert (pix.hidden_channels, pix.channel_mult, pix.num_res_blocks,
            pix.z_channels, pix.num_embeddings, pix.embedding_dim) == \
        (32, (1, 2), 1, 32, 32, 32)
