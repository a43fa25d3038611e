"""Each module of the PyTorch port against its flax twin, on the CPU.

The same weights go into both packages (the port's parameters exported to
the JAX package's flat names) and the same numpy inputs through both.
Float outputs agree within 1e-4 (fp32; the two frameworks sum in other
orders); discrete outputs (masks, CDF indexes) exactly.
"""
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

import jax.numpy as jnp

from sic_tpu_torch import config as tcfg
from sic_tpu_torch.weights import export_flax_params

TOL = 1e-4
GOLDEN = "tests/fixtures/golden/params.npz"


def _randomize(module, seed):
    """Seeded weights with every leaf non-zero, so that zero-initialised
    gates and biases do not hide a path."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            fan_in = p[0].numel() if p.dim() > 1 else p.numel()
            scale = 0.02 if p.dim() == 1 else fan_in ** -0.5
            base = 1.0 if name.endswith(("norm1.weight", "norm2.weight")) else 0.0
            p.copy_(torch.from_numpy(
                base + scale * rng.standard_normal(p.shape).astype(np.float32)))
    return module.eval()


def _flax_vars(module):
    return {"params": unflatten_dict(export_flax_params(module), sep="/")["params"]}


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_residual_attention_block():
    from sic_tpu.models.layers import ResidualAttentionBlock as JBlock
    from sic_tpu_torch.models.layers import ResidualAttentionBlock
    m = _randomize(ResidualAttentionBlock(128, 2), 1)
    x = _x((2, 289, 128), 2)
    ref = JBlock(2).apply(_flax_vars(m), jnp.asarray(x))
    _close(m(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("hw", [(16, 16), (32, 48)])
def test_swin_stack(hw):
    """Block 0 carries the relative bias, block 1 the shifted windows and
    their -inf masks (1 window, and 2x3 windows)."""
    from sic_tpu.models.swin import SwinStack as JSwin
    from sic_tpu_torch.models.swin import SwinStack
    m = _randomize(SwinStack(64, 2), 3)
    x = _x((1, hw[0], hw[1], 64), 4)
    ref = JSwin(64, 2).apply(_flax_vars(m), jnp.asarray(x))
    _close(m(torch.from_numpy(x)), ref)


def test_swin_shift_tables_match():
    from sic_tpu.models import swin as jswin
    from sic_tpu_torch.models import swin
    np.testing.assert_array_equal(swin._relative_index(16), jswin._relative_index(16))
    np.testing.assert_array_equal(swin._full_shift_mask(2, 3, 16),
                                  jswin._full_shift_mask(2, 3, 16))


def test_depth_conv_block():
    from sic_tpu.models.dcvc import DepthConvBlock4 as JBlock
    from sic_tpu_torch.models.dcvc import DepthConvBlock4
    m = _randomize(DepthConvBlock4(16, 32), 5)
    x = _x((2, 8, 8, 16), 6)
    ref = JBlock(32).apply(_flax_vars(m), jnp.asarray(x))
    _close(m(torch.from_numpy(x)), ref)


def test_convnext_block():
    from sic_tpu.models.convnext import ConvNeXtBlock as JBlock
    from sic_tpu_torch.models.convnext import ConvNeXtBlock
    m = _randomize(ConvNeXtBlock(64, 64, 2.0, 5), 7)
    x = _x((1, 16, 16, 64), 8)
    ref = JBlock(64, mlp_ratio=2.0, kernel_size=5).apply(_flax_vars(m), jnp.asarray(x))
    _close(m(torch.from_numpy(x)), ref)


def test_interactive_cross_attn():
    """Two 256-px tiles side by side: S = 16*16 + 9 + 256 = 521 tokens."""
    from sic_tpu.models.cross import InteractiveCrossAttn as JCross
    from sic_tpu_torch.models.cross import InteractiveCrossAttn
    m = _randomize(InteractiveCrossAttn(128, 64, 2, 16, 16, 9), 9)
    feat = _x((1, 16, 32, 64), 10)
    tok = _x((2, 265, 128), 11)
    f_ref, t_ref = JCross(128, 64, 2, 16, 16, 9).apply(
        _flax_vars(m), jnp.asarray(feat), jnp.asarray(tok), (1, 2))
    f, t = m(torch.from_numpy(feat), torch.from_numpy(tok), (1, 2))
    _close(f, f_ref)
    _close(t, t_ref)


def test_quantizers():
    from sic_tpu.models.quantizer import L2VectorQuantizer as JL2
    from sic_tpu_torch.models.quantizer import L2VectorQuantizer
    m = _randomize(L2VectorQuantizer(64, 8), 12)
    idx = np.random.default_rng(13).integers(0, 64, (4, 8))
    ref = JL2(64, 8).apply(_flax_vars(m), jnp.asarray(idx),
                           method=JL2.decode_indices)
    _close(m.decode_indices(torch.from_numpy(idx)), ref)


def test_l2_quantizer_encode():
    """Nearest-code search: indices exactly, z_q within 1e-4."""
    from sic_tpu.models.quantizer import L2VectorQuantizer as JL2
    from sic_tpu_torch.models.quantizer import L2VectorQuantizer
    m = _randomize(L2VectorQuantizer(64, 8), 21)
    z = _x((6, 8, 8), 22)
    z_q_ref, info = JL2(64, 8).apply(_flax_vars(m), jnp.asarray(z))
    z_q, result = m(torch.from_numpy(z))
    idx = result["min_encoding_indices"]
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(info["min_encoding_indices"]))
    np.testing.assert_array_equal(m.encode_indices(torch.from_numpy(z)).numpy(),
                                  idx.numpy())
    _close(z_q, z_q_ref)
    assert len(np.unique(idx.numpy())) > 8


def test_hybrid_encoder_and_encode_stage():
    """Inserts at layers 0 and 1 on a 512x512 image (2x2 tiles): the patch
    embed, class/position/latent embeddings, cross-attention, refiners,
    the stride-2 feat_out_down and TiTok's channel scramble all run; z
    within 1e-4, the VQ indices of the whole encode stage exactly."""
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu.models.codec import Codec as JCodec
    from sic_tpu.models.hybrid import HybridEncoder as JEnc
    from sic_tpu_torch.models import Codec
    from sic_tpu_torch.models.hybrid import HybridEncoder
    js = jtiny(insert_pos_enc=(0, 1))
    ts = tcfg.tiny_spec(insert_pos_enc=(0, 1))
    enc = _randomize(HybridEncoder(ts.titok, ts.insert_pos_enc, 64), 23)
    x = np.random.default_rng(24).random((1, 512, 512, 3)).astype(np.float32)
    lat = _x((8, 128), 25, 128 ** -0.5)
    z_ref, f_ref, stack = JEnc(js.titok, js.insert_pos_enc, 64).apply(
        _flax_vars(enc), jnp.asarray(x), jnp.asarray(lat))
    z, f, stack_t = enc(torch.from_numpy(x), torch.from_numpy(lat))
    assert tuple(stack) == stack_t == (2, 2)
    assert tuple(f.shape) == (1, 16, 16, 64)
    _close(z, z_ref)
    _close(f, f_ref)

    codec = _randomize(Codec(ts), 26)
    vars_ = _flax_vars(codec)
    idx_ref, h_ref, _ = JCodec(js).apply(vars_, jnp.asarray(x),
                                         method=JCodec.encode_stage)
    idx, h, _ = codec.encode_stage(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    _close(h, h_ref)


def _clip_spec(jax_pkg: bool):
    mod = __import__("sic_tpu.retrieval.clip_model" if jax_pkg else
                     "sic_tpu_torch.retrieval.clip_model", fromlist=["CLIPSpec"])
    return mod.CLIPSpec(vision_width=128, vision_layers=2, vision_heads=2,
                        embed_dim=64, text_width=64, text_layers=1,
                        text_heads=1, context_length=8, vocab_size=100)


def test_clip_vision_tower():
    """2 layers at width 128 (S = 50 tokens at 224 px)."""
    from sic_tpu.retrieval.clip_model import CLIPVisionTower as JTower
    from sic_tpu_torch.retrieval import CLIPVisionTower
    tower = _randomize(CLIPVisionTower(_clip_spec(False)), 27)
    x = _x((2, 224, 224, 3), 28)
    ref = JTower(_clip_spec(True)).apply(_flax_vars(tower), jnp.asarray(x))
    _close(tower(torch.from_numpy(x)), ref)


def test_open_clip_loader(tmp_path):
    """A fake open_clip state dict, saved with torch.save, loads into the
    port's tower the weights the JAX package's loader gives its own."""
    from sic_tpu.retrieval.clip_model import CLIPModel
    from sic_tpu.retrieval.clip_model import \
        port_open_clip_weights as jport
    from sic_tpu_torch.retrieval import CLIPVisionTower, port_open_clip_weights
    rng = np.random.default_rng(29)
    w, e, tw = 128, 64, 64

    def t(*shape):
        return torch.from_numpy(0.05 * rng.standard_normal(shape).astype(np.float32))

    def block(prefix, d):
        return {f"{prefix}.ln_1.weight": 1 + t(d), f"{prefix}.ln_1.bias": t(d),
                f"{prefix}.ln_2.weight": 1 + t(d), f"{prefix}.ln_2.bias": t(d),
                f"{prefix}.attn.in_proj_weight": t(3 * d, d),
                f"{prefix}.attn.in_proj_bias": t(3 * d),
                f"{prefix}.attn.out_proj.weight": t(d, d),
                f"{prefix}.attn.out_proj.bias": t(d),
                f"{prefix}.mlp.c_fc.weight": t(4 * d, d),
                f"{prefix}.mlp.c_fc.bias": t(4 * d),
                f"{prefix}.mlp.c_proj.weight": t(d, 4 * d),
                f"{prefix}.mlp.c_proj.bias": t(d)}

    sd = {"visual.conv1.weight": t(w, 3, 32, 32),
          "visual.class_embedding": t(w), "visual.positional_embedding": t(50, w),
          "visual.ln_pre.weight": 1 + t(w), "visual.ln_pre.bias": t(w),
          "visual.ln_post.weight": 1 + t(w), "visual.ln_post.bias": t(w),
          "visual.proj": t(w, e),
          "token_embedding.weight": t(100, tw), "positional_embedding": t(8, tw),
          "ln_final.weight": 1 + t(tw), "ln_final.bias": t(tw),
          "text_projection": t(tw, e)}
    for i in range(2):
        sd.update(block(f"visual.transformer.resblocks.{i}", w))
    sd.update(block("transformer.resblocks.0", tw))
    path = tmp_path / "open_clip.pt"
    torch.save(sd, path)

    tower = CLIPVisionTower(_clip_spec(False))
    tower.load_state_dict(port_open_clip_weights(path, _clip_spec(False)))
    jparams = jport(str(path), _clip_spec(True))
    x = _x((1, 224, 224, 3), 30)
    ref = CLIPModel(_clip_spec(True)).apply(
        jparams, jnp.asarray(x), method=lambda m, v: m.visual(v))
    _close(tower.eval()(torch.from_numpy(x)), ref)


def test_vqgan_decode():
    from sic_tpu.models.vqgan import VQGAN as JVQGAN
    from sic_tpu_torch.models.vqgan import VQGAN
    spec = tcfg.tiny_spec().vqgan
    from sic_tpu.config import tiny_spec as jtiny
    m = _randomize(VQGAN(spec), 14)
    z = _x((1, 16, 16, 64), 15)
    flat = export_flax_params(m)
    ref = JVQGAN(jtiny().vqgan).apply(
        {"params": unflatten_dict(flat, sep="/")["params"]}, jnp.asarray(z),
        method=JVQGAN.decode)
    _close(m.decode(torch.from_numpy(z)), ref)


def test_hybrid_decoder_and_feat_merge():
    """Inserts at layers 0 and 1, 2x2 tiles: cross-attention, the feature
    refiners (Swin + ConvNeXt) and 4-window shift masks all run."""
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu.models.hybrid import FeatMerge as JMerge
    from sic_tpu.models.hybrid import HybridDecoder as JDec
    from sic_tpu_torch.models.hybrid import FeatMerge, HybridDecoder
    js = jtiny(insert_pos_dec=(0, 1))
    ts = tcfg.tiny_spec(insert_pos_dec=(0, 1))
    dec = _randomize(HybridDecoder(ts.titok, ts.insert_pos_dec, 64), 16)
    z = _x((4, 8, 8), 17)
    h = _x((1, 16, 16, 64), 18)
    t_ref, f_ref = JDec(js.titok, js.insert_pos_dec, 64).apply(
        _flax_vars(dec), jnp.asarray(z), jnp.asarray(h), (2, 2))
    t, f = dec(torch.from_numpy(z), torch.from_numpy(h), (2, 2))
    _close(t, t_ref)
    _close(f, f_ref)

    merge = _randomize(FeatMerge(128, 64, 64, 128), 19)
    ref = JMerge(128, 64, 64, 128).apply(_flax_vars(merge), t_ref, f_ref)
    _close(merge(t, f), ref)


def test_four_part_masks_and_indexes_exact():
    from sic_tpu.entropy import fourpart as jfp
    from sic_tpu.entropy.gaussian import build_indexes as jbuild
    from sic_tpu_torch.entropy import fourpart
    from sic_tpu_torch.entropy.gaussian import build_indexes
    np.testing.assert_array_equal(fourpart.four_part_masks(6, 4, 16).numpy(),
                                  np.asarray(jfp.four_part_masks(6, 4, 16)))
    rng = np.random.default_rng(20)
    scales = np.exp(rng.uniform(-4, 5, (2, 8, 8, 16))).astype(np.float32)
    scales[0, 0, 0, :4] = [0.0, 0.119, 0.12, 64.0]
    ref = jbuild(jnp.asarray(scales), skip_thres=0.12)
    np.testing.assert_array_equal(
        build_indexes(torch.from_numpy(scales), skip_thres=0.12).numpy(),
        np.asarray(ref))
    x = torch.from_numpy(scales)
    np.testing.assert_array_equal(fourpart.combine_for_writing(x).numpy(),
                                  np.asarray(jfp.combine_for_writing(jnp.asarray(scales))))


def test_golden_params_bridge_consumes_all_but_the_encoder():
    """Every leaf of the golden tree lands in exactly one parameter, the
    VQGAN teacher encoder's too (the port's VQGAN holds it for training)."""
    from sic_tpu_torch.models import Codec
    from sic_tpu_torch.weights import load_npz
    m = Codec(tcfg.tiny_spec())
    with np.load(GOLDEN) as z:
        keys = set(z.files)
    unused = load_npz(m, GOLDEN)
    assert unused == set()
    assert len(keys) == sum(1 for _ in m.parameters())
    for prefix in ("params/vqgan/encoder/", "params/vqgan/quant_conv/",
                   "params/hybrid_codec/encoder/"):
        assert any(k.startswith(prefix) for k in keys), prefix
    assert "params/hybrid_codec/latent_tokens" in keys


def test_export_round_trips_the_encoder():
    """export_flax_params writes the encoder's leaves back under the JAX
    package's names, and loading them again changes nothing."""
    from sic_tpu_torch.models import Codec
    from sic_tpu_torch.weights import export_flax_params, load_flax_params
    m = _randomize(Codec(tcfg.tiny_spec()), 31)
    flat = export_flax_params(m)
    assert "params/hybrid_codec/latent_tokens" in flat
    assert flat["params/hybrid_codec/encoder/patch_embed/kernel"].shape == (16, 16, 3, 128)
    m2 = Codec(tcfg.tiny_spec())
    assert load_flax_params(m2, flat) == set()
    for a, b in zip(m.parameters(), m2.parameters()):
        assert torch.equal(a, b)
