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
    """Every leaf of the golden tree lands in exactly one parameter, except
    the encode-side subtrees this slice does not port."""
    from sic_tpu_torch.models import Codec
    from sic_tpu_torch.weights import ENCODER_PREFIXES, load_npz
    m = Codec(tcfg.tiny_spec())
    with np.load(GOLDEN) as z:
        keys = set(z.files)
    unused = load_npz(m, GOLDEN)
    assert unused == {k for k in keys if k.startswith(ENCODER_PREFIXES)}
    assert len(keys) - len(unused) == sum(1 for _ in m.parameters())
    for prefix in ENCODER_PREFIXES:
        assert any(k.startswith(prefix) for k in unused), prefix
