"""The port's bf16 serving mode against the JAX package's, on the CPU.

The same seeded weights and numpy inputs go through the JAX package in
``dtype=jnp.bfloat16`` (its Pallas kernels take their plain references on
the CPU) and through the port in ``torch.bfloat16``; the inputs are rounded
to bf16 once, alike in both.  The two frameworks round bf16 at other
places (their GEMMs accumulate and round at other points, their
elementwise steps round in other orders), so two bf16 outputs differ about
as much as either differs from fp32.  Each comparison therefore holds:

- the port's bf16 output against JAX's within a stated tolerance relative
  to the output's largest magnitude: ``ATTN_TOL`` for the attention
  functions (one rounding of the probabilities and of the output, 2^-8
  each; the largest reading was 0.0016), ``MODULE_TOL`` for modules of a
  few layers at tiny widths (the roundings compound through seeded
  weights; the largest reading was 0.028, the VQGAN decoder);
- the port's own bf16-vs-fp32 gap (mean absolute) within ``GAP_MULTIPLE``
  times the JAX package's on the same input: the port rounds no more than
  the JAX bf16 mode does (the readings lay between 0.85 and 1.0 times);
- the port's bf16 output not equal to its fp32 output rounded once: it
  computes in bf16;
- on the golden stream, the port's bf16 pixels within ``GAP_MULTIPLE``
  times JAX's own bf16-vs-fp32 gap (max and mean) of JAX's bf16 pixels.

Discrete outputs (the decoded h, the coder's y_hat) are exact.  The golden
slice's JAX stages are compiled once, in a module-scoped fixture.
"""
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

import jax.numpy as jnp

from sic_tpu_torch import config as tcfg
from sic_tpu_torch.cli._common import load_runtime
from sic_tpu_torch.models.layers import cast_compute
from test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from sic_tpu_torch.weights import export_flax_params
from fixtures.golden_bf16 import GAP_MULTIPLE, JAX_GAP_MAX, JAX_GAP_MEAN
from test_torch_modules import _flax_vars, _randomize, _x

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "golden"
BF16 = torch.bfloat16
ATTN_TOL = 1e-2
MODULE_TOL = 5e-2


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(a, b):
    """max |a - b| over max |b|."""
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _mean_gap(a, b):
    return float(np.abs(_np(a) - _np(b)).mean())


def _check(port, port_f32, jax_bf16, jax_f32, tol=MODULE_TOL):
    """The port's bf16 output against JAX's (see the module docstring);
    ``port_f32`` and ``jax_f32`` are each framework's fp32 output on the
    same (bf16-valued) inputs."""
    assert port.dtype == BF16 and port_f32.dtype == torch.float32
    assert jnp.asarray(jax_bf16).dtype == jnp.bfloat16
    err = _rel(port, jax_bf16)
    gaps = _mean_gap(port, port_f32), _mean_gap(jax_bf16, jax_f32)
    assert err <= tol, (err, gaps)
    assert gaps[0] <= GAP_MULTIPLE * gaps[1], (err, gaps)
    assert not torch.equal(port, port_f32.to(BF16))
    return err, gaps


def _bf(x):
    """numpy f32 -> the same bf16 values in both frameworks."""
    return torch.from_numpy(x).to(BF16), jnp.asarray(x, jnp.bfloat16)


# -- the three attention functions ---------------------------------------------


def test_seq_attention_bf16():
    from sic_tpu.ops import seq_attention as jseq
    from sic_tpu_torch.ops import seq_attention
    x = _x((2, 289, 3 * 128), 1)
    t, j = _bf(x)
    _check(seq_attention(t, 0.125, 2), seq_attention(t.float(), 0.125, 2),
           jseq(j, 0.125, 2), jseq(jnp.asarray(_np(t)), 0.125, 2), ATTN_TOL)


@pytest.mark.parametrize("nB", [1, 4])
def test_window_attention_nhwc_bf16(nB):
    from sic_tpu.ops import window_attention_nhwc as jwin
    from sic_tpu_torch.models.swin import _full_shift_mask
    from sic_tpu_torch.ops import window_attention_nhwc
    x = _x((1, 32, 32, 3 * 128), 2)
    bias = _x((1, 256, 256), 3)
    if nB == 4:
        bias = bias + _full_shift_mask(2, 2, 16)
    t, j = _bf(x)
    tb, jb = torch.from_numpy(bias), jnp.asarray(bias)
    _check(window_attention_nhwc(t, tb, 0.125, 2),
           window_attention_nhwc(t.float(), tb, 0.125, 2), jwin(j, jb, 0.125, 2),
           jwin(jnp.asarray(_np(t)), jb, 0.125, 2), ATTN_TOL)


def test_window_attention_gsd_bf16():
    from sic_tpu.ops import window_attention as jgsd
    from sic_tpu_torch.ops import window_attention
    q, k, v = (_x((8, 256, 64), s) for s in (4, 5, 6))
    bias = _x((2, 256, 256), 7)
    tq, jq = _bf(q)
    tk, jk = _bf(k)
    tv, jv = _bf(v)
    tb, jb = torch.from_numpy(bias), jnp.asarray(bias)
    f32 = [jnp.asarray(_np(a)) for a in (tq, tk, tv)]
    _check(window_attention(tq, tk, tv, tb, 0.125),
           window_attention(tq.float(), tk.float(), tv.float(), tb, 0.125),
           jgsd(jq, jk, jv, jb, 0.125), jgsd(*f32, jb, 0.125), ATTN_TOL)


def test_kernel_wrappers_refuse_other_dtypes_on_cuda():
    """A CUDA tensor of a dtype the kernels have no entry for is refused
    by each wrapper before anything launches (stand-in tensors, so that
    the check runs without a card; tests/test_torch_gpu.py does it on
    one)."""
    import importlib
    sa = importlib.import_module("sic_tpu_torch.ops.seq_attention")
    wa = importlib.import_module("sic_tpu_torch.ops.window_attention")

    def fake(shape, dtype=torch.float16):
        return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                                     shape=shape, is_contiguous=lambda: True,
                                     dim=lambda: len(shape))

    bias = fake((1, 256, 256), torch.float32)
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        sa._forward_kernel(fake((1, 50, 384)), 0.125, 2)
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        wa._forward_kernel(fake((1, 16, 16, 384)), bias, 0.125, 2)
    q = fake((8, 256, 64))
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        wa._gsd_kernel(q, q, q, bias, 0.125)
    with pytest.raises(ValueError, match="bias must be torch.float32"):
        wa._gsd_kernel(*[fake((8, 256, 64), BF16)] * 3, fake((1, 256, 256), BF16),
                       0.125)
    # the backward: float16, or g of another type than qkv's
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        wa.window_attention_nhwc_bwd(fake((1, 16, 16, 384)), bias,
                                     fake((1, 16, 16, 128)), 0.125, 2)
    with pytest.raises(ValueError, match="g must be torch.bfloat16"):
        wa.window_attention_nhwc_bwd(fake((1, 16, 16, 384), BF16), bias,
                                     fake((1, 16, 16, 128), torch.float32), 0.125, 2)


def test_failed_build_or_launch_raises(tmp_path, monkeypatch):
    """No fallback: a kernel library that cannot be built raises, and so
    does a launch the C side reports as failed."""
    from sic_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(tmp_path / "no_nvcc"))
    with pytest.raises((RuntimeError, OSError)):
        cuda_build.load("seq_attention")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        cuda_build.check_launch(700, "seq_attention")


# -- modules at tiny widths ----------------------------------------------------


def _port_bf16(module):
    """A bf16 copy of a randomized f32 port module."""
    import copy
    return cast_compute(copy.deepcopy(module), BF16)


def test_residual_attention_block_bf16():
    from sic_tpu.models.layers import ResidualAttentionBlock as JBlock
    from sic_tpu_torch.models.layers import ResidualAttentionBlock
    m = _randomize(ResidualAttentionBlock(128, 2), 1)
    t, j = _bf(_x((2, 289, 128), 2))
    v = _flax_vars(m)
    _check(_port_bf16(m)(t), m(t.float()), JBlock(2, dtype=jnp.bfloat16).apply(v, j),
           JBlock(2).apply(v, j.astype(jnp.float32)))


@pytest.mark.parametrize("hw", [(16, 16), (32, 48)])
def test_swin_stack_bf16(hw):
    from sic_tpu.models.swin import SwinStack as JSwin
    from sic_tpu_torch.models.swin import SwinStack
    m = _randomize(SwinStack(64, 2), 3)
    t, j = _bf(_x((1, hw[0], hw[1], 64), 4))
    v = _flax_vars(m)
    _check(_port_bf16(m)(t), m(t.float()), JSwin(64, 2, dtype=jnp.bfloat16).apply(v, j),
           JSwin(64, 2).apply(v, j.astype(jnp.float32)))


def test_convnext_block_bf16():
    from sic_tpu.models.convnext import ConvNeXtBlock as JBlock
    from sic_tpu_torch.models.convnext import ConvNeXtBlock
    m = _randomize(ConvNeXtBlock(64, 64, 2.0, 5), 7)
    t, j = _bf(_x((1, 16, 16, 64), 8))
    v = _flax_vars(m)
    kw = dict(mlp_ratio=2.0, kernel_size=5)
    _check(_port_bf16(m)(t), m(t.float()),
           JBlock(64, dtype=jnp.bfloat16, **kw).apply(v, j),
           JBlock(64, **kw).apply(v, j.astype(jnp.float32)))


def test_interactive_cross_attn_bf16():
    from sic_tpu.models.cross import InteractiveCrossAttn as JCross
    from sic_tpu_torch.models.cross import InteractiveCrossAttn
    m = _randomize(InteractiveCrossAttn(128, 64, 2, 16, 16, 9), 9)
    tf, jf = _bf(_x((1, 16, 32, 64), 10))
    tt, jt = _bf(_x((2, 265, 128), 11))
    v = _flax_vars(m)
    f, t = _port_bf16(m)(tf, tt, (1, 2))
    f32, t32 = m(tf.float(), tt.float(), (1, 2))
    jb = JCross(128, 64, 2, 16, 16, 9, dtype=jnp.bfloat16).apply(v, jf, jt, (1, 2))
    j32 = JCross(128, 64, 2, 16, 16, 9).apply(
        v, jf.astype(jnp.float32), jt.astype(jnp.float32), (1, 2))
    _check(f, f32, jb[0], j32[0])
    _check(t, t32, jb[1], j32[1])


def test_hybrid_encoder_bf16():
    """The encoder takes f32 pixels and casts them in its patch embed; its
    outputs are bf16 in both frameworks."""
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu.models.hybrid import HybridEncoder as JEnc
    from sic_tpu_torch.models.hybrid import HybridEncoder
    js = jtiny(insert_pos_enc=(0, 1))
    ts = tcfg.tiny_spec(insert_pos_enc=(0, 1))
    enc = _randomize(HybridEncoder(ts.titok, ts.insert_pos_enc, 64), 23)
    x = np.random.default_rng(24).random((1, 256, 512, 3)).astype(np.float32)
    lat = _x((8, 128), 25, 128 ** -0.5)
    v = _flax_vars(enc)
    args = (jnp.asarray(x), jnp.asarray(lat))
    zb, fb, _ = JEnc(js.titok, js.insert_pos_enc, 64, dtype=jnp.bfloat16).apply(v, *args)
    z32, f32, _ = JEnc(js.titok, js.insert_pos_enc, 64).apply(v, *args)
    args = (torch.from_numpy(x), torch.from_numpy(lat))
    z, f, _ = _port_bf16(enc)(*args)
    pz, pf, _ = enc(*args)
    _check(z, pz, zb, z32)
    _check(f, pf, fb, f32)


def test_hybrid_decoder_and_feat_merge_bf16():
    """The decoder takes f32 z and h (the coder's) and casts them on entry;
    FeatMerge takes the decoder's bf16 outputs."""
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu.models.hybrid import FeatMerge as JMerge
    from sic_tpu.models.hybrid import HybridDecoder as JDec
    from sic_tpu_torch.models.hybrid import FeatMerge, HybridDecoder
    js = jtiny(insert_pos_dec=(0, 1))
    ts = tcfg.tiny_spec(insert_pos_dec=(0, 1))
    dec = _randomize(HybridDecoder(ts.titok, ts.insert_pos_dec, 64), 16)
    z, h = _x((4, 8, 8), 17), _x((1, 16, 16, 64), 18)
    v = _flax_vars(dec)
    args = (jnp.asarray(z), jnp.asarray(h), (2, 2))
    tb, fb = JDec(js.titok, js.insert_pos_dec, 64, dtype=jnp.bfloat16).apply(v, *args)
    t32, f32 = JDec(js.titok, js.insert_pos_dec, 64).apply(v, *args)
    args = (torch.from_numpy(z), torch.from_numpy(h), (2, 2))
    t, f = _port_bf16(dec)(*args)
    pt, pf = dec(*args)
    _check(t, pt, tb, t32)
    _check(f, pf, fb, f32)

    merge = _randomize(FeatMerge(128, 64, 64, 128), 19)
    mv = _flax_vars(merge)
    # the same bf16 inputs to both, JAX's decoder outputs
    tin, fin = torch.tensor(_np(tb), dtype=BF16), torch.tensor(_np(fb), dtype=BF16)
    _check(_port_bf16(merge)(tin, fin), merge(tin.float(), fin.float()),
           JMerge(128, 64, 64, 128, dtype=jnp.bfloat16).apply(mv, tb, fb),
           JMerge(128, 64, 64, 128).apply(mv, tb.astype(jnp.float32),
                                          fb.astype(jnp.float32)))


def test_vqgan_decode_bf16():
    """post_quant_conv, the decoder's resnets, attention (f32 logits) and
    GroupNorms, from a bf16 latent as decode_to_latent hands it over."""
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu.models.vqgan import VQGAN as JVQGAN
    from sic_tpu_torch.models.vqgan import VQGAN
    m = _randomize(VQGAN(tcfg.tiny_spec().vqgan), 14)
    t, j = _bf(_x((1, 8, 8, 64), 15))
    v = {"params": unflatten_dict(export_flax_params(m), sep="/")["params"]}
    jb = JVQGAN(jtiny().vqgan, jnp.bfloat16).apply(v, j, method=JVQGAN.decode)
    j32 = JVQGAN(jtiny().vqgan).apply(v, j.astype(jnp.float32), method=JVQGAN.decode)
    _check(_port_bf16(m).decode(t), m.decode(t.float()), jb, j32)


# -- the slice on the golden fixture -------------------------------------------


@pytest.fixture(scope="module")
def golden():
    """The golden params in both frameworks and both dtypes; JAX's jitted
    stages are compiled once and shared by the tests below."""
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu.models import CodecRuntime as JRuntime
    sys.path.insert(0, str(GOLDEN.parents[1]))
    from fixtures.golden.generate import load_params
    params = load_params(GOLDEN / "params.npz")
    out = {"jax_bf16": JRuntime(jtiny(), params, dtype=jnp.bfloat16, stream_part=1),
           "jax_f32": JRuntime(jtiny(), params, stream_part=1)}
    for name, dtype in (("port_bf16", "bfloat16"), ("port_f32", None)):
        out[name] = load_runtime(str(GOLDEN / "params.npz"), tcfg.tiny_spec(),
                                 device="cpu", stream_part=1, dtype=dtype)
    yield out
    out["port_bf16"].close()
    out["port_f32"].close()


def test_load_runtime_dtypes(golden):
    """On the CPU the default is fp32, as the JAX package's; bf16 on
    request, the bottleneck coder f32 and shared with the caller's model."""
    f32, bf = golden["port_f32"], golden["port_bf16"]
    assert f32.dtype == torch.float32 and f32.net is f32.model
    assert bf.dtype == BF16 and bf.net is not bf.model
    assert bf.net.prior_fusion.ffn_fc2.weight.dtype == BF16
    assert bf.model.prior_fusion.ffn_fc2.weight.dtype == torch.float32
    assert bf.net.prior_fusion.ffn_ln.weight.dtype == torch.float32
    assert bf.net.hybrid_codec.quantize_feat is bf.model.hybrid_codec.quantize_feat
    assert all(p.dtype == torch.float32
               for p in bf.h_coder.module.parameters())
    from sic_tpu_torch.models import Codec
    # Codec(dtype=bf16) is flax's: f32 parameters computed in bf16
    m = Codec(tcfg.tiny_spec(), dtype=BF16)
    assert m.vqgan.decoder.conv_out.compute_dtype == BF16
    assert m.vqgan.decoder.conv_out.weight.dtype == torch.float32
    assert bf.net.prior_fusion.ffn_fc2.compute_dtype == BF16
    assert bf.model.prior_fusion.ffn_fc2.compute_dtype == torch.float32
    assert m.hybrid_codec.encoder.ln_pre.weight.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in m.hybrid_codec.quantize_feat.parameters())
    assert m.vqgan.quantize.embedding.dtype == torch.float32


def test_golden_stream_bf16_decode_matches_jax(golden):
    """golden.c2df decoded in bf16 by both frameworks: h exactly (the f32
    coding chain); the port's pixels within GAP_MULTIPLE times JAX's own
    bf16-vs-f32 gap on the same stream (max and mean) of JAX's bf16 pixels,
    and its own bf16-vs-f32 gap within GAP_MULTIPLE of JAX's.  JAX's gap is
    the one fixtures/golden_bf16.py records for the card's checks."""
    from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
    enc, header = unpack_c2df(GOLDEN / "golden.c2df")
    enc = sanitize_enc_result_types(enc)
    kw = dict(z_coder=header["z_coder"], coding_batch=header["coding_batch"])
    jb = np.asarray(golden["jax_bf16"].decode_only(**enc, **kw).astype(jnp.float32))
    j32 = np.asarray(golden["jax_f32"].decode_only(**enc, **kw))
    probe, probe32 = {}, {}
    port = golden["port_bf16"].decode_only(**enc, **kw, probe=probe)
    port32 = golden["port_f32"].decode_only(**enc, **kw, probe=probe32)
    assert torch.equal(probe["h_hat"], probe32["h_hat"])
    assert port.dtype == torch.float32 and tuple(port.shape) == jb.shape
    port, port32 = port.numpy(), port32.numpy()
    np.testing.assert_allclose([np.abs(jb - j32).max(), np.abs(jb - j32).mean()],
                               [JAX_GAP_MAX, JAX_GAP_MEAN], rtol=0.1)
    for stat in (np.max, np.mean):
        gap = stat(np.abs(jb - j32))
        assert 0 < stat(np.abs(port - jb)) <= GAP_MULTIPLE * gap
        assert stat(np.abs(port - port32)) <= GAP_MULTIPLE * gap


def test_timer_records_the_jax_stage_names(golden):
    """timer= on the four runtime entry points, in the JAX positions
    (decode_only_batched's second positional argument): each call records
    the stages the JAX runtime records for the same call, on the bf16
    runtimes the tests above compile."""
    from fixtures.golden.generate import golden_input
    from sic_tpu.utils.profiling import StageTimer as JTimer
    from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
    from sic_tpu_torch.utils.profiling import StageTimer
    enc, header = unpack_c2df(GOLDEN / "golden.c2df")
    enc = dict(sanitize_enc_result_types(enc), z_coder=header["z_coder"],
               coding_batch=header["coding_batch"])
    rt, jrt = golden["port_bf16"], golden["jax_bf16"]
    x = golden_input()[None]
    calls = {
        "decode_only": lambda r, t: r.decode_only(**enc, timer=t),
        "decode_only_batched": lambda r, t: r.decode_only_batched([enc, enc], t),
        "encode_only": lambda r, t: r.encode_only(x, timer=t),
        "encode_only_batched": lambda r, t: r.encode_only_batched(
            np.concatenate([x, x[:, ::-1]]), timer=t)}
    for name, call in calls.items():
        pt, jt = StageTimer(), JTimer()
        call(rt, pt)
        call(jrt, jt)
        assert set(pt.stages) == set(jt.stages), (name, pt.stages, jt.stages)
        assert all(ms >= 0 for ms in pt.stages.values())
        assert set(pt.headers()) == set(jt.headers())
    assert set(pt.stages) == {"encode_device", "fetch", "h_rans", "z_rans"}


def test_golden_input_bf16_encode(golden):
    """golden_input() encoded in bf16 by both frameworks: the port's stream
    decodes to its encoder's y_hat exactly in the bf16 and the fp32
    runtime, and its z indices equal JAX's but where the two nearest codes
    lie closer than bf16 resolves."""
    from fixtures.golden.generate import golden_input
    from sic_tpu_torch.models.quantizer import _l2n
    rt, rt32, jrt = golden["port_bf16"], golden["port_f32"], golden["jax_bf16"]
    x = golden_input()[None]
    probe = {}
    enc = rt.encode_only(x, probe=probe)
    for r in (rt, rt32):
        out = {}
        r.decode_only(**enc, coding_batch=8, probe=out)
        assert torch.equal(out["h_hat"], probe["y_hat"])
    jenc = jrt.encode_only(jnp.asarray(x))
    n = enc["token_length"]
    z_port = rt._decode_z(enc["z_bit_stream"], n, "rans")
    z_jax = jrt._decode_z(jenc["z_bit_stream"], n, "rans")
    flips = np.flatnonzero(z_port != z_jax)
    if flips.size:
        # the score gap between the two frameworks' codes, for the port's
        # unit-norm latent: bf16 resolves relative steps of 2^-8
        net = rt.net.hybrid_codec
        with torch.no_grad():
            z, _, _ = net.encoder(torch.from_numpy(x) * 0.5 + 0.5, net.latent_tokens)
            zf = _l2n(z.float().reshape(-1, z.shape[-1]))
            scores = 2 * zf @ net.quantize.codebook().T
        gaps = (scores[flips, z_port[flips]] - scores[flips, z_jax[flips]]).abs()
        assert float(gaps.max()) <= 2 * 2 ** -8, gaps


@pytest.mark.parametrize("dtype,device,want", [
    (None, "cpu", torch.float32), (None, "cuda", BF16), ("auto", "cuda", BF16),
    ("auto", "cpu", torch.float32), ("float32", "cuda", torch.float32),
    ("bfloat16", "cpu", BF16), (BF16, "cpu", BF16)])
def test_resolve_dtype(dtype, device, want):
    """The JAX package's rule (bf16 on an accelerator, fp32 on the CPU)
    unless a dtype is named; anything else is refused."""
    from sic_tpu_torch.models.codec import resolve_dtype
    assert resolve_dtype(dtype, device) == want


def test_resolve_dtype_refuses_others():
    from sic_tpu_torch.models.codec import resolve_dtype
    for bad in ("float16", torch.float16, "bf16"):
        with pytest.raises(ValueError):
            resolve_dtype(bad, "cpu")


def test_decompress_cli_dtype_and_service_setting(tmp_path, monkeypatch):
    """The decompress CLI's --dtype bfloat16 on the CPU decodes golden.c2df
    within the golden-derived bound of its fp32 decode; the service takes
    the dtype from SIC_DTYPE when none is passed."""
    from PIL import Image

    from sic_tpu_torch.cli.decompress import main
    from sic_tpu_torch.service import ServiceState
    src = tmp_path / "in"
    src.mkdir()
    (src / "golden.c2df").write_bytes((GOLDEN / "golden.c2df").read_bytes())
    png = {}
    for dtype in ("float32", "bfloat16"):
        assert main(["--dataset_dir", str(src), "--save_dir", str(tmp_path / dtype),
                     "--spec", "tiny", "--device", "cpu", "--dtype", dtype,
                     "--ckpt_path", str(GOLDEN / "params.npz")]) == 1
        png[dtype] = np.asarray(Image.open(tmp_path / dtype / "golden.png"),
                                dtype=np.float64) / 127.5
    diff = np.abs(png["bfloat16"] - png["float32"])
    assert 0 < diff.mean() <= GAP_MULTIPLE * JAX_GAP_MEAN
    monkeypatch.setenv("SIC_DTYPE", "bfloat16")
    monkeypatch.setenv("INDEX_DIR", str(tmp_path / "idx"))
    monkeypatch.setenv("PREVIEW_CACHE", str(tmp_path / "previews"))
    assert ServiceState("tiny", device="cpu").dtype == "bfloat16"
    assert ServiceState("tiny", device="cpu", dtype="float32").dtype == "float32"
