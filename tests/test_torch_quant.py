"""The port's int8 W8A8 mode against the JAX package's ``ops/quant.py``, on
the CPU (twins of ``tests/test_quant.py``, and more).

What holds, and how tightly:

- ``quantize_kernel`` gives the JAX function's bytes and scales exactly.
- One ``QuantLinear`` on the same input as the JAX ``QuantDense`` under
  ``jit`` (as the JAX runtime runs it): the int32 accumulator equal bit for
  bit for the same ``x_q``, every ``x_q`` equal (rows built on ``.5`` ties
  included: XLA divides by 127 as a product with its f32 reciprocal, and so
  does the port), the output within ``RESCALE_TOL`` relative (XLA fuses the
  rescale's last product and the bias add into one FMA, the port rounds
  between them: at most an ulp or two).
- The int8 product is exact on the CPU at depths whose sums pass f32's
  2^24, and padding to CUDA ``_int_mm``'s shape rule leaves it unchanged.
- The set of quantized modules equals ``quantize_dense_tree``'s
  ``kernel_q`` leaves, by value on the tiny spec (codec and TiTok), by
  structure on ``flagship_spec()`` (``jax.eval_shape``: nothing computed).
- Streams cross the port's fp32, bf16, int8 and int8+bf16 runtimes in both
  directions with ``y_hat`` exact (the coding chain is the caller's f32
  bottleneck in every mode).
- Across packages a network's 1-ulp float differences (GELU, softmax,
  norms) move ``x / x_s`` across a ``.5`` boundary for about 2e-4 of a
  layer's activations, and the tiny spec's golden params amplify each flip
  as they amplify any perturbation.  So an int8 decode of one stream
  differs between the packages about as far as the JAX package's own int8
  decode differs from its fp32 one.  The bound: the port's int8 pixels
  within ``GAP_MULTIPLE`` times the JAX package's int8-vs-fp32 gap (max and
  mean) of the JAX int8 pixels, and the port's own int8-vs-fp32 gap within
  the same bound; JAX's gap on ``golden.c2df`` is the one
  ``fixtures/golden_int8.py`` records for the card's checks.  The decoded
  detail latent of a JAX-encoded int8 stream: the symbols exactly (a
  symbol off by one moves ``y_hat`` by a quantization step), ``y_hat``,
  which the decode transform computes in floats, within ``Y_HAT_TOL`` of
  the JAX package's.
"""
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import jax
import jax.numpy as jnp

from sic_tpu_torch import config as tcfg
from sic_tpu_torch.cli._common import load_runtime
from sic_tpu_torch.ops.quant import (INT_MM_ALIGN, INT_MM_MIN_ROWS, MAX_DEPTH,
                                     QuantLinear, int8_mm, int8_mm_plain,
                                     pad_for_int_mm, quantize_kernel,
                                     quantize_linears, quantize_rows,
                                     resolve_quant)
from sic_tpu_torch.weights import export_flax_params, flax_key, init_seeded
from test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from fixtures.golden_int8 import GAP_MULTIPLE, JAX_GAP_MAX, JAX_GAP_MEAN

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "golden"
RESCALE_TOL = 1e-6     # relative: the FMA against two roundings
Y_HAT_TOL = 1e-4       # the port's module tolerance (fp32 decode transform)


# -- the kernel quantization ------------------------------------------------------


def test_quantize_kernel_math():
    w = np.array([[1.0, 0.0, -2.54], [-0.5, 0.0, 1.27]], np.float32)
    q, s = quantize_kernel(w)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_allclose(s, [1.0 / 127, 1.0, 2.54 / 127])
    np.testing.assert_array_equal(q[:, 0], [127, -64])
    np.testing.assert_array_equal(q[:, 1], [0, 0])     # all-zero column: exact 0
    np.testing.assert_array_equal(q[:, 2], [-127, 64])


def test_quantize_kernel_bytes_equal_jax():
    from sic_tpu.ops.quant import quantize_kernel as jquantize
    rng = np.random.default_rng(0)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    w[:, 3] = 0.0
    w[5, 7] = 0.5 * np.abs(w[:, 7]).max() / 127.0 * 127   # a .5 tie column
    for kernel in (w, rng.standard_normal((12, 1024)).astype(np.float32) * 40):
        q, s = quantize_kernel(kernel)
        jq, js = jquantize(kernel)
        assert q.tobytes() == jq.tobytes() and s.tobytes() == js.tobytes()


def test_resolve_quant():
    assert resolve_quant(None) is None and resolve_quant("none") is None
    assert resolve_quant("int8") == "int8"
    with pytest.raises(ValueError):
        resolve_quant("fp4")


# -- the integer pipeline -------------------------------------------------------------


def _tie_rows(rng, n, width):
    """Rows whose entries sit on ``.5`` ties of x / x_s for XLA's scale
    (amax times f32(1/127)) and off them, on the other side of the
    round-half-even choice, for the correctly rounded division amax / 127:
    a division in place of XLA's product flips every one."""
    inv = np.float32(1.0) / np.float32(127.0)
    rows = []
    while len(rows) < n:
        a = np.float32(rng.uniform(0.5, 8.0))
        xs_xla, xs_div = a * inv, a / np.float32(127.0)
        ties = [v for v in (np.float32((k + 0.5) * np.float64(xs_xla))
                            for k in range(-120, 120))
                if np.round(v / xs_xla) != np.round(v / xs_div)]
        if xs_xla == xs_div or len(ties) < 8:
            continue
        rows.append(np.array([a] + [ties[j] for j in rng.integers(0, len(ties), width - 1)],
                             np.float32))
    return np.stack(rows)


def _quant_linear(w, b):
    q, s = quantize_kernel(w)
    return QuantLinear(torch.from_numpy(np.ascontiguousarray(q.T)),
                       torch.from_numpy(s), None if b is None else torch.from_numpy(b))


def test_quant_linear_integer_pipeline():
    """QuantLinear == the documented numpy integer math (twin of the JAX
    package's test; the numpy scale is XLA's product with 1/127)."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 16).astype(np.float32)
    w = rng.randn(16, 8).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    wq, ws = quantize_kernel(w)
    got = _quant_linear(w, b)(torch.from_numpy(x)).numpy()

    amax = np.abs(x).max(-1, keepdims=True)
    xs = np.maximum(amax, np.float32(1e-12)) * (np.float32(1) / np.float32(127))
    xq = np.clip(np.round(x / xs), -127, 127).astype(np.int8)
    acc = np.einsum("bsi,io->bso", xq.astype(np.int32), wq.astype(np.int32))
    want = acc.astype(np.float32) * xs * ws + b
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ref = x @ w + b
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.02


@pytest.mark.parametrize("bias", [True, False])
def test_quant_linear_matches_jax_quant_dense(bias):
    """The same x through QuantLinear and the JAX QuantDense under jit:
    x_q equal (tie rows included), acc equal bit for bit on the port's x_q,
    outputs within RESCALE_TOL (a flipped x_q would move an output by
    x_s * w_s * |w_q|, orders above it)."""
    from sic_tpu.ops.quant import QuantDense
    rng = np.random.default_rng(1)
    x = np.concatenate([_tie_rows(rng, 24, 64),
                        (rng.standard_normal((40, 64))
                         * rng.uniform(0.01, 5, (40, 1))).astype(np.float32)])
    x[-1] = 0.0                                              # amax 0: x_s 1e-12/127
    x = x.reshape(2, 32, 64)
    w = rng.standard_normal((64, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32) if bias else None
    wq, ws = quantize_kernel(w)
    leaves = {"kernel_q": jnp.asarray(wq), "kernel_s": jnp.asarray(ws)}
    if bias:
        leaves["bias"] = jnp.asarray(b)
    dense = QuantDense(40, use_bias=bias)
    want = np.asarray(jax.jit(dense.apply)({"params": leaves}, jnp.asarray(x)))

    m = _quant_linear(w, b)
    got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RESCALE_TOL,
                               atol=RESCALE_TOL * np.abs(want).max())
    x_q, _ = quantize_rows(torch.from_numpy(x))
    x_q = x_q.reshape(-1, 64)
    jacc = jax.jit(lambda a, k: jax.lax.dot_general(
        a, k, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32))(
        jnp.asarray(x_q.numpy()), jnp.asarray(wq))
    acc = int8_mm(x_q, m.weight_q)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    # XLA's x_q under jit, from the same lines as QuantDense's
    def jxq(v):
        xs = jnp.maximum(jnp.max(jnp.abs(v), axis=-1, keepdims=True), 1e-12) / 127.0
        return jnp.clip(jnp.round(v / xs), -127.0, 127.0).astype(jnp.int8)
    np.testing.assert_array_equal(x_q.numpy().reshape(x.shape),
                                  np.asarray(jax.jit(jxq)(jnp.asarray(x))))


@pytest.mark.parametrize("m,k,n", [(8, 12, 20), (3, 16, 8), (40, 4096, 24), (17, 8, 3)])
def test_int8_mm_exact_and_padded(m, k, n):
    """The CPU product equals the plain integer math; the zero-padded
    operands CUDA's _int_mm takes give the same sums.  At depth 4096 the
    sums pass 2^24, where an f32 product rounds."""
    rng = np.random.default_rng(m * k + n)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    if k == 4096:
        x[0], w[0] = 127, 127                  # |acc| = 127^2 * 4096 > 2^24
    want = x.numpy().astype(np.int64) @ w.numpy().astype(np.int64).T
    plain = int8_mm_plain(x, w)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(int8_mm(x, w).numpy(), want)
    a, b = pad_for_int_mm(x, w)
    assert a.shape[0] >= INT_MM_MIN_ROWS and a.shape[1] % INT_MM_ALIGN == 0
    assert b.shape[0] % INT_MM_ALIGN == 0 and a.shape[1] == b.shape[1]
    assert a.is_contiguous() and b.is_contiguous()
    np.testing.assert_array_equal(torch._int_mm(a, b.t())[:m, :n].numpy(), want)
    if k == 4096:
        assert abs(int(want[0, 0])) > 2 ** 24


@pytest.mark.parametrize("x,w,match", [
    (torch.zeros(4, 8, dtype=torch.int32), torch.zeros(8, 8, dtype=torch.int8), "int8"),
    (torch.zeros(4, 8, dtype=torch.int8), torch.zeros(8, 12, dtype=torch.int8), "(M, K)"),
    (torch.zeros(0, 8, dtype=torch.int8), torch.zeros(8, 8, dtype=torch.int8), "empty"),
    (torch.zeros(1, MAX_DEPTH + 1, dtype=torch.int8),
     torch.zeros(1, MAX_DEPTH + 1, dtype=torch.int8), "overflow"),
])
def test_int8_mm_refuses(x, w, match):
    for fn in (int8_mm, int8_mm_plain):
        with pytest.raises(ValueError, match=match):
            fn(x, w)


# -- which modules are quantized -------------------------------------------------------


def _jax_quantized_paths(tree):
    """Module paths ``params/...`` of the kernel_q leaves of a quantized
    flax tree, and of the 2-D kernels it left float."""
    flat = flatten_dict(tree, sep="/")
    q = {k.rsplit("/", 1)[0] for k in flat if k.endswith("/kernel_q")}
    f = {k.rsplit("/", 1)[0] for k, v in flat.items()
         if k.endswith("/kernel") and np.ndim(v) == 2}
    return q, f


def _port_paths(model, kind):
    return {flax_key(f"{name}.weight", mod).rsplit("/", 1)[0]
            for name, mod in model.named_modules() if isinstance(mod, kind)}


@pytest.mark.parametrize("which", ["codec", "titok"])
def test_quantized_set_equals_quantize_dense_tree_tiny(which):
    """quantize_linears on the tiny codec (and the tiny TiTok, whose
    encoder's conv_out is sensitive) quantizes exactly the layers whose
    kernels quantize_dense_tree rewrites, to the same bytes; the sensitive
    layers stay Linear."""
    from sic_tpu.ops.quant import quantize_dense_tree
    from sic_tpu_torch.models.layers import Linear
    if which == "codec":
        from sic_tpu_torch.models import Codec
        model = Codec(tcfg.tiny_spec())
    else:
        from sic_tpu_torch.models.titok import TiTok
        from sic_tpu_torch.models.maskgit_vqgan import MaskGITVQGANSpec
        ts = tcfg.tiny_spec().titok
        model = TiTok(ts, MaskGITVQGANSpec(hidden_channels=32, channel_mult=(1, 2),
                                           num_res_blocks=1, z_channels=32,
                                           num_embeddings=32, embedding_dim=32))
    init_seeded(model, 3)
    flat = export_flax_params(model)
    jtree = quantize_dense_tree(unflatten_dict(flat, sep="/"))
    jq, jfloat = _jax_quantized_paths(jtree)
    quantize_linears(model)
    assert _port_paths(model, QuantLinear) == jq and jq
    assert _port_paths(model, Linear) == jfloat and jfloat
    sensitive = {"codec": {"params/hybrid_codec/encoder/conv_out",
                           "params/prior_fusion/ffn_fc2"},
                 "titok": {"params/encoder/conv_out"}}[which]
    assert jfloat == sensitive
    jflat = flatten_dict(jtree, sep="/")
    for name, mod in model.named_modules():
        if isinstance(mod, QuantLinear):
            base = flax_key(f"{name}.weight", mod).rsplit("/", 1)[0]
            assert mod.weight_q.numpy().T.tobytes() == np.asarray(
                jflat[f"{base}/kernel_q"]).tobytes(), base
            assert mod.weight_s.numpy().tobytes() == np.asarray(
                jflat[f"{base}/kernel_s"]).tobytes(), base
            if mod.bias is not None:
                np.testing.assert_array_equal(mod.bias.numpy(), jflat[f"{base}/bias"])


def test_quantized_set_equals_quantize_dense_tree_flagship():
    """By structure on flagship_spec(): the JAX tree from jax.eval_shape of
    the init (nothing computed) under quantize_dense_tree's rule, against
    the port's flagship codec built on the meta device."""
    from sic_tpu.config import flagship_spec as jflagship
    from sic_tpu.models.codec import Codec as JCodec
    from sic_tpu.ops.quant import _is_sensitive
    from sic_tpu_torch.models import Codec
    from sic_tpu_torch.models.layers import Linear
    spec = jflagship()
    x = jax.ShapeDtypeStruct((1, spec.tile_px, spec.tile_px, 3), jnp.float32)
    shapes = jax.eval_shape(functools.partial(JCodec(spec).init, method=JCodec.init_all),
                            jax.random.PRNGKey(0), x)
    jq, jfloat = set(), set()
    for path, leaf in flatten_dict(shapes).items():
        if path[-1] == "kernel" and len(leaf.shape) == 2:
            (jfloat if _is_sensitive(path[:-1]) else jq).add("/".join(path[:-1]))
    with torch.device("meta"):
        model = Codec(tcfg.flagship_spec())
    port_q = {flax_key(f"{n}.weight", m).rsplit("/", 1)[0]
              for n, m in model.named_modules()
              if isinstance(m, Linear) and not m.sensitive}
    port_f = _port_paths(model, Linear) - port_q
    assert port_q == jq and len(jq) > 400
    assert port_f == jfloat == {"params/hybrid_codec/encoder/conv_out",
                                "params/prior_fusion/ffn_fc2"}


# -- the runtime --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runtimes():
    """The golden params in both packages: JAX fp32 and int8 runtimes (their
    stages compiled once, here), and the port's fp32, bf16, int8 and
    int8+bf16 runtimes, one substream each."""
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu.models import CodecRuntime as JRuntime
    sys.path.insert(0, str(GOLDEN.parents[1]))
    from fixtures.golden.generate import load_params
    params = load_params(GOLDEN / "params.npz")
    out = {"jax_int8": JRuntime(jtiny(), params, stream_part=1, quant="int8"),
           "jax_f32": JRuntime(jtiny(), params, stream_part=1)}
    for name, dtype, quant in (("f32", None, None), ("bf16", "bfloat16", "none"),
                               ("int8", None, "int8"), ("int8_bf16", "bfloat16", "int8")):
        out[name] = load_runtime(str(GOLDEN / "params.npz"), tcfg.tiny_spec(),
                                 device="cpu", stream_part=1, dtype=dtype, quant=quant)
    yield out
    for name in ("f32", "bf16", "int8", "int8_bf16"):
        out[name].close()


def test_int8_runtime_layout(runtimes):
    """The int8 net is a runtime-owned copy quantized from the f32 weights;
    the bottleneck is shared; with bf16 the QuantLinears return bf16 and the
    sensitive layers compute in bf16."""
    rt, rb = runtimes["int8"], runtimes["int8_bf16"]
    assert rt.quant == "int8" and runtimes["f32"].quant is None
    for r in (rt, rb):
        assert r.net is not r.model
        assert r.net.hybrid_codec.quantize_feat is r.model.hybrid_codec.quantize_feat
        assert not any(isinstance(m, QuantLinear) for m in r.model.modules())
    fc = rt.net.prior_fusion.ffn_fc1
    ref = QuantLinear.from_linear(rt.model.prior_fusion.ffn_fc1)
    assert torch.equal(fc.weight_q, ref.weight_q) and torch.equal(fc.weight_s, ref.weight_s)
    assert isinstance(rb.net.prior_fusion.ffn_fc1, QuantLinear)
    assert rb.net.prior_fusion.ffn_fc1.compute_dtype == torch.bfloat16
    assert rb.net.prior_fusion.ffn_fc1.weight_s.dtype == torch.float32
    assert torch.equal(rb.net.prior_fusion.ffn_fc1.weight_q, fc.weight_q)
    assert rb.net.prior_fusion.ffn_fc2.weight.dtype == torch.bfloat16
    assert rb.net.hybrid_codec.encoder.conv_out.compute_dtype == torch.bfloat16
    x = torch.randn(1, 4, 4, rb.net.prior_fusion.ffn_fc1.in_features)
    assert rb.net.prior_fusion.ffn_fc1(x.to(torch.bfloat16)).dtype == torch.bfloat16


def test_int8_runtime_stream_compat(runtimes):
    """Streams written by any of the four runtimes decode in each of them to
    the encoder's y_hat bit for bit; int8 semantic tokens mostly agree with
    fp32's (the pre-VQ projection is float); the int8 decode is
    deterministic, and its pixels stay near fp32's on seeded weights."""
    x = np.random.default_rng(2).uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    names = ("f32", "bf16", "int8", "int8_bf16")
    encs = {}
    for n in names:
        probe = {}
        encs[n] = (runtimes[n].encode_only(x, probe=probe), probe["y_hat"])
    for n_enc, (enc, y_hat) in encs.items():
        for n_dec in names:
            out = {}
            runtimes[n_dec].decode_only(**enc, coding_batch=8, probe=out)
            assert torch.equal(out["h_hat"], y_hat), (n_enc, n_dec)
    n = encs["f32"][0]["token_length"]
    zf = runtimes["f32"]._decode_z(encs["f32"][0]["z_bit_stream"], n, "rans")
    zq = runtimes["int8"]._decode_z(encs["int8"][0]["z_bit_stream"], n, "rans")
    assert (zf != zq).mean() < 0.5
    enc = encs["int8"][0]
    xq = runtimes["int8"].decode_only(**enc, coding_batch=8)
    assert torch.equal(xq, runtimes["int8"].decode_only(**enc, coding_batch=8))
    xf = runtimes["f32"].decode_only(**enc, coding_batch=8)
    assert float(torch.linalg.norm(xf - xq) / torch.linalg.norm(xf)) < 0.3


def test_golden_stream_int8_decode_matches_jax(runtimes):
    """golden.c2df decoded in int8 by both packages: the port's h_hat that of
    its fp32 decode, bit for bit; the pixels within the bound in the module
    docstring; JAX's own int8-vs-fp32 gap the one fixtures/golden_int8.py
    records."""
    from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
    enc, header = unpack_c2df(GOLDEN / "golden.c2df")
    enc = sanitize_enc_result_types(enc)
    kw = dict(z_coder=header["z_coder"], coding_batch=header["coding_batch"])
    jq = np.asarray(runtimes["jax_int8"].decode_only(**enc, **kw))
    jf = np.asarray(runtimes["jax_f32"].decode_only(**enc, **kw))
    probe, probe32 = {}, {}
    port = runtimes["int8"].decode_only(**enc, **kw, probe=probe).numpy()
    port32 = runtimes["f32"].decode_only(**enc, **kw, probe=probe32).numpy()
    assert torch.equal(probe["h_hat"], probe32["h_hat"])
    np.testing.assert_allclose([np.abs(jq - jf).max(), np.abs(jq - jf).mean()],
                               [JAX_GAP_MAX, JAX_GAP_MEAN], rtol=0.1)
    for stat in (np.max, np.mean):
        gap = stat(np.abs(jq - jf))
        assert 0 < stat(np.abs(port - jq)) <= GAP_MULTIPLE * gap
        assert 0 < stat(np.abs(port - port32)) <= GAP_MULTIPLE * gap


def test_jax_int8_stream_decodes_in_the_port(runtimes):
    """golden_input() encoded by the JAX int8 runtime: the port's int8
    runtime reads the JAX decoder's symbols (y_hat within Y_HAT_TOL: its
    decode transform is float), and its pixels lie within the bound of the
    module docstring of the JAX int8 decode's."""
    from fixtures.golden.generate import golden_input
    jrt, jf = runtimes["jax_int8"], runtimes["jax_f32"]
    jenc = jrt.encode_only(jnp.asarray(golden_input()[None]))
    fs = jenc["feat_shape"]
    y_jax = np.asarray(jrt.h_coder.decompress(
        jenc["h_bit_stream"], (fs[0], fs[1], fs[2], tcfg.tiny_spec().quant_dim)))
    probe = {}
    port = runtimes["int8"].decode_only(**jenc, coding_batch=8, probe=probe).numpy()
    np.testing.assert_allclose(probe["h_hat"].numpy(), y_jax, rtol=0, atol=Y_HAT_TOL)
    jq = np.asarray(jrt.decode_only(**jenc))
    jfp = np.asarray(jf.decode_only(**jenc))
    for stat in (np.max, np.mean):
        assert stat(np.abs(port - jq)) <= GAP_MULTIPLE * stat(np.abs(jq - jfp))


# -- the user surface ------------------------------------------------------------------------


def test_clis_take_quant_int8(tmp_path, runtimes):
    """--quant int8 through the compress, decompress and evaluate CLIs on the
    CPU: the decompressed PNG is the int8 runtime's decode of the stream
    compress wrote, and evaluate's records carry that stream's rate."""
    import io
    import json
    import shutil

    from PIL import Image

    from sic_tpu_torch.cli.compress import main as compress
    from sic_tpu_torch.cli.decompress import main as decompress
    from sic_tpu_torch.cli.evaluate import main as evaluate
    from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
    src = tmp_path / "in"
    src.mkdir()
    shutil.copy(GOLDEN.parents[2] / "artifacts_r05" / "heldout" / "val0.png", src)
    common = ["--spec", "tiny", "--device", "cpu", "--quant", "int8",
              "--ckpt_path", str(GOLDEN / "params.npz")]
    assert compress(["--dataset_dir", str(src), "--save_dir", str(tmp_path / "out"),
                     "--stream_part", "1", *common])["images"] == 1
    assert decompress(["--dataset_dir", str(tmp_path / "out" / "bitstreams"),
                       "--save_dir", str(tmp_path / "png"), *common]) == 1
    enc, header = unpack_c2df(tmp_path / "out" / "bitstreams" / "val0.c2df")
    enc = dict(sanitize_enc_result_types(enc), z_coder=header["z_coder"],
               coding_batch=header["coding_batch"])
    want = runtimes["int8"].decode_only(**enc, output="u8")[0].numpy()
    got = np.asarray(Image.open(tmp_path / "png" / "val0.png"))
    np.testing.assert_array_equal(got, want[:got.shape[0], :got.shape[1]])
    buf = io.StringIO()
    evaluate(["--dataset_dir", str(src), *common], out=buf)
    rec = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(rec) == 2 and rec[0]["bpp"] > 0 and rec[-1]["n"] == 1


def test_sic_quant_reaches_load_runtime_and_the_service(monkeypatch, runtimes, tmp_path):
    """SIC_QUANT=int8 with no --quant: load_runtime serves int8, and so does
    the service, whose /decompress of golden.c2df is the int8 runtime's
    decode; an explicit quant wins over the variable."""
    import io
    import threading
    import urllib.request
    import uuid

    from PIL import Image

    from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
    from sic_tpu_torch.service import ServiceState, make_server
    monkeypatch.setenv("SIC_QUANT", "int8")
    ckpt = str(GOLDEN / "params.npz")
    rt = load_runtime(ckpt, tcfg.tiny_spec(), device="cpu")
    assert rt.quant == "int8"
    rt.close()
    rt = load_runtime(ckpt, tcfg.tiny_spec(), device="cpu", quant="none")
    assert rt.quant is None and rt.net is rt.model
    rt.close()
    state = ServiceState("tiny", ckpt_path=ckpt, device="cpu",
                         index_dir=tmp_path / "faiss", media_root=tmp_path,
                         preview_cache=tmp_path / "previews")
    srv = make_server(state, host="127.0.0.1", port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        payload = (GOLDEN / "golden.c2df").read_bytes()
        boundary = uuid.uuid4().hex
        body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                f"filename=\"g.c2df\"\r\nContent-Type: application/octet-stream"
                f"\r\n\r\n").encode() + payload + f"\r\n--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/decompress", data=body,
            headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            png = np.asarray(Image.open(io.BytesIO(resp.read())))
        assert state.runtime.quant == "int8"
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
        state.close()
    enc, header = unpack_c2df(GOLDEN / "golden.c2df")
    enc = dict(sanitize_enc_result_types(enc), z_coder=header["z_coder"],
               coding_batch=header["coding_batch"])
    want = runtimes["int8"].decode_only(**enc, output="u8")[0].numpy()
    np.testing.assert_array_equal(png, want[:png.shape[0], :png.shape[1]])
