"""The port's parity pieces against the JAX package's, on the CPU: the
factorized prior (``Bitparm`` / ``BitEstimator`` / ``FactorizedCoder``),
the Huffman codec, the Laplace likelihoods, the bottleneck's ablation
helpers and the VQGAN autoencoder (twins of ``tests/test_entropy_extra.py``
and ``tests/test_bottleneck.py::test_entropy_map_helpers``, and more).

Discrete results exactly: Huffman tables and streams, the factorized
coder's CDF tables and stream bytes (the port builds its tables from the
CDF in the arithmetic XLA's CPU backend emits, step by step in IEEE f32
operations: ``entropy.factorized.table_cdf``, bit for bit the JAX module's
jitted CDF), the bottleneck stream, VQ indices.  Floats within ``TOL``
(absolute, on O(1) values) or ``TOL`` relative where a value runs to tens
of bits.
"""
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

import jax
import jax.numpy as jnp

from sic_tpu_torch.weights import export_flax_params
from test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

TOL = 1e-5


def _vars(module):
    return {"params": unflatten_dict(export_flax_params(module), sep="/")["params"]}


def _seeded(module, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy((scale * rng.standard_normal(p.shape))
                                     .astype(np.float32)))
    return module.eval()


# -- the factorized prior ------------------------------------------------------------


@pytest.fixture(scope="module", params=[0, 3])
def estimators(request):
    """A seeded port BitEstimator (8 channels) and its JAX twin's variables."""
    from sic_tpu_torch.entropy import BitEstimator
    m = _seeded(BitEstimator(8), request.param)
    return m, _vars(m)


def test_bitestimator_cdf_monotone_and_prob(estimators):
    """Twin of the JAX package's test, and the port's cdf, prob and bits
    against the JAX module's on the same points within TOL."""
    from sic_tpu.entropy import BitEstimator as JB
    m, v = estimators
    C = m.channel
    xs = np.linspace(-30, 30, 61, dtype=np.float32)[:, None].repeat(C, axis=1)
    t = torch.from_numpy(xs)
    with torch.no_grad():
        cdf, probs, bits = (m(t).numpy(), m.get_prob(t).numpy(),
                            m.get_bits(t).numpy())
    assert np.all(np.diff(cdf, axis=0) >= -1e-6), "CDF must be monotone in x"
    assert np.all(probs >= 1e-10) and np.all(probs <= 1.0 + 1e-6)
    assert np.all(bits >= 0)
    jm = JB(C)
    np.testing.assert_allclose(cdf, np.asarray(jm.apply(v, xs)), rtol=0, atol=TOL)
    np.testing.assert_allclose(probs, np.asarray(jm.apply(v, xs, method=JB.get_prob)),
                               rtol=TOL, atol=TOL * 1e-3)
    np.testing.assert_allclose(bits, np.asarray(jm.apply(v, xs, method=JB.get_bits)),
                               rtol=TOL, atol=TOL)


def test_factorized_tables_and_streams_against_jax(estimators):
    """table_cdf equals the JAX module's jitted CDF bit for bit (tails to
    +-60, subnormals flushed as XLA flushes them); the port's tables are the
    JAX coder's; the port writes the JAX coder's bytes for the same symbols
    and reads the JAX stream back."""
    from sic_tpu.entropy import BitEstimator as JB
    from sic_tpu.entropy import FactorizedCoder as JFC
    from sic_tpu_torch.entropy import FactorizedCoder
    from sic_tpu_torch.entropy.factorized import table_cdf
    m, v = estimators
    C = m.channel
    xs = np.linspace(-60, 60, 1201, dtype=np.float32)[:, None].repeat(C, axis=1)
    want = np.asarray(jax.jit(lambda p, x: JB(C).apply(p, x))(v, xs))
    np.testing.assert_array_equal(table_cdf(m, torch.from_numpy(xs)).numpy(), want)

    jfc, fc = JFC(JB(C), v), FactorizedCoder(m)
    for got, ref in ((fc.quantized_cdf, jfc.quantized_cdf),
                     (fc.cdf_length, jfc.cdf_length), (fc.offset, jfc.offset)):
        np.testing.assert_array_equal(got, ref)
    x = np.random.default_rng(0).integers(-4, 5, size=(1, 6, 5, C)).astype(np.int32)
    streams = []
    for coder in (jfc, fc):
        coder.coder.reset()
        coder.encode(x)
        coder.coder.flush()
        streams.append(coder.coder.get_encoded_stream())
    assert streams[0] == streams[1] and len(streams[1]) > 0
    fc.coder.set_stream(streams[0])
    np.testing.assert_array_equal(fc.decode_stream((1, 6, 5, C)).astype(np.int32), x)


def test_table_cdf_primitives_match_xla():
    """The fixed-arithmetic exp, log1p, tanh, softplus and sigmoid behind
    table_cdf against the JAX package's jitted functions on 20,000 points,
    bit for bit."""
    from sic_tpu_torch.entropy import factorized as f
    x = (np.random.default_rng(5).standard_normal(20000) * 4).astype(np.float32)
    x[:4] = [0.0, 1e-5, -30.0, 95.0]
    for jfn, fn, arg in ((jnp.exp, f._exp, x), (jnp.tanh, f._tanh, x),
                         (jax.nn.softplus, f._softplus, x),
                         (jnp.log1p, f._log1p, np.abs(x))):
        np.testing.assert_array_equal(fn(torch.from_numpy(arg)).numpy(),
                                      np.asarray(jax.jit(jfn)(arg)), err_msg=jfn.__name__)


# -- Huffman -----------------------------------------------------------------------------


def test_huffman_table_prefix_free_and_optimal_shape():
    from sic_tpu.entropy import build_huffman_table as jbuild
    from sic_tpu_torch.entropy import build_huffman_table
    prob = [0.5, 0.25, 0.15, 0.1]
    table = build_huffman_table(prob)
    assert table == jbuild(prob) and len(table) == 4
    for i, a in enumerate(table):
        for j, b in enumerate(table):
            if i != j:
                assert not b.startswith(a)
    assert len(table[0]) == min(len(c) for c in table)
    H = -sum(p * np.log2(p) for p in prob)
    L = sum(p * len(c) for p, c in zip(prob, table))
    assert H <= L < H + 1
    assert build_huffman_table([1.0]) == ["0"]


def test_huffman_roundtrip_multi_qp_bytes_equal_jax():
    from sic_tpu.entropy import HuffmanCodec as JHuffman
    from sic_tpu_torch.entropy import HuffmanCodec
    probs = {0: [0.7, 0.2, 0.1], 2: [0.25, 0.25, 0.25, 0.25],
             3: list(np.random.default_rng(1).dirichlet(np.ones(40)))}
    codec, jcodec = HuffmanCodec(), JHuffman()
    codec.load_probs(probs)
    jcodec.load_probs(probs)
    rng = np.random.default_rng(3)
    for qp, n_sym in ((0, 3), (2, 4), (3, 40)):
        x = rng.integers(0, n_sym, size=(1, 1, 16, 16))
        stream = codec.compress(x, qp)["bit_stream"]
        assert stream == jcodec.compress(x, qp)["bit_stream"]
        out = codec.decompress(stream, qp)["index"]
        assert out.dtype == np.int64
        np.testing.assert_array_equal(out, x.reshape(-1))
    # qp 0's codes are 1, 01, 00: a stream ending in a lone 0 is no stream
    for c in (codec, jcodec):
        with pytest.raises(ValueError, match="invalid"):
            c.decompress(b"\x02", 0)


# -- Laplace --------------------------------------------------------------------------------


@pytest.mark.parametrize("training", [True, False])
def test_laplace_prob_and_bits_match_jax(training):
    from sic_tpu.entropy import gaussian as jg
    from sic_tpu_torch.entropy import laplace_bits, laplace_prob
    rng = np.random.default_rng(4)
    y = np.round(rng.standard_normal((2, 8, 8, 16)) * 4).astype(np.float32)
    y[0, 0, 0, :4] = [-0.5, 0.5, 0.0, 60.0]
    sigma = np.exp(rng.uniform(-6, 4, y.shape)).astype(np.float32)
    ty, ts = torch.from_numpy(y), torch.from_numpy(sigma)
    got = laplace_bits(ty, ts, training).numpy()
    want = np.asarray(jg.laplace_bits(jnp.asarray(y), jnp.asarray(sigma), training))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.all(got >= 0)
    np.testing.assert_allclose(laplace_prob(ty, ts).numpy(),
                               np.asarray(jg.laplace_prob(jnp.asarray(y), jnp.asarray(sigma))),
                               rtol=TOL, atol=TOL * 1e-3)
    if training:
        ts.requires_grad_(True)
        laplace_bits(ty, ts, True).sum().backward()
        gj = jax.grad(lambda s: jg.laplace_bits(jnp.asarray(y), s, True).sum())(
            jnp.asarray(sigma))
        np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gj), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(gj)).max())


# -- the bottleneck's ablation helpers --------------------------------------------------------


@pytest.fixture(scope="module")
def bottlenecks():
    """A port bottleneck coder (feat 16, quant 8; O(1) weights, as
    test_torch_bottleneck.py seeds them) and the JAX coder over the same
    weights, one substream each."""
    from sic_tpu.models.bottleneck import BottleneckCoder as JCoder
    from sic_tpu.models.bottleneck import CompressiveBottleneck as JBottleneck
    from sic_tpu_torch.models.bottleneck import BottleneckCoder, CompressiveBottleneck
    from test_torch_bottleneck import _randomize
    m = _randomize(CompressiveBottleneck(16, 8), 1)
    return BottleneckCoder(m), JCoder(JBottleneck(16, 8), _vars(m))


def _y(seed):
    return (2.0 * np.random.default_rng(seed).standard_normal((1, 8, 8, 16))).astype(np.float32)


def test_entropy_map_helpers(bottlenecks):
    """Twin of the JAX package's test: the bit map's shape and sign, the
    round trip's validity contract, the map's total behind bpp_est; and
    against the JAX coder: the map within TOL relative, the same stream
    bytes, bpp exactly, bpp_est within TOL relative."""
    coder, jcoder = bottlenecks
    y = _y(0)
    ty = torch.from_numpy(y)
    emap = coder.entropy_map(ty)
    assert emap.shape == (1, 8, 8, 8) and float(emap.min()) >= 0.0
    np.testing.assert_allclose(emap.numpy(), np.asarray(jcoder.entropy_map(jnp.asarray(y))),
                               rtol=TOL, atol=TOL)
    y_hat, info = coder.compress_decompress_entropy_map(ty, (64, 64))
    assert "entropy_map" in info and info["bpp"] > 0
    est_bits = float(info["entropy_map"].sum())
    assert est_bits == pytest.approx(info["bpp_est"] * 64 * 64, rel=1e-3)
    jy_hat, jinfo = jcoder.compress_decompress(jnp.asarray(y), (64, 64))
    assert info["bit_stream"] == jinfo["bit_stream"]
    assert info["bpp"] == jinfo["bpp"]
    assert info["bpp_est"] == pytest.approx(jinfo["bpp_est"], rel=TOL)
    assert torch.equal(info["y_hat"], y_hat)
    np.testing.assert_allclose(y_hat.numpy(), np.asarray(jy_hat), rtol=0, atol=1e-4)


def test_compress_decompress_holds_the_contract(bottlenecks, monkeypatch):
    """A decode that does not reproduce the encoder's y_hat raises."""
    coder, _ = bottlenecks
    real = coder.decompress
    monkeypatch.setattr(coder, "decompress",
                        lambda *a, **k: real(*a, **k) + 1e-3)
    with pytest.raises(AssertionError, match="diverged"):
        coder.compress_decompress(torch.from_numpy(_y(1)), (64, 64))


def test_clone_with_stream_part(bottlenecks):
    """The clone writes the streams a coder built at its part count writes
    (and the JAX package's clone), reads them back, and leaves the
    original's coders alone."""
    from sic_tpu_torch.models.bottleneck import BottleneckCoder
    coder, jcoder = bottlenecks
    ty = torch.from_numpy(_y(2))
    clone = coder.clone_with_stream_part(4)
    assert clone.module is coder.module and clone.coder is not coder.coder
    assert coder.stream_part == 1 and clone.stream_part == 4
    stream, y_hat = clone.compress(ty)
    fresh, _ = BottleneckCoder(coder.module, stream_part=4).compress(ty)
    jstream, _ = jcoder.clone_with_stream_part(4).compress(jnp.asarray(_y(2)))
    assert stream == fresh == jstream and stream[0] >> 4 == 3
    assert torch.equal(clone.decompress(stream, (1, 8, 8, 8)), y_hat)
    assert coder.compress(ty)[0] != stream


# -- the VQGAN autoencoder ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def vqgans():
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu.models.vqgan import VQGAN as JVQGAN
    from sic_tpu_torch import config as tcfg
    from sic_tpu_torch.models.vqgan import VQGAN
    from test_torch_modules import _randomize
    m = _randomize(VQGAN(tcfg.tiny_spec().vqgan), 11)
    return m, JVQGAN(jtiny().vqgan), _vars(m)


def test_vqgan_encode_decode_code_and_forward(vqgans):
    """encode (indices exact, z_q and the codebook loss within TOL),
    embed_code, decode_code and the autoencoder's forward against the JAX
    VQGAN's encode / decode_code / __call__."""
    from sic_tpu.models.vqgan import VQGAN as JVQGAN
    m, jm, v = vqgans
    x = np.random.default_rng(12).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        zq, loss, info = m.encode(torch.from_numpy(x))
        x_hat, loss2, info2 = m(torch.from_numpy(x))
        idx = info["indices"]
        dec = m.decode_code(idx)
        emb = m.quantize.embed_code(idx)
    jzq, jloss, jinfo = jm.apply(v, jnp.asarray(x), method=JVQGAN.encode)
    jx_hat, jloss2, _ = jm.apply(v, jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jinfo["indices"]))
    assert torch.equal(info2["indices"], idx)
    np.testing.assert_allclose(zq.numpy(), np.asarray(jzq), rtol=0, atol=TOL)
    np.testing.assert_allclose([float(loss), float(loss2)], [float(jloss), float(jloss2)],
                               rtol=TOL)
    jemb = jm.apply(v, jinfo["indices"], method=lambda mod, i: mod.quantize.embed_code(i))
    np.testing.assert_array_equal(emb.numpy(), np.asarray(jemb))
    # z_q passes the gradient straight through: codes up to its rounding
    np.testing.assert_allclose(emb.numpy(), zq.numpy(), rtol=0, atol=1e-6)
    jdec = jm.apply(v, jinfo["indices"], method=JVQGAN.decode_code)
    scale = np.abs(np.asarray(jx_hat)).max()
    np.testing.assert_allclose(x_hat.numpy(), np.asarray(jx_hat), rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(dec.numpy(), x_hat.numpy(), rtol=0, atol=TOL * scale)
