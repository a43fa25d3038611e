"""The port's bottleneck coder against the JAX package's, on the CPU.

Discrete results must agree exactly: CDF-index planes, the h-stream bytes
of the host encode, and the symbols a decode reads back.  Within the port,
a decode reproduces the encoder's reconstruction bit for bit (the
sum |y_hat_dec - y_hat_enc| == 0 contract) on the host-coder path, the
device path (its plain rANS on the CPU) and the batched path.
"""
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

import jax.numpy as jnp

from sic_tpu_torch.models.bottleneck import BottleneckCoder, CompressiveBottleneck
from sic_tpu_torch.weights import export_flax_params

FEAT, QUANT = 64, 16


def _randomize(module, seed):
    """Seeded weights at half the lecun scale, which keeps the prior's
    activations O(1) as flax-initialised and trained weights do.  (Much
    larger random weights make the residual sums cancel; the two
    frameworks' last-bit float differences then grow until they can reach
    a CDF-index boundary, which no decoder of a foreign stream survives.)"""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            fan_in = p[0].numel() if p.dim() > 1 else p.numel()
            scale = 0.05 if p.dim() == 1 else 0.5 * fan_in ** -0.5
            base = 1.0 if p.dim() == 2 and p.shape[0] == 1 else 0.0  # gains
            p.copy_(torch.from_numpy(
                base + scale * rng.standard_normal(p.shape).astype(np.float32)))
    return module.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def pair():
    """(port coder, JAX coder) over the same weights, 4 substreams."""
    from sic_tpu.models.bottleneck import BottleneckCoder as JCoder
    from sic_tpu.models.bottleneck import CompressiveBottleneck as JBottleneck
    m = _randomize(CompressiveBottleneck(FEAT, QUANT), 0)
    params = {"params": unflatten_dict(export_flax_params(m), sep="/")["params"]}
    port = BottleneckCoder(m, stream_part=4)
    jax_coder = JCoder(JBottleneck(FEAT, QUANT), params, stream_part=4)
    return port, jax_coder


def _y(B, seed, hw=8):
    return (3.0 * np.random.default_rng(seed).standard_normal(
        (B, hw, hw, FEAT))).astype(np.float32)


def test_index_planes_exact(pair):
    port, jc = pair
    p = jc.params
    *_, common, idx0 = port._prior((8, 8, 8), 0)
    *_, jcommon, jidx0 = jc._prior(p, (8, 8, 8), 0)
    np.testing.assert_array_equal(idx0.numpy(), np.asarray(jidx0))
    y_hat = np.random.default_rng(1).standard_normal((8, 8, 8, QUANT)).astype(np.float32)
    for step in (1, 2, 3):
        _s, _m, idx = port._spatial_step(step, torch.from_numpy(y_hat), common)
        _js, _jm, jidx = jc._spatial_step(p, step, jnp.asarray(y_hat), jcommon)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx0.numpy() >= 0).any() and (idx0.numpy() < 0).any()


def test_host_encode_bytes_equal_jax(pair):
    port, jc = pair
    y = _y(2, 2)
    stream, y_hat = port.compress(torch.from_numpy(y))
    jstream, jy_hat = jc.compress(jnp.asarray(y))
    assert stream == jstream
    np.testing.assert_allclose(y_hat.numpy(), np.asarray(jy_hat),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("path", ["host", "device"])
def test_jax_stream_decodes_to_jax_symbols(pair, path):
    """A stream the JAX package wrote decodes in the port to the symbol
    planes the JAX encoder wrote (device path: the plain rANS decode)."""
    port, jc = pair
    y = _y(1, 3)
    jstream, _ = jc.compress(jnp.asarray(y))
    packed, _ = jc.compress_plan(jnp.asarray(y))
    packed = np.asarray(packed)                      # (4, 2, B, H, W, C/4)
    probe = {}
    fn = port.decompress if path == "host" else port.decompress_device
    fn(jstream, (1, 8, 8, QUANT), coding_batch=8, probe=probe)
    assert probe["h_path"] == path
    for step in range(4):
        np.testing.assert_array_equal(probe["symbol_planes"][step].numpy(),
                                      packed[step, 0].astype(np.int32))
        np.testing.assert_array_equal(probe["index_planes"][step].numpy(),
                                      packed[step, 1].astype(np.int32))
    assert np.abs(packed[:, 0]).max() > 0


@pytest.mark.parametrize("B", [1, 10])
def test_round_trip_is_bit_exact(pair, B):
    """B = 10 spans two coding-batch chunks in one stream."""
    port, _ = pair
    y = torch.from_numpy(_y(B, 4 + B))
    stream, y_hat = port.compress(y)
    host = port.decompress(stream, (B, 8, 8, QUANT))
    dev = port.decompress_device(stream, (B, 8, 8, QUANT))
    assert torch.equal(host, y_hat)
    assert torch.equal(dev, y_hat)


def test_batched_decode_equals_per_image(pair):
    port, _ = pair
    chunks = port.compress_plan_chunks(torch.from_numpy(_y(3, 9)))
    (_start, _real, packed, y_hat), = chunks
    streams = port.encode_packed_many(packed)
    batched = port.decompress_batched(streams, (1, 8, 8, QUANT))
    assert torch.equal(batched, y_hat)
    single = port.decompress(streams[1], (1, 8, 8, QUANT))
    assert torch.equal(single, y_hat[1:2])


@pytest.fixture
def many_cores(monkeypatch):
    """Eight cores as the coders see them, so that the threaded path runs
    on any host; the pools it starts, recorded by their worker counts."""
    import sic_tpu_torch.models.bottleneck as mod
    pools = []

    class Recording(mod.ThreadPoolExecutor):
        def __init__(self, max_workers=None, **kw):
            pools.append(max_workers)
            super().__init__(max_workers=max_workers, **kw)

    monkeypatch.setattr(mod.os, "cpu_count", lambda: 8)
    monkeypatch.setattr(mod, "ThreadPoolExecutor", Recording)
    return pools


@pytest.fixture(scope="module")
def five_images(pair):
    """One coding-batch chunk of five images: packed planes and y_hat."""
    port, _ = pair
    (_start, _real, packed, y_hat), = port.compress_plan_chunks(
        torch.from_numpy(_y(5, 11)))
    return packed, y_hat


def test_encode_packed_many_threaded_equals_serial(pair, five_images, many_cores):
    port, _ = pair
    packed, _ = five_images
    threaded = port.encode_packed_many(packed, workers=8)
    assert many_cores == [5]          # min(workers, cpu count, B)
    serial = port.encode_packed_many(packed, workers=1)
    assert many_cores == [5]          # the serial path starts no pool
    assert threaded == serial
    assert serial == [port.encode_packed(packed[:, :, b:b + 1]) for b in range(5)]


def test_decompress_batched_threaded_equals_serial(pair, five_images, many_cores):
    port, _ = pair
    packed, y_hat = five_images
    streams = port.encode_packed_many(packed, workers=1)
    serial = port.decompress_batched(streams, (1, 8, 8, QUANT), workers=1)
    assert many_cores == []
    threaded = port.decompress_batched(streams, (1, 8, 8, QUANT), workers=8)
    assert many_cores == [5]
    assert torch.equal(serial, y_hat) and torch.equal(threaded, y_hat)


def test_decompress_batched_takes_workers_in_jax_position(pair, five_images, many_cores):
    """The fourth positional argument is ``workers``, as in the JAX
    package: a call written for one package means the same in the other."""
    import inspect

    from sic_tpu.models.bottleneck import BottleneckCoder as JCoder
    port, _ = pair
    packed, y_hat = five_images
    streams = port.encode_packed_many(packed, 8)
    got = port.decompress_batched(streams, (1, 8, 8, QUANT), 0, 3)
    assert many_cores == [5, 3]
    assert torch.equal(got, y_hat)
    for name in ("decompress_batched", "encode_packed_many"):
        ours = list(inspect.signature(getattr(BottleneckCoder, name)).parameters.items())
        jax_params = list(inspect.signature(getattr(JCoder, name)).parameters.items())
        assert [(k, p.default) for k, p in ours[:len(jax_params)]] == \
            [(k, p.default) for k, p in jax_params]
