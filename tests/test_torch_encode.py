"""Kernel 4's module (rANS plane encode) against the native coder and the
JAX package, on the CPU.

On the CPU the wrapper runs its plain PyTorch version; here it must write
the native encoder's bytes exactly (``cpp/sic_rans.cc:40-135``) and the
same substreams as the JAX package's TPU kernel in interpret mode, for 1,
4 and 8 substreams with skipped positions and escapes up to the int16
clamp.  The CUDA kernel is held to the plain version by
``test_torch_gpu.py`` and ``chip_smoke.py`` on a card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sic_tpu_torch import ops
from sic_tpu_torch.entropy import EntropyCoder, build_gaussian_tables
from sic_tpu_torch.models.bottleneck import (BottleneckCoder,
                                             CompressiveBottleneck,
                                             worst_case_bytes)
from sic_tpu_torch.ops import rans_encode as renc


@pytest.fixture(scope="module")
def tables():
    t = build_gaussian_tables("gaussian")
    return t, [torch.from_numpy(a.astype(np.int32)) for a in
               (t.quantized_cdf, t.cdf_length, t.offset)]


def _planes(rng, B, n, escape_rate, t, skip_rate=0.2):
    """Four (B, n) int16 planes: skipped positions, small symbols, and
    escapes up to the +-30000 clamp."""
    out = []
    for _ in range(4):
        idx = rng.integers(0, t.levels, (B, n)).astype(np.int16)
        skip = rng.random((B, n)) < skip_rate
        idx[skip] = -1
        sym = rng.integers(-6, 7, (B, n)).astype(np.int16)
        esc = rng.random((B, n)) < escape_rate
        sym[esc] = rng.integers(-30000, 30001, int(esc.sum())).astype(np.int16)
        sym[skip] = 0
        out.append((sym, idx))
    return out


def _native(planes, nparts, t):
    """One framed stream per image from the port's native encoder."""
    out = []
    for b in range(planes[0][0].shape[0]):
        c = EntropyCoder(nparts)
        g = c.add_cdf(t.quantized_cdf, t.cdf_length, t.offset)
        c.reset()
        for sym, idx in planes:
            c.encode_with_indexes(sym[b], idx[b], g)
        c.flush()
        out.append(c.get_encoded_stream())
    return out


def _port(planes, nparts, tabs, nwords):
    """Plain encode: planes last to first, state threaded through."""
    B, n = planes[0][0].shape
    S = B * nparts
    words = torch.zeros((S, nwords), dtype=torch.int32)
    st = renc.initial_state(S)
    for sym, idx in reversed(planes):
        rows = renc.split_plane_rows(torch.from_numpy(sym.astype(np.int32)),
                                     torch.from_numpy(idx.astype(np.int32)),
                                     nparts)
        words, st = ops.rans_encode_plane(rows[0].contiguous(),
                                          rows[1].contiguous(), words, st,
                                          *tabs)
    return words.numpy(), st.numpy()


def _jax(planes, nparts, t, nwords):
    """The TPU kernel in interpret mode on pre-reversed rows (S padded to
    its 8-lane groups with skipped rows)."""
    from sic_tpu.ops import rans_encode as jenc
    B, n = planes[0][0].shape
    S = B * nparts
    S8 = -(-S // 8) * 8
    words = jnp.zeros((S8, nwords), jnp.uint32)
    meta = jnp.zeros((S8, 4), jnp.uint32).at[:, 0].set(1 << 23)
    for sym, idx in reversed(planes):
        s_r, i_r = jenc.split_plane_rows(sym.astype(np.int32),
                                         idx.astype(np.int32), nparts)
        s_p = np.zeros((S8, n // nparts), np.int32)
        i_p = np.full((S8, n // nparts), -1, np.int32)
        s_p[:S], i_p[:S] = s_r, i_r
        words, meta = jenc.rans_encode_plane(
            jnp.asarray(s_p), jnp.asarray(i_p), words, meta,
            jnp.asarray(t.quantized_cdf), jnp.asarray(t.cdf_length),
            jnp.asarray(t.offset), interpret=True)
    return jenc.finalize_streams(np.asarray(words), np.asarray(meta), S)


@pytest.mark.parametrize("nparts", [1, 4, 8])
def test_plain_encode_matches_native_and_jax_kernel(tables, nparts):
    t, tabs = tables
    B, n = 2, 512
    planes = _planes(np.random.default_rng(nparts), B, n, 0.1, t)
    want = _native(planes, nparts, t)
    nwords = -(-worst_case_bytes(4 * n // nparts) // 4)
    words, st = _port(planes, nparts, tabs, nwords)
    parts = renc.finalize_streams(words, st, B * nparts)
    got = [renc.frame_substreams(parts[b * nparts:(b + 1) * nparts])
           for b in range(B)]
    assert got == want
    assert (np.abs(planes[0][0]) > 20000).any()     # wide escapes ran
    # the JAX kernel caps its words at 2 bytes a position (its host
    # fallback takes over beyond); these planes fit in that
    jparts = _jax(planes, nparts, t, renc.encode_buffer_words(4 * n // nparts))
    assert jparts == parts


def test_framing_and_finalize_match_jax(tables):
    from sic_tpu.ops import rans_encode as jenc
    t, tabs = tables
    planes = _planes(np.random.default_rng(3), 1, 1024, 0.05, t)
    words, st = _port(planes, 4, tabs, 1024)
    assert renc.finalize_streams(words, st, 4) == \
        jenc.finalize_streams(words.view(np.uint32), st.astype(np.uint32), 4)
    parts = renc.finalize_streams(words, st, 4)
    assert renc.frame_substreams(parts) == jenc.frame_substreams(parts)
    big = [b"\x01" * 70000, b"\x02" * 5, b"\x03" * 9]    # 4-byte size headers
    assert renc.frame_substreams(big) == jenc.frame_substreams(big)
    for npos in (1, 300, 5000):
        assert renc.encode_buffer_words(npos) == jenc.encode_buffer_words(npos)
    # an overflowed row yields no streams in either package
    st_ov = st.copy()
    st_ov[2, 2] = 1
    assert renc.finalize_streams(words, st_ov, 4) is None
    assert jenc.finalize_streams(words.view(np.uint32),
                                 st_ov.astype(np.uint32), 4) is None


@pytest.fixture(scope="module")
def coder():
    from test_torch_bottleneck import _randomize
    m = _randomize(CompressiveBottleneck(64, 16), 0)
    return BottleneckCoder(m, stream_part=4)


def test_device_encode_doubles_on_overflow(coder, monkeypatch):
    """A buffer of 4 words a substream overflows and doubles until the
    streams fit; the bytes equal the host coder's."""
    from sic_tpu_torch.models import bottleneck
    calls = []

    def counted(*args):
        calls.append(args[2].shape[1])                # the buffer's words
        return ops.rans_encode_plane(*args)

    monkeypatch.setattr(bottleneck, "rans_encode_plane", counted)
    monkeypatch.setattr(bottleneck, "encode_buffer_words", lambda npos: 4)
    y = torch.from_numpy((3.0 * np.random.default_rng(1).standard_normal(
        (3, 8, 8, 64))).astype(np.float32))
    packed, y_hat = coder.compress_plan(y)
    host = coder.encode_packed_many(packed)
    ops.reset_launch_counts()
    streams, y_hat_dev = coder.compress_device(y)
    assert streams == host
    assert torch.equal(y_hat_dev, y_hat)
    sizes = sorted(set(calls))
    assert len(calls) == 4 * len(sizes) and len(sizes) > 1
    assert all(b == 2 * a for a, b in zip(sizes, sizes[1:]))
    assert ops.launch_counts()["rans_encode_plane"] == 0   # CPU: plain version


def test_device_encode_raises_at_the_cap(coder, monkeypatch):
    """With the cap set too small the encode raises: no host fallback."""
    from sic_tpu_torch.models import bottleneck
    monkeypatch.setattr(bottleneck, "worst_case_bytes", lambda npos: 8)
    y = torch.from_numpy((3.0 * np.random.default_rng(2).standard_normal(
        (1, 8, 8, 64))).astype(np.float32))
    with pytest.raises(RuntimeError, match="overflowed"):
        coder.compress_device(y)


def test_uneven_planes_are_refused(coder):
    """A plane that does not split into the substreams raises before any
    launch (the runtime routes such batches to the host coder)."""
    y = torch.zeros((1, 3, 3, 64))                   # 3*3*4 = 36 positions
    odd = BottleneckCoder(coder.module, stream_part=8)
    assert not odd.can_compress_on_device((1, 3, 3, 16))
    with pytest.raises(ValueError, match="substreams"):
        odd.compress_device(y)


def test_worst_case_plane_fits_the_cap(tables):
    """Every position of all four planes escaping at the clamp stays
    within ``worst_case_bytes``."""
    t, tabs = tables
    n = 64
    widest = int(np.argmax(t.cdf_length))
    planes = [(np.full((1, n), s, np.int16), np.full((1, n), widest, np.int16))
              for s in (30000, -30000, 30000, -30000)]
    words, st = _port(planes, 1, tabs, -(-worst_case_bytes(4 * n) // 4))
    assert st[0, 2] == 0
    assert st[0, 1] <= worst_case_bytes(4 * n)
    assert renc.frame_substreams(renc.finalize_streams(words, st, 1)) == \
        _native(planes, 1, t)[0]
