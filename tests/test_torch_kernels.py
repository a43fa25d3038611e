"""The port's three kernel modules against the JAX package, on the CPU.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version to the JAX function at the decode path's sequence lengths and
bias layouts (attention within 1e-5, fp32) and to the native coder exactly
(rANS symbols and final states).  The CUDA kernels are held to the plain
versions by ``test_torch_gpu.py`` and ``chip_smoke.py`` on a card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sic_tpu_torch import ops
from sic_tpu_torch.entropy import EntropyCoder, build_gaussian_tables
from sic_tpu_torch.ops.rans_decode import words_tensor

ATTN_TOL = 1e-5


def _qkv(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- sequence attention -------------------------------------------------------

@pytest.mark.parametrize("S", [289, 545])
def test_seq_attention_plain_matches_jax(S):
    from sic_tpu.ops.seq_attention import _seq_attn_reference
    qkv = _qkv((2, S, 3 * 128), S)
    ref = _seq_attn_reference(jnp.asarray(qkv), 0.125, 2)
    out = ops.seq_attention(torch.from_numpy(qkv), 0.125, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=ATTN_TOL,
                               atol=ATTN_TOL)


# -- NHWC window attention ----------------------------------------------------

def _window_bias(nB, seed, nwh=2, nww=3, ws=16):
    from sic_tpu.models.swin import _full_shift_mask
    rel = np.random.default_rng(seed).standard_normal((ws * ws, ws * ws))
    if nB == 1:
        return rel[None].astype(np.float32)
    return (rel[None] + _full_shift_mask(nwh, nww, ws)).astype(np.float32)


@pytest.mark.parametrize("nB", [1, 6])
def test_window_attention_plain_matches_jax(nB):
    """nB = 1 (shared relative bias) and nB = nW (bias plus the -inf
    masks of a shifted layer, 2x3 windows)."""
    from sic_tpu.ops.window_attention import _nhwc_pallas, _nhwc_reference
    qkv = _qkv((1, 32, 48, 3 * 128), nB)
    bias = _window_bias(nB, 10 + nB)
    ref = _nhwc_reference(jnp.asarray(qkv), jnp.asarray(bias), 0.125, 2)
    out = ops.window_attention_nhwc(torch.from_numpy(qkv),
                                    torch.from_numpy(bias), 0.125, 2)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    # the TPU kernel's own window -> bias-row map, (i * nww + j) % nB
    pallas = _nhwc_pallas(jnp.asarray(qkv[:, :16]), jnp.asarray(bias[:3]),
                          0.125, 2, interpret=True) if nB > 1 else None
    if pallas is not None:
        mine = ops.window_attention_nhwc(torch.from_numpy(qkv[:, :16].copy()),
                                         torch.from_numpy(bias[:3].copy()),
                                         0.125, 2)
        np.testing.assert_allclose(mine.numpy(), np.asarray(pallas),
                                   rtol=ATTN_TOL, atol=ATTN_TOL)


# -- rANS plane decode --------------------------------------------------------

def _planes(rng, n, escape_rate, skip_rate=0.2, ncdf=64):
    out = []
    for _ in range(4):
        idx = rng.integers(0, ncdf, size=n).astype(np.int16)
        skip = rng.random(n) < skip_rate
        idx[skip] = -1
        sym = rng.integers(-6, 7, size=n).astype(np.int16)
        esc = rng.random(n) < escape_rate
        sym[esc] = rng.integers(-4000, 4000, size=int(esc.sum())).astype(np.int16)
        sym[skip] = 0
        out.append((sym, idx))
    return out


def _encode(planes, stream_part, tables):
    coder = EntropyCoder(stream_part)
    g = coder.add_cdf(tables.quantized_cdf, tables.cdf_length, tables.offset)
    coder.reset()
    for sym, idx in planes:
        coder.encode_with_indexes(sym, idx, g)
    coder.flush()
    stream = coder.get_encoded_stream()
    coder.set_stream(stream)
    return stream, [coder.decode_stream(idx, g) for _, idx in planes]


def _decode_planes(stream, planes, stream_part, tables, fn):
    words, lens, state = ops.pack_substreams(ops.split_substreams(stream))
    npos = planes[0][1].size // stream_part
    words_t = words_tensor(words)
    lens_t = torch.from_numpy(lens)
    st = torch.from_numpy(state)
    cdf = [torch.from_numpy(a.astype(np.int32)) for a in
           (tables.quantized_cdf, tables.cdf_length, tables.offset)]
    syms, states = [], []
    for _sym, idx in planes:
        rows = idx.astype(np.int32).reshape(stream_part, npos)
        out, st = fn(torch.from_numpy(rows), words_t, lens_t, st, *cdf)
        syms.append(out.reshape(-1).numpy())
        states.append(st.numpy().copy())
    return syms, states


@pytest.mark.parametrize("stream_part", [1, 4])
@pytest.mark.parametrize("escape_rate", [0.0, 0.15])
def test_rans_plain_matches_native_and_jax(stream_part, escape_rate):
    """Streams from the port's copy of the native encoder: the plain decode
    gives the native decoder's symbols and the JAX kernel's (interpret mode)
    symbols and final (x, pos) states, exactly."""
    from sic_tpu.ops.rans_decode import rans_decode_plane as jdecode
    t = build_gaussian_tables("gaussian")
    planes = _planes(np.random.default_rng(7 + stream_part), 256, escape_rate)
    stream, host = _encode(planes, stream_part, t)
    syms, states = _decode_planes(stream, planes, stream_part, t,
                                  ops.rans_decode_plane)
    for got, want in zip(syms, host):
        np.testing.assert_array_equal(got, want.astype(np.int32))

    def jax_fn(rows, words, lens, st, cdf, sizes, offs):
        # the TPU kernel takes rows in groups of 8: pad with skipped rows
        pad = (-rows.shape[0]) % 8

        def rows8(a, fill=0):
            a = a.numpy()
            return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])

        out, st2 = jdecode(jnp.asarray(rows8(rows, -1)),
                           jnp.asarray(rows8(words).view(np.uint32)),
                           jnp.asarray(rows8(lens)),
                           jnp.asarray(rows8(st).astype(np.uint32)),
                           jnp.asarray(cdf.numpy()), jnp.asarray(sizes.numpy()),
                           jnp.asarray(offs.numpy()), interpret=True)
        n = rows.shape[0]
        return (torch.from_numpy(np.array(out)[:n]),
                torch.from_numpy(np.array(st2)[:n].astype(np.int64)))

    jsyms, jstates = _decode_planes(stream, planes, stream_part, t, jax_fn)
    for a, b in zip(syms, jsyms):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(states, jstates):
        np.testing.assert_array_equal(a, b)


def test_stream_framing_matches_jax():
    from sic_tpu.ops import rans_decode as jrd
    t = build_gaussian_tables("gaussian")
    planes = _planes(np.random.default_rng(3), 512, 0.05)
    stream, _ = _encode(planes, 4, t)
    parts = ops.split_substreams(stream)
    assert parts == jrd.split_substreams(stream)
    w, ln, st = ops.pack_substreams(parts)
    jw, jln, jst = jrd.pack_substreams(parts)
    # the JAX package pads rows to 8 and words to a power of two; the
    # port's rows are its prefix and the JAX padding holds only zeros
    S, nw = w.shape
    np.testing.assert_array_equal(w, jw[:S, :nw])
    assert not jw[:, nw:].any() and not jw[S:].any()
    np.testing.assert_array_equal(ln, jln[:S])
    np.testing.assert_array_equal(st, jst[:S].astype(np.int64))
    with pytest.raises(ValueError):
        ops.pack_substreams([b"\x00\x01"])


# -- wrappers never fall back -------------------------------------------------

def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """A tensor off the CPU goes to the kernel or raises: a meta tensor
    raises and launches nothing."""
    ops.reset_launch_counts()
    meta = torch.empty((1, 289, 384), device="meta")
    with pytest.raises(ValueError):
        ops.seq_attention(meta, 0.125, 2)
    with pytest.raises(ValueError):
        ops.window_attention_nhwc(torch.empty((1, 16, 16, 384), device="meta"),
                                  torch.empty((1, 256, 256), device="meta"),
                                  0.125, 2)
    with pytest.raises(ValueError):
        ops.rans_decode_plane(*(torch.empty((8, 4), dtype=torch.int32,
                                            device="meta"),) * 7)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}


def test_cpu_calls_launch_nothing():
    ops.reset_launch_counts()
    ops.seq_attention(torch.zeros((1, 5, 384)), 0.125, 2)
    assert ops.launch_counts()["seq_attention"] == 0
