"""The CUDA kernels of the PyTorch port, on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  The file imports no JAX, so on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Attention kernels agree with their plain versions within 1e-4 in fp32
(summation order only); the rANS kernels agree with the native coder and
with their plain versions exactly.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from sic_tpu_torch import ops
from sic_tpu_torch.entropy import EntropyCoder, build_gaussian_tables
from sic_tpu_torch.ops.rans_decode import words_tensor

pytestmark = pytest.mark.gpu
GOLDEN = Path(__file__).resolve().parent / "fixtures" / "golden"
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    from sic_tpu_torch.models import configure_numerics
    configure_numerics()
    return torch.device("cuda")


def _randn(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, device=device, generator=g)


@pytest.mark.parametrize("B,S,C,heads", [(4, 289, 1024, 16), (4, 545, 768, 12),
                                         (3, 100, 128, 2)])
def test_seq_attention_kernel_matches_plain(cuda, B, S, C, heads):
    qkv = _randn((B, S, 3 * C), S, cuda)
    before = ops.launch_counts()["seq_attention"]
    out = ops.seq_attention(qkv, 0.125, heads)
    assert ops.launch_counts()["seq_attention"] == before + 1
    torch.testing.assert_close(out, ops.seq_attention_plain(qkv, 0.125, heads),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("C,heads", [(768, 12), (1024, 16)])
def test_window_attention_kernel_matches_plain(cuda, shifted, C, heads):
    """2x3 windows: a shared bias (nB = 1), or bias plus shift masks per
    window (nB = nW), where some query rows see -inf key tiles."""
    from sic_tpu_torch.models.swin import _full_shift_mask
    qkv = _randn((2, 32, 48, 3 * C), C, cuda)
    bias = _randn((1, 256, 256), 1, cuda)
    if shifted:
        bias = (bias + torch.from_numpy(_full_shift_mask(2, 3, 16)).to(cuda)).contiguous()
    out = ops.window_attention_nhwc(qkv, bias, 0.125, heads)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(
        out, ops.window_attention_nhwc_plain(qkv, bias, 0.125, heads),
        rtol=TOL, atol=TOL)


def _rel_err(got, want):
    """Largest difference relative to the largest magnitude of ``want``."""
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("B,H,W,C,heads,nB", [
    (2, 16, 16, 768, 12, 1),      # 256 px, one window a map
    (2, 16, 16, 1024, 16, 1),
    (1, 32, 32, 1024, 16, 4),     # 512 px, shifted: a bias per window
    (2, 32, 32, 768, 12, 1),
    (2, 32, 48, 128, 2, 6)])
def test_window_attention_bwd_kernel_matches_plain(cuda, B, H, W, C, heads, nB):
    """dqkv and dbias of the backward kernel against the plain version's
    autograd, within 1e-4 of their largest magnitude (f32 summation order;
    dbias sums over batch, heads and windows).  nB > 1 carries the shift
    masks' -inf entries."""
    from sic_tpu_torch.models.swin import _full_shift_mask
    ws = 16
    qkv = _randn((B, H, W, 3 * C), C + nB, cuda)
    g = _randn((B, H, W, C), 7, cuda)
    bias = _randn((1, 256, 256), 3, cuda)
    if nB > 1:
        mask = _full_shift_mask(H // ws, W // ws, ws)
        bias = (bias + torch.from_numpy(mask).to(cuda)).contiguous()
    before = ops.launch_counts()["window_attention_nhwc_bwd"]
    dqkv, dbias = ops.window_attention_nhwc_bwd(qkv, bias, g, 0.125, heads)
    torch.cuda.synchronize()
    assert ops.launch_counts()["window_attention_nhwc_bwd"] == before + 1
    want_q, want_b = ops.window_attention_nhwc_bwd_plain(qkv, bias, g, 0.125, heads)
    assert dbias.shape == (nB, 256, 256)
    assert torch.isfinite(dqkv).all() and torch.isfinite(dbias).all()
    assert _rel_err(dqkv, want_q) <= TOL
    assert _rel_err(dbias, want_b) <= TOL


def test_window_attention_bwd_rejects_a_partly_shared_bias(cuda):
    qkv = _randn((1, 32, 32, 3 * 128), 1, cuda)
    g = _randn((1, 32, 32, 128), 2, cuda)
    with pytest.raises(ValueError, match="bias rows"):
        ops.window_attention_nhwc_bwd(qkv, _randn((2, 256, 256), 3, cuda), g,
                                      0.125, 2)


def test_attention_gradients_on_the_card(cuda):
    """A grad-requiring CUDA input comes out of kernels 1 and 2 with a
    grad_fn, and its gradients (to qkv, and to the bias of window
    attention) equal the plain versions' within 1e-4."""
    from sic_tpu_torch.models.swin import _full_shift_mask
    qkv = _randn((2, 289, 3 * 1024), 11, cuda).requires_grad_(True)
    g = _randn((2, 289, 1024), 12, cuda)
    out = ops.seq_attention(qkv, 0.125, 16)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, qkv, g)
    ref = ops.seq_attention_plain(qkv, 0.125, 16)
    (want,) = torch.autograd.grad(ref, qkv, g)
    assert _rel_err(got, want) <= TOL

    qkv = _randn((1, 32, 32, 3 * 768), 13, cuda).requires_grad_(True)
    rel = _randn((1, 256, 256), 14, cuda).requires_grad_(True)
    mask = torch.from_numpy(_full_shift_mask(2, 2, 16)).to(cuda)
    g = _randn((1, 32, 32, 768), 15, cuda)
    before = ops.launch_counts()
    out = ops.window_attention_nhwc(qkv, (rel + mask).contiguous(), 0.125, 12)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (qkv, rel), g)
    after = ops.launch_counts()
    assert after["window_attention_nhwc"] == before["window_attention_nhwc"] + 1
    assert after["window_attention_nhwc_bwd"] == before["window_attention_nhwc_bwd"] + 1
    ref = ops.window_attention_nhwc_plain(qkv, rel + mask, 0.125, 12)
    want = torch.autograd.grad(ref, (qkv, rel), g)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= TOL


def test_rans_kernel_matches_native_and_plain(cuda):
    t = build_gaussian_tables("gaussian")
    rng = np.random.default_rng(5)
    n, nparts = 4096, 4
    planes = []
    for _ in range(4):
        idx = rng.integers(0, t.levels, n).astype(np.int16)
        idx[rng.random(n) < 0.2] = -1
        sym = rng.integers(-6, 7, n).astype(np.int16)
        esc = rng.random(n) < 0.1
        sym[esc] = rng.integers(-4000, 4000, int(esc.sum())).astype(np.int16)
        sym[idx < 0] = 0
        planes.append((sym, idx))
    coder = EntropyCoder(nparts)
    g = coder.add_cdf(t.quantized_cdf, t.cdf_length, t.offset)
    coder.reset()
    for sym, idx in planes:
        coder.encode_with_indexes(sym, idx, g)
    coder.flush()
    stream = coder.get_encoded_stream()
    coder.set_stream(stream)
    host = [coder.decode_stream(idx, g) for _, idx in planes]

    words, lens, state = ops.pack_substreams(ops.split_substreams(stream))
    npos = n // nparts
    args = [words_tensor(words, cuda), torch.from_numpy(lens.reshape(-1)).to(cuda)]
    tables = [torch.from_numpy(a.astype(np.int32)).to(cuda)
              for a in (t.quantized_cdf, t.cdf_length, t.offset)]
    st_k = st_p = torch.from_numpy(state).to(cuda)
    for (_sym, idx), want in zip(planes, host):
        rows = torch.from_numpy(idx.astype(np.int32).reshape(nparts, npos)).to(cuda)
        got, st_k = ops.rans_decode_plane(rows, *args, st_k, *tables)
        ref, st_p = ops.rans_decode_plane_plain(rows, *args, st_p, *tables)
        np.testing.assert_array_equal(got.reshape(-1).cpu().numpy(),
                                      want.astype(np.int32))
        assert torch.equal(got, ref)
        assert torch.equal(st_k, st_p)
    # a fully decoded substream ends in its encoder's initial state
    final = st_k.cpu().numpy()
    assert (final[:, 0] == 1 << 23).all()
    assert (final[:, 1] == lens[:, 0]).all()


def test_golden_stream_on_the_card(cuda):
    """The JAX-encoded golden stream, decoded on the card through the rANS
    kernel, meets the JAX package's golden bound."""
    from sic_tpu_torch.cli._common import load_runtime
    from sic_tpu_torch.config import tiny_spec
    from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
    rt = load_runtime(str(GOLDEN / "params.npz"), tiny_spec(), device="cuda")
    rt.device_entropy = "device"
    enc, header = unpack_c2df(GOLDEN / "golden.c2df")
    enc = sanitize_enc_result_types(enc)
    probe = {}
    before = ops.launch_counts()["rans_decode_plane"]
    x = rt.decode_only(**enc, z_coder=header["z_coder"],
                       coding_batch=header["coding_batch"], output="u8",
                       probe=probe)
    rt.close()
    assert probe["h_path"] == "device"
    assert ops.launch_counts()["rans_decode_plane"] == before + 4
    diff = np.abs(x[0].cpu().numpy().astype(np.int32)
                  - np.load(GOLDEN / "expected_u8.npz")["u8"].astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-3


def _encode_planes(rng, t, B, n, escape_rate=0.1):
    planes = []
    for _ in range(4):
        idx = rng.integers(0, t.levels, (B, n)).astype(np.int16)
        idx[rng.random((B, n)) < 0.2] = -1
        sym = rng.integers(-6, 7, (B, n)).astype(np.int16)
        esc = rng.random((B, n)) < escape_rate
        sym[esc] = rng.integers(-30000, 30001, int(esc.sum())).astype(np.int16)
        sym[idx < 0] = 0
        planes.append((sym, idx))
    return planes


@pytest.mark.parametrize("B,nparts,npos", [(1, 4, 1024), (8, 4, 256), (3, 8, 100)])
def test_rans_encode_kernel_matches_native_and_plain(cuda, B, nparts, npos):
    """Four planes last to first, skips and escapes up to the int16 clamp:
    the kernel's bytes equal the native encoder's and the plain version's,
    and so do the final states."""
    from sic_tpu_torch.models.bottleneck import worst_case_bytes
    from sic_tpu_torch.ops import rans_encode as renc
    t = build_gaussian_tables("gaussian")
    n = nparts * npos
    planes = _encode_planes(np.random.default_rng(B * npos), t, B, n)
    want = []
    for b in range(B):
        coder = EntropyCoder(nparts)
        g = coder.add_cdf(t.quantized_cdf, t.cdf_length, t.offset)
        coder.reset()
        for sym, idx in planes:
            coder.encode_with_indexes(sym[b], idx[b], g)
        coder.flush()
        want.append(coder.get_encoded_stream())
    tables = [torch.from_numpy(a.astype(np.int32)).to(cuda)
              for a in (t.quantized_cdf, t.cdf_length, t.offset)]
    S = B * nparts
    nwords = -(-worst_case_bytes(4 * npos) // 4)
    out = {}
    for name, fn in (("kernel", ops.rans_encode_plane),
                     ("plain", ops.rans_encode_plane_plain)):
        words = torch.zeros((S, nwords), dtype=torch.int32, device=cuda)
        st = renc.initial_state(S, cuda)
        for sym, idx in reversed(planes):
            rows = [torch.from_numpy(a.astype(np.int32).reshape(S, npos)).to(cuda)
                    for a in (sym, idx)]
            words, st = fn(*rows, words, st, *tables)
        out[name] = (words.cpu().numpy(), st.cpu().numpy())
    np.testing.assert_array_equal(out["kernel"][1], out["plain"][1])
    parts = renc.finalize_streams(*out["kernel"], S)
    assert parts == renc.finalize_streams(*out["plain"], S)
    got = [renc.frame_substreams(parts[b * nparts:(b + 1) * nparts])
           for b in range(B)]
    assert got == want


def test_device_encode_doubles_and_matches_host_on_the_card(cuda, monkeypatch):
    """The bottleneck's device encode from a buffer of 4 words a substream: it
    doubles on the card until the streams fit and then equals the host
    coder's bytes; each attempt launches the kernel once a plane."""
    from sic_tpu_torch.models import bottleneck
    from sic_tpu_torch.models.bottleneck import (BottleneckCoder,
                                                 CompressiveBottleneck)
    from sic_tpu_torch.weights import init_seeded
    monkeypatch.setattr(bottleneck, "encode_buffer_words", lambda npos: 4)
    with torch.device(cuda):
        m = CompressiveBottleneck(64, 16)
    init_seeded(m, 0)
    coder = BottleneckCoder(m.eval().requires_grad_(False), stream_part=4)
    y = _randn((3, 8, 8, 64), 2, cuda)
    packed, y_hat = coder.compress_plan(y)
    host = coder.encode_packed_many(packed)
    before = ops.launch_counts()["rans_encode_plane"]
    streams, y_hat_dev = coder.compress_device(y)
    launches = ops.launch_counts()["rans_encode_plane"] - before
    assert streams == host
    assert torch.equal(y_hat_dev, y_hat)
    assert launches > 4 and launches % 4 == 0


def test_golden_input_encodes_on_the_card(cuda):
    """golden_input() under the golden params on the card: the kernel's
    stream equals the host coder's and decodes back to the encoder's
    y_hat.  Whether it equals golden.c2df is not asserted (a float flip
    across frameworks is the known limit); the CPU test asserts that."""
    import sys
    from sic_tpu_torch.cli._common import load_runtime
    from sic_tpu_torch.config import tiny_spec
    sys.path.insert(0, str(GOLDEN.parents[1]))
    from fixtures.golden.generate import golden_input
    rt = load_runtime(str(GOLDEN / "params.npz"), tiny_spec(), device="cuda",
                      stream_part=1)
    encs, probes = {}, {}
    for path in ("host", "device"):
        rt.device_entropy = path
        probes[path] = {}
        encs[path] = rt.encode_only(golden_input()[None], probe=probes[path])
    assert encs["host"]["h_bit_stream"] == encs["device"]["h_bit_stream"]
    assert encs["host"]["z_bit_stream"] == encs["device"]["z_bit_stream"]
    out = {}
    rt.decode_only(**encs["device"], coding_batch=8, probe=out)
    rt.close()
    assert torch.equal(out["h_hat"], probes["device"]["y_hat"])
