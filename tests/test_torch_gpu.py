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


def _seq_attention_f64(qkv, scale, heads):
    B, S, c3 = qkv.shape
    C = c3 // 3
    q, k, v = (t.reshape(B, S, heads, C // heads).transpose(1, 2).double()
               for t in qkv.split(C, dim=-1))
    p = (q * scale @ k.transpose(-1, -2)).softmax(-1)
    return (p @ v).transpose(1, 2).reshape(B, S, C)


def _window_attention_f64(qkv, bias, scale, heads, ws=16):
    B, H, W, c3 = qkv.shape
    C = c3 // 3
    nwh, nww, d = H // ws, W // ws, C // heads
    t = qkv.double().reshape(B, nwh, ws, nww, ws, 3, heads, d).permute(
        5, 0, 6, 1, 3, 2, 4, 7).reshape(3, B, heads, nwh * nww, ws * ws, d)
    win = torch.arange(nwh * nww, device=bias.device) % bias.shape[0]
    p = (t[0] * scale @ t[1].transpose(-1, -2) + bias.double()[win]).softmax(-1)
    o = (p @ t[2]).reshape(B, heads, nwh, nww, ws, ws, d)
    return o.permute(0, 2, 4, 3, 5, 1, 6).reshape(B, H, W, C)


def _window_bwd_f64(qkv, bias, g, scale, heads):
    """Kernel 5's function in f64: the VJP of :func:`_window_attention_f64`."""
    a = qkv.double().requires_grad_(True)
    b = bias.double().requires_grad_(True)
    out = _window_attention_f64(a, b, scale, heads)
    return torch.autograd.grad(out, (a, b), g.double())


def _gsd_f64(q, k, v, bias, scale):
    """Kernel 6's function in f64."""
    G, s, _ = q.shape
    nW = bias.shape[0]
    dots = (q.double() * scale) @ k.double().transpose(-1, -2)
    dots = (dots.reshape(G // nW, nW, s, s) + bias.double()).reshape(G, s, s)
    return dots.softmax(-1) @ v.double()


# At qkv x 4 the logits are in the tens, and the plain f32 version itself
# errs by about 1e-4 against f64 on the card (its cuBLAS products): the
# kernels are held to the f64 function there, within the same TOL.
@pytest.mark.parametrize("magnitude", [1.0, 4.0])
@pytest.mark.parametrize("B,S,C,heads", [(4, 289, 1024, 16), (4, 545, 768, 12),
                                         (3, 100, 128, 2), (2, 1, 128, 2),
                                         (3, 17, 128, 2), (2, 50, 768, 12),
                                         (2, 63, 128, 2), (3, 65, 128, 2)])
def test_seq_attention_kernel_matches_plain(cuda, B, S, C, heads, magnitude):
    """Ragged S (a tile past a sequence's end reads zeros, never the next
    sequence's rows: B > 1 everywhere) and qkv x 4 (logits in the tens,
    where a single TF32 pass would err by about 0.05).  Two launches on
    the same input give the same bits."""
    qkv = _randn((B, S, 3 * C), S, cuda) * magnitude
    before = ops.launch_counts()["seq_attention"]
    out = ops.seq_attention(qkv, 0.125, heads)
    assert ops.launch_counts()["seq_attention"] == before + 1
    assert torch.isfinite(out).all()
    if magnitude == 1.0:
        torch.testing.assert_close(out, ops.seq_attention_plain(qkv, 0.125, heads),
                                   rtol=TOL, atol=TOL)
    else:
        torch.testing.assert_close(out.double(), _seq_attention_f64(qkv, 0.125, heads),
                                   rtol=TOL, atol=TOL)
    assert torch.equal(out, ops.seq_attention(qkv, 0.125, heads))


@pytest.mark.parametrize("magnitude", [1.0, 4.0])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("C,heads", [(768, 12), (1024, 16)])
def test_window_attention_kernel_matches_plain(cuda, shifted, C, heads, magnitude):
    """2x3 windows: a shared bias (nB = 1), or bias plus shift masks per
    window (nB = nW), where some query rows see -inf key tiles; qkv x 4
    puts the logits in the tens.  Two launches give the same bits."""
    from sic_tpu_torch.models.swin import _full_shift_mask
    qkv = _randn((2, 32, 48, 3 * C), C, cuda) * magnitude
    bias = _randn((1, 256, 256), 1, cuda)
    if shifted:
        bias = (bias + torch.from_numpy(_full_shift_mask(2, 3, 16)).to(cuda)).contiguous()
    out = ops.window_attention_nhwc(qkv, bias, 0.125, heads)
    assert torch.isfinite(out).all()
    if magnitude == 1.0:
        torch.testing.assert_close(
            out, ops.window_attention_nhwc_plain(qkv, bias, 0.125, heads),
            rtol=TOL, atol=TOL)
    else:
        torch.testing.assert_close(
            out.double(), _window_attention_f64(qkv, bias, 0.125, heads),
            rtol=TOL, atol=TOL)
    assert torch.equal(out, ops.window_attention_nhwc(qkv, bias, 0.125, heads))


def test_attention_kernels_refuse_what_they_cannot_take(cuda):
    """Head dim other than 64, a qkv or bias off a 16-byte boundary (the
    tensor maps' base), a window side the 64-token tiles do not fit: each
    raises, and nothing launches."""
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="head dim"):
        ops.seq_attention(_randn((2, 40, 3 * 128), 1, cuda), 0.125, 4)
    off = torch.empty(2 * 40 * 3 * 128 + 1, device=cuda)[1:].view(2, 40, 3 * 128)
    with pytest.raises(ValueError, match="16-byte"):
        ops.seq_attention(off, 0.125, 2)
    qkv = _randn((1, 16, 16, 3 * 128), 2, cuda)
    with pytest.raises(ValueError, match="window"):
        ops.window_attention_nhwc(qkv, _randn((1, 16, 16), 3, cuda), 0.125, 2)
    bias = torch.empty(256 * 256 + 1, device=cuda)[1:].view(1, 256, 256)
    with pytest.raises(ValueError, match="16-byte"):
        ops.window_attention_nhwc(qkv, bias, 0.125, 2)
    after = ops.launch_counts()
    assert after["seq_attention"] == before["seq_attention"]
    assert after["window_attention_nhwc"] == before["window_attention_nhwc"]


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
    masks' -inf entries.  Two launches give the same bits."""
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
    again = ops.window_attention_nhwc_bwd(qkv, bias, g, 0.125, heads)
    assert torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1])


def test_window_attention_bwd_kernel_at_magnitude_4(cuda):
    """qkv x 4 (logits in the tens) on a shifted 512-px layer (2x2
    windows, nB 4): dqkv and dbias against the f64 VJP, within the same
    TOL of their largest magnitude, as the forwards' x4 cases are held."""
    from sic_tpu_torch.models.swin import _full_shift_mask
    qkv = _randn((1, 32, 32, 3 * 768), 41, cuda) * 4
    g = _randn((1, 32, 32, 768), 42, cuda)
    bias = (_randn((1, 256, 256), 43, cuda)
            + torch.from_numpy(_full_shift_mask(2, 2, 16)).to(cuda)).contiguous()
    dqkv, dbias = ops.window_attention_nhwc_bwd(qkv, bias, g, 0.125, 12)
    assert torch.isfinite(dqkv).all() and torch.isfinite(dbias).all()
    want_q, want_b = _window_bwd_f64(qkv, bias, g, 0.125, 12)
    assert _rel_err(dqkv.double(), want_q) <= TOL
    assert _rel_err(dbias.double(), want_b) <= TOL


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


@pytest.mark.parametrize("G,nW,masked", [(32, 2, False), (48, 4, True),
                                          (8, 1, False)])
def test_gsd_window_attention_kernel_matches_plain(cuda, G, nW, masked):
    """The (G, s, d) kernel at s 256, d 64: forward and the autograd
    gradient (q, k, v, bias) against the plain version's; with the -inf
    masks of a shifted 2x2-window layer some query rows see -inf key
    tiles.  Two launches give the same bits."""
    from sic_tpu_torch.models.swin import _full_shift_mask
    q, k, v = (_randn((G, 256, 64), G + i, cuda).requires_grad_(True)
               for i in range(3))
    bias = _randn((nW, 256, 256), 7, cuda)
    if masked:
        bias = bias + torch.from_numpy(_full_shift_mask(2, 2, 16)).to(cuda)
    bias = bias.contiguous().requires_grad_(True)
    g = _randn((G, 256, 64), 9, cuda)
    before = ops.launch_counts()["window_attention"]
    out = ops.window_attention(q, k, v, bias, 0.125)
    assert ops.launch_counts()["window_attention"] == before + 1
    assert torch.isfinite(out).all() and out.grad_fn is not None
    ref = ops.window_attention_plain(q, k, v, bias, 0.125)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    assert torch.equal(out, ops.window_attention(q, k, v, bias, 0.125))
    got = torch.autograd.grad(out, (q, k, v, bias), g)
    want = torch.autograd.grad(ref, (q, k, v, bias), g)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= TOL


@pytest.mark.parametrize("G,nW,s", [(8, 2, 49), (8, 2, 64), (6, 3, 289)])
def test_gsd_window_attention_kernel_other_window_sizes(cuda, G, nW, s):
    """s 49 (a 7x7 window: the bias padded to 52 columns for its tensor
    map), 64 (one warpgroup a block) and 289 (ragged: the last tile's rows
    past s read zeros and its keys are masked): forward and gradient
    against the plain version, two launches equal bits."""
    q, k, v = (_randn((G, s, 64), s + i, cuda).requires_grad_(True)
               for i in range(3))
    bias = _randn((nW, s, s), 5, cuda).requires_grad_(True)
    g = _randn((G, s, 64), 6, cuda)
    out = ops.window_attention(q, k, v, bias, 0.125)
    assert torch.isfinite(out).all()
    ref = ops.window_attention_plain(q, k, v, bias, 0.125)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    assert torch.equal(out, ops.window_attention(q, k, v, bias, 0.125))
    got = torch.autograd.grad(out, (q, k, v, bias), g)
    want = torch.autograd.grad(ref, (q, k, v, bias), g)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= TOL


def test_gsd_window_attention_kernel_at_magnitude_4(cuda):
    """q, k, v x 4 (logits in the tens) on the flagship layer's geometry
    with the shift masks: held to the f64 function within TOL, as kernels
    1 and 2 are at x4."""
    from sic_tpu_torch.models.swin import _full_shift_mask
    q, k, v = (_randn((48, 256, 64), 60 + i, cuda) * 4 for i in range(3))
    bias = (_randn((4, 256, 256), 63, cuda)
            + torch.from_numpy(_full_shift_mask(2, 2, 16)).to(cuda)).contiguous()
    out = ops.window_attention(q, k, v, bias, 0.125)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.double(), _gsd_f64(q, k, v, bias, 0.125),
                               rtol=TOL, atol=TOL)
    assert torch.equal(out, ops.window_attention(q, k, v, bias, 0.125))


def test_gsd_window_attention_refuses_what_the_kernel_cannot_take(cuda):
    q = _randn((8, 256, 32), 1, cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.window_attention(q, q, q, _randn((2, 256, 256), 2, cuda), 0.125)
    q = _randn((8, 256, 64), 3, cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.window_attention(q.half(), q.half(), q.half(),
                             _randn((2, 256, 256), 4, cuda), 0.125)
    before = ops.launch_counts()["window_attention"]
    off = torch.empty(8 * 256 * 64 + 1, device=cuda)[1:].view(8, 256, 64)
    with pytest.raises(ValueError, match="16-byte"):
        ops.window_attention(off, q, q, _randn((2, 256, 256), 5, cuda), 0.125)
    assert ops.launch_counts()["window_attention"] == before


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


def _skip_runs(rng, shape, p_start=0.01, max_run=300):
    """A skip mask with long runs: a run of up to ``max_run`` skipped
    positions starts at about 1% of the positions."""
    skip = np.zeros(shape, dtype=bool)
    for s_, i in zip(*np.nonzero(rng.random(shape) < p_start)):
        skip[s_, i:i + rng.integers(1, max_run + 1)] = True
    return skip


def _decode_check(cuda, planes, table, B, nparts):
    """Four planes of B images x ``nparts`` substreams, written by the
    native encoder with ``table`` (cdf, sizes, offsets as numpy arrays) and
    decoded by the kernel with its state carried across them: the symbols
    equal the native decoder's and, with the states, the plain version's,
    and every substream ends in its encoder's initial state."""
    S, npos = planes[0][1].shape
    parts, host = [], [[] for _ in planes]
    for b in range(B):
        rows = slice(b * nparts, (b + 1) * nparts)
        coder = EntropyCoder(nparts)
        g = coder.add_cdf(*table)
        coder.reset()
        for sym, idx in planes:
            coder.encode_with_indexes(sym[rows].reshape(-1), idx[rows].reshape(-1), g)
        coder.flush()
        stream = coder.get_encoded_stream()
        parts += ops.split_substreams(stream)
        coder.set_stream(stream)
        for p, (_sym, idx) in enumerate(planes):
            host[p].append(coder.decode_stream(idx[rows].reshape(-1), g))
    words, lens, state = ops.pack_substreams(parts)
    args = [words_tensor(words, cuda), torch.from_numpy(lens.reshape(-1)).to(cuda)]
    tables = [torch.from_numpy(a.astype(np.int32)).to(cuda) for a in table]
    st_k = st_p = torch.from_numpy(state).to(cuda)
    for (_sym, idx), want in zip(planes, host):
        rows = torch.from_numpy(idx.astype(np.int32)).to(cuda)
        got, st_k = ops.rans_decode_plane(rows, *args, st_k, *tables)
        ref, st_p = ops.rans_decode_plane_plain(rows, *args, st_p, *tables)
        np.testing.assert_array_equal(
            got.cpu().numpy(), np.concatenate(want).reshape(S, npos).astype(np.int32))
        assert torch.equal(got, ref)
        assert torch.equal(st_k, st_p)
    final = st_k.cpu().numpy()
    assert (final[:, 0] == 1 << 23).all()
    assert (final[:, 1] == lens[:, 0]).all()


def _gaussian_table():
    t = build_gaussian_tables("gaussian")
    return t, (t.quantized_cdf, t.cdf_length, t.offset)


def _symbols(rng, idx, escape_rate=0.05):
    """Symbols near 0, escapes up to the int16 clamp, 0 where skipped."""
    sym = rng.integers(-6, 7, idx.shape).astype(np.int16)
    esc = rng.random(idx.shape) < escape_rate
    sym[esc] = rng.integers(-30000, 30001, int(esc.sum())).astype(np.int16)
    sym[idx < 0] = 0
    return sym


@pytest.mark.parametrize("B,nparts,npos", [(1, 1, 4096), (2, 4, 512), (8, 4, 256)])
def test_rans_kernel_at_request_shapes(cuda, B, nparts, npos):
    """One substream of 4096 positions (a 512x512 stream as the JAX
    CodecRuntime writes it), 8 x 512 and 32 x 256, with escapes up to the
    int16 clamp and long runs of skipped positions: the kernel's symbols
    equal the native decoder's and, with the final states, the plain
    version's."""
    t, table = _gaussian_table()
    rng = np.random.default_rng(B * nparts * npos)
    S = B * nparts
    planes = []
    for _ in range(4):
        idx = rng.integers(0, t.levels, (S, npos)).astype(np.int16)
        idx[_skip_runs(rng, (S, npos)) | (rng.random((S, npos)) < 0.1)] = -1
        planes.append((_symbols(rng, idx), idx))
    _decode_check(cuda, planes, table, B, nparts)


def _first_windows(name, skip):
    """Sets the live positions of each row's first windows of 32 (the
    kernel reads its indexes a window at a time into a list of live
    positions) in the skip mask ``skip`` (S, npos)."""
    live = {"two_then_a_gap": ([0, 1], 64),          # 2..63 skipped
            "one_in_each_of_two": ([5, 40], 64),
            "two_after_empty_windows": ([100, 101], 160),
            "two_in_the_row": ([31, 32], None),       # all else skipped
            "one_in_the_row": ([300], None)}[name]
    cols, upto = live
    skip[:, :upto] = True
    skip[:, cols] = False


@pytest.mark.parametrize("name", ["two_then_a_gap", "one_in_each_of_two",
                                  "two_after_empty_windows", "two_in_the_row",
                                  "one_in_the_row"])
def test_rans_kernel_with_few_live_positions_in_the_first_windows(cuda, name):
    """Rows whose first windows hold one or two live positions, in every
    plane (each launch starts its list there): every position is decoded,
    as the native decoder and the plain version decode it."""
    t, table = _gaussian_table()
    rng = np.random.default_rng(len(name))
    S, npos = 8, 512
    planes = []
    for _ in range(4):
        idx = rng.integers(0, t.levels, (S, npos)).astype(np.int16)
        skip = rng.random((S, npos)) < 0.1
        _first_windows(name, skip)
        idx[skip] = -1
        planes.append((_symbols(rng, idx), idx))
    _decode_check(cuda, planes, table, 2, 4)


@pytest.mark.parametrize("width", [103, 8])
def test_rans_kernels_take_a_table_of_four_rows(cuda, width):
    """The gaussian table's first 4 rows (7 entries each), at its width and
    cut to 8 columns: the decode's lanes past the last row stay inside the
    block's shared memory, and both kernels equal the native coder and
    their plain versions."""
    from sic_tpu_torch.models.bottleneck import worst_case_bytes
    from sic_tpu_torch.ops import rans_encode as renc
    t = build_gaussian_tables("gaussian")
    table = (np.ascontiguousarray(t.quantized_cdf[:4, :width]),
             t.cdf_length[:4], t.offset[:4])
    rng = np.random.default_rng(width)
    S, npos = 4, 300
    planes = []
    for _ in range(4):
        idx = rng.integers(0, 4, (S, npos)).astype(np.int16)
        idx[rng.random((S, npos)) < 0.2] = -1
        planes.append((_symbols(rng, idx), idx))
    _decode_check(cuda, planes, table, 1, 4)

    coder = EntropyCoder(S)
    g = coder.add_cdf(*table)
    coder.reset()
    for sym, idx in planes:
        coder.encode_with_indexes(sym.reshape(-1), idx.reshape(-1), g)
    coder.flush()
    tables = [torch.from_numpy(a.astype(np.int32)).to(cuda) for a in table]
    nwords = -(-worst_case_bytes(4 * npos) // 4)
    out = {}
    for name, fn in (("kernel", ops.rans_encode_plane),
                     ("plain", ops.rans_encode_plane_plain)):
        words = torch.zeros((S, nwords), dtype=torch.int32, device=cuda)
        st = renc.initial_state(S, cuda)
        for sym, idx in reversed(planes):
            rows = [torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (sym, idx)]
            words, st = fn(*rows, words, st, *tables)
        out[name] = (words.cpu().numpy(), st.cpu().numpy())
    np.testing.assert_array_equal(out["kernel"][1], out["plain"][1])
    parts = renc.finalize_streams(*out["kernel"], S)
    assert parts == renc.finalize_streams(*out["plain"], S)
    assert renc.frame_substreams(parts) == coder.get_encoded_stream()


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


@pytest.mark.parametrize("cap_words", [13, 100, 250])
def test_rans_encode_kernel_overflow_matches_plain(cuda, cap_words):
    """An emission buffer that fills in the middle of a plane (and of the
    kernel's chunk of 64 positions): the kernel stops where the plain
    version stops, with the same bytes, state and overflow flag, in the
    plane where the row fills and in the planes after it."""
    from sic_tpu_torch.ops import rans_encode as renc
    t = build_gaussian_tables("gaussian")
    S, npos = 6, 700
    planes = _encode_planes(np.random.default_rng(cap_words), t, S, npos,
                            escape_rate=0.05)
    tables = [torch.from_numpy(a.astype(np.int32)).to(cuda)
              for a in (t.quantized_cdf, t.cdf_length, t.offset)]
    out = {}
    for name, fn in (("kernel", ops.rans_encode_plane),
                     ("plain", ops.rans_encode_plane_plain)):
        words = torch.zeros((S, cap_words), dtype=torch.int32, device=cuda)
        st = renc.initial_state(S, cuda)
        for sym, idx in reversed(planes):
            rows = [torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (sym, idx)]
            words, st = fn(*rows, words, st, *tables)
        out[name] = (words.cpu().numpy(), st.cpu().numpy())
    k_words, k_st = out["kernel"]
    p_words, p_st = out["plain"]
    np.testing.assert_array_equal(k_st, p_st)
    np.testing.assert_array_equal(k_words, p_words)
    full = k_st[:, 2] == 1
    assert full.any() and (k_st[full, 1] == 4 * cap_words).all()


@pytest.mark.parametrize("x0", [0, 77, (1 << 23) - 1])
def test_rans_encode_kernel_from_a_state_below_l(cuda, x0):
    """A state no stream reaches (x < L) takes the kernel's emit loop and
    exact shift until x enters [L, 2^31): bytes and states still equal the
    plain version's."""
    from sic_tpu_torch.ops import rans_encode as renc
    t = build_gaussian_tables("gaussian")
    S, npos = 4, 300
    planes = _encode_planes(np.random.default_rng(x0), t, S, npos, escape_rate=0.05)
    tables = [torch.from_numpy(a.astype(np.int32)).to(cuda)
              for a in (t.quantized_cdf, t.cdf_length, t.offset)]
    out = {}
    for name, fn in (("kernel", ops.rans_encode_plane),
                     ("plain", ops.rans_encode_plane_plain)):
        words = torch.zeros((S, 1024), dtype=torch.int32, device=cuda)
        st = renc.initial_state(S, cuda)
        st[:, 0] = x0
        for sym, idx in reversed(planes):
            rows = [torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (sym, idx)]
            words, st = fn(*rows, words, st, *tables)
        out[name] = (words.cpu().numpy(), st.cpu().numpy())
    np.testing.assert_array_equal(out["kernel"][1], out["plain"][1])
    np.testing.assert_array_equal(out["kernel"][0], out["plain"][0])


def test_rans_kernels_refuse_a_table_they_cannot_take(cuda):
    """A row that is not a quantized CDF raises before any launch."""
    t = build_gaussian_tables("gaussian")
    cdf, sizes, offs = (torch.from_numpy(a.astype(np.int32)).to(cuda)
                        for a in (t.quantized_cdf, t.cdf_length, t.offset))
    cdf[3, 4] = cdf[3, 3]
    before = ops.launch_counts()
    idx = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    words = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="quantized CDF"):
        ops.rans_decode_plane(idx, words, torch.full((4,), 32, dtype=torch.int32,
                                                     device=cuda),
                              torch.zeros((4, 2), dtype=torch.int64, device=cuda),
                              cdf, sizes, offs)
    with pytest.raises(ValueError, match="quantized CDF"):
        ops.rans_encode_plane(idx, idx, words,
                              torch.zeros((4, 4), dtype=torch.int64, device=cuda),
                              cdf, sizes, offs)
    assert ops.launch_counts() == before


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


def _tiny_runtime(**kw):
    from sic_tpu_torch.cli._common import load_runtime
    from sic_tpu_torch.config import tiny_spec
    return load_runtime(str(GOLDEN / "params.npz"), tiny_spec(), device="cuda",
                        stream_part=4, **kw)


def test_concurrent_entry_points_on_the_card(cuda):
    """decode_only_many (four workers; kernel 3 decodes every stream),
    round_trip_pipelined and encode_decode_many on the card, each equal to
    its serial counterpart bit for bit."""
    from sic_tpu_torch.data import load_image
    heldout = GOLDEN.parents[2] / "artifacts_r05" / "heldout"
    imgs = [load_image(heldout / f"val{i}.png")[None] for i in range(4)]
    rt = _tiny_runtime()
    try:
        encs = [rt.encode_only(x) for x in imgs]
        serial = [rt.decode_only(**e) for e in encs]
        before = ops.launch_counts()["rans_decode_plane"]
        many = rt.decode_only_many(encs, workers=4)
        assert ops.launch_counts()["rans_decode_plane"] == before + 4 * len(encs)
        assert all(torch.equal(a, b) for a, b in zip(many, serial))
        batches = [np.concatenate(imgs[:2]), np.concatenate(imgs[2:])]
        piped = rt.round_trip_pipelined(batches)
        for b, out in zip(batches, piped):
            assert torch.equal(out, rt.decode_only_batched(rt.encode_only_batched(b)))
        for x, (x_hat, bpp, enc) in zip(imgs, rt.encode_decode_many(imgs)):
            x_ref, bpp_ref, enc_ref = rt.encode_decode(x, x.shape[1:3])
            assert torch.equal(x_hat, x_ref) and bpp == bpp_ref
            assert enc["h_bit_stream"] == enc_ref["h_bit_stream"]
    finally:
        rt.close()


def test_reference_format_files_on_the_card(cuda, tmp_path):
    """A torchac z stream (the reference's format), packed with and
    without z_coder, decodes through the decompress CLI to the PNG bytes
    of the rans-format file of the same image, alone and batched."""
    import sys
    from sic_tpu_torch.cli.decompress import decompress_dir
    from sic_tpu_torch.container import pack_c2df
    from sic_tpu_torch.models import CodecRuntime
    sys.path.insert(0, str(GOLDEN.parents[1]))
    from fixtures.golden.generate import golden_input
    rt = _tiny_runtime()
    trt = CodecRuntime(rt.spec, rt.model, stream_part=4, z_format="torchac")
    header = {"version": 2, "image_hw": [256, 256], "padding": [0, 0, 0, 0],
              "coding_batch": 8}
    try:
        x = golden_input()[None]
        files = {"rans": pack_c2df(rt.encode_only(x), dict(header, z_coder="rans")),
                 "torchac": pack_c2df(trt.encode_only(x),
                                      dict(header, z_coder="torchac")),
                 "reference": pack_c2df(trt.encode_only(x), header)}
        pngs = {}
        for batch_size in (1, 8):
            for name, data in files.items():
                d = tmp_path / f"{name}_{batch_size}"
                (d / "in").mkdir(parents=True)
                for i in range(2):
                    (d / "in" / f"f{i}.c2df").write_bytes(data)
                decompress_dir(rt, d / "in", d / "png", batch_size=batch_size)
                pngs[name, batch_size] = [(d / "png" / f"f{i}.png").read_bytes()
                                          for i in range(2)]
    finally:
        trt.close()
        rt.close()
    for batch_size in (1, 8):
        assert pngs["torchac", batch_size] == pngs["rans", batch_size]
        assert pngs["reference", batch_size] == pngs["rans", batch_size]


def test_base_config_clis_on_the_card(cuda, tmp_path):
    """configs/config_small_r4.yaml (seeded) through the compress and
    decompress CLIs on the card."""
    import shutil
    from sic_tpu_torch.cli.compress import main as compress_main
    from sic_tpu_torch.cli.decompress import main as decompress_main
    root = GOLDEN.parents[2]
    (tmp_path / "in").mkdir()
    shutil.copy(root / "artifacts_r05" / "heldout" / "val1.png", tmp_path / "in")
    common = ["--base_config", str(root / "configs" / "config_small_r4.yaml"),
              "--device", "cuda"]
    assert compress_main(["--dataset_dir", str(tmp_path / "in"), "--save_dir",
                          str(tmp_path / "c"), *common])["images"] == 1
    assert decompress_main(["--dataset_dir", str(tmp_path / "c" / "bitstreams"),
                            "--save_dir", str(tmp_path / "d"), *common]) == 1
    from PIL import Image
    assert np.asarray(Image.open(tmp_path / "d" / "val1.png")).shape == (256, 256, 3)
