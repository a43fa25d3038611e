"""The CUDA kernels of the PyTorch port, on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  The file imports no JAX, so on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Attention kernels agree with their plain versions within 1e-4 in fp32
(summation order only); their bf16 entries err against an f64 reference
no more than 1.5 times the plain bf16 version does; the rANS kernels agree
with the native coder and with their plain versions exactly; the GroupNorm
kernel agrees with its plain version within 1e-5 of the output's scale in
fp32, and within that plus one ulp in bf16; the full-width generators and
TiTok decoders agree with the CPU, or with the plain reference on the card,
within 1e-3 of their outputs' largest magnitude.  The runtime
tests that check fp32 behaviour ask for fp32 (the card's default is bf16).
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
                                         (2, 63, 128, 2), (3, 65, 128, 2),
                                         (16, 129, 1024, 16), (16, 385, 512, 8)])
def test_seq_attention_kernel_matches_plain(cuda, B, S, C, heads, magnitude):
    """Ragged S (a tile past a sequence's end reads zeros, never the next
    sequence's rows: B > 1 everywhere) and qkv x 4 (logits in the tens,
    where a single TF32 pass would err by about 0.05).  Two launches on
    the same input give the same bits.  The last two shapes are
    TiTok-S-128's generator (the U-ViT) and TiTok-S's decoder at the
    benchmark's batch of 16."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,C,heads", [(4, 33, 768, 16), (2, 33, 768, 16),
                                         (2, 9, 64, 2),
                                         (3, 65, 96, 2), (4, 100, 192, 4),
                                         (2, 289, 512, 16), (5, 130, 64, 2)])
def test_seq_attention_kernel_at_head_dims_32_and_48(cuda, B, S, C, heads, dtype):
    """Head dims 48 (MaskGIT at full width: (4, 33, 2304), 16 heads, as
    the generate phase samples four classes) and 32 (the tiny generator),
    in both entries: f32 within TOL of the plain
    version, bf16 within 1.5x the plain bf16 version's error against f64.
    S = 65 and 130 cross a 64-row tile inside a sequence, and B * S crosses
    64-row tiles everywhere; columns d..63 of a tile are TMA's zeros, and
    a row stores only its head's d columns (the next head's and the next
    sequence's values stay the kernel's own).  Two launches give the same
    bits; the launch is counted under its head dim."""
    qkv = _randn((B, S, 3 * C), C + S, cuda).to(dtype)
    d = C // heads
    scale = d ** -0.5
    before = ops.head_dim_launch_counts().get(d, 0)
    out = ops.seq_attention(qkv, scale, heads)
    assert ops.head_dim_launch_counts()[d] == before + 1
    assert out.dtype == dtype and torch.isfinite(out).all()
    plain = ops.seq_attention_plain(qkv, scale, heads)
    if dtype == torch.float32:
        torch.testing.assert_close(out, plain, rtol=TOL, atol=TOL)
    else:
        _bf16_within(out, plain, _seq_attention_f64(qkv, scale, heads))
    assert torch.equal(out, ops.seq_attention(qkv, scale, heads))


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
    """A head dim kernel 1 does not take (42: a row of 168 bytes, not a
    multiple of 16; 96: wider than its 64 columns), a qkv or bias off a
    16-byte boundary (the tensor maps' base), a window side the 64-token
    tiles do not fit: each raises, and nothing launches."""
    before = ops.launch_counts()
    for C, heads in ((84, 2), (192, 2)):
        with pytest.raises(ValueError, match="head dim"):
            ops.seq_attention(_randn((2, 40, 3 * C), 1, cuda), C ** -0.5, heads)
        with pytest.raises(ValueError, match="head dim"):
            ops.seq_attention(_randn((2, 40, 3 * C), 1, cuda).to(torch.bfloat16),
                              C ** -0.5, heads)
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
    rt = load_runtime(str(GOLDEN / "params.npz"), tiny_spec(), device="cuda",
                      dtype="float32")
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
                      stream_part=1, dtype="float32")
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
    kw.setdefault("dtype", "float32")
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
              "--device", "cuda", "--dtype", "float32"]
    assert compress_main(["--dataset_dir", str(tmp_path / "in"), "--save_dir",
                          str(tmp_path / "c"), *common])["images"] == 1
    assert decompress_main(["--dataset_dir", str(tmp_path / "c" / "bitstreams"),
                            "--save_dir", str(tmp_path / "d"), *common]) == 1
    from PIL import Image
    assert np.asarray(Image.open(tmp_path / "d" / "val1.png")).shape == (256, 256, 3)


# -- bf16 entries (the bf16 serving mode) -------------------------------------

# an entry's error against the f64 function, as a multiple of the plain
# bf16 version's error against the same reference
BF16_F64_RATIO = 1.5


def _bf16_within(out, plain, ref):
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    err = (out.double() - ref).abs().max().item()
    plain_err = (plain.double() - ref).abs().max().item()
    assert err <= BF16_F64_RATIO * plain_err, (err, plain_err)


def test_bf16_entries_compile_to_bf16_tensor_core_instructions(cuda):
    """Every kernel function of the three forward libraries holds HGMMA,
    and those of the bf16 entries hold bf16 HGMMA only (cuobjdump -sass).
    Each library has f32 functions at one and two warpgroups; the bf16
    entries run one warpgroup a block at every length (three or four
    blocks an SM), so each library holds three."""
    from sic_tpu_torch.ops import cuda_build
    names = {"seq_attention": 3, "window_attention": 3, "window_attention_gsd": 3}
    cuda_build.build(tuple(names))
    for name, n_fns in names.items():
        counts = cuda_build.sass_hgmma(name)
        assert len(counts) == n_fns, counts
        for fn, c in counts.items():
            assert c["hgmma"] > 0, (name, fn)
            if "bfloat16" in fn:
                assert c["bf16"] == c["hgmma"], (name, fn, c)
            else:
                assert c["bf16"] == 0, (name, fn, c)


@pytest.mark.parametrize("B,S,C,heads", [(4, 289, 1024, 16), (4, 545, 768, 12),
                                         (2, 50, 768, 12), (3, 17, 128, 2),
                                         (2, 1, 128, 2), (3, 65, 128, 2)])
def test_seq_attention_bf16_kernel(cuda, B, S, C, heads):
    qkv = _randn((B, S, 3 * C), S + 1, cuda).to(torch.bfloat16)
    before = ops.bf16_launch_counts()["seq_attention"]
    out = ops.seq_attention(qkv, 0.125, heads)
    assert ops.bf16_launch_counts()["seq_attention"] == before + 1
    _bf16_within(out, ops.seq_attention_plain(qkv, 0.125, heads),
                 _seq_attention_f64(qkv, 0.125, heads))
    assert torch.equal(out, ops.seq_attention(qkv, 0.125, heads))


@pytest.mark.parametrize("B,heads", [(1, 2), (12, 12)], ids=["few_blocks", "many_blocks"])
@pytest.mark.parametrize("d", [32, 48, 64])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 129, 289, 545])
def test_seq_attention_bf16_schedule(cuda, S, d, B, heads):
    """Kernel 1's bf16 body (a ring of full and empty mbarriers refilled by
    one thread, the softmax masking only a ragged last tile, 64-row blocks
    four an SM) at sequence lengths around its 64-row tiles, every head dim
    it takes, and grids of a few blocks and of more than four blocks an SM
    (12 x 12 heads at 545 tokens: 1,296 blocks): within 1.5x the plain
    bf16 version's error against f64, one launch counted, two calls
    bit-equal."""
    C = heads * d
    qkv = _randn((B, S, 3 * C), 7 * S + d, cuda).to(torch.bfloat16)
    scale = d ** -0.5
    before = ops.bf16_launch_counts()["seq_attention"]
    out = ops.seq_attention(qkv, scale, heads)
    torch.cuda.synchronize()
    assert ops.bf16_launch_counts()["seq_attention"] == before + 1
    _bf16_within(out, ops.seq_attention_plain(qkv, scale, heads),
                 _seq_attention_f64(qkv, scale, heads))
    assert torch.equal(out, ops.seq_attention(qkv, scale, heads))


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("C,heads", [(768, 12), (1024, 16)])
def test_window_attention_bf16_kernel(cuda, shifted, C, heads):
    from sic_tpu_torch.models.swin import _full_shift_mask
    qkv = _randn((2, 32, 48, 3 * C), C + 1, cuda).to(torch.bfloat16)
    bias = _randn((1, 256, 256), 2, cuda)
    if shifted:
        bias = (bias + torch.from_numpy(_full_shift_mask(2, 3, 16)).to(cuda)).contiguous()
    out = ops.window_attention_nhwc(qkv, bias, 0.125, heads)
    _bf16_within(out, ops.window_attention_nhwc_plain(qkv, bias, 0.125, heads),
                 _window_attention_f64(qkv, bias, 0.125, heads))
    assert torch.equal(out, ops.window_attention_nhwc(qkv, bias, 0.125, heads))


@pytest.mark.parametrize("G,nW,s,masked", [(32, 2, 256, False), (48, 4, 256, True),
                                           (12, 3, 49, False), (8, 2, 100, False)])
def test_gsd_window_attention_bf16_kernel(cuda, G, nW, s, masked):
    from sic_tpu_torch.models.swin import _full_shift_mask
    q, k, v = (_randn((G, s, 64), i, cuda).to(torch.bfloat16) for i in (3, 4, 5))
    bias = _randn((nW, s, s), 6, cuda)
    if masked:
        bias = (bias + torch.from_numpy(_full_shift_mask(2, 2, 16)).to(cuda)).contiguous()
    out = ops.window_attention(q, k, v, bias, 0.125)
    _bf16_within(out, ops.window_attention_plain(q, k, v, bias, 0.125),
                 _gsd_f64(q, k, v, bias, 0.125))
    assert torch.equal(out, ops.window_attention(q, k, v, bias, 0.125))


@pytest.mark.parametrize("B,H,W,C,heads,nB", [
    (2, 16, 16, 768, 12, 1),      # 256 px training, one window a map
    (2, 32, 32, 768, 12, 4),      # 512 px training, shifted
    (1, 16, 48, 128, 2, 3)])      # ragged: one row of three windows
def test_window_attention_bwd_bf16_kernel(cuda, B, H, W, C, heads, nB):
    """Kernel 5's bf16 entry: dqkv (bf16) no farther from the f64 VJP than
    1.5x the plain bf16 version (f32 inside, rounded once); dbias (f32)
    within TOL of the plain version's; one bf16 launch; two launches give
    the same bits."""
    from sic_tpu_torch.models.swin import _full_shift_mask
    bf = torch.bfloat16
    qkv = _randn((B, H, W, 3 * C), C + nB + 100, cuda).to(bf)
    g = _randn((B, H, W, C), 8, cuda).to(bf)
    bias = _randn((1, 256, 256), 4, cuda)
    if nB > 1:
        bias = (bias + torch.from_numpy(_full_shift_mask(H // 16, W // 16, 16))
                .to(cuda)).contiguous()
    before = ops.bf16_launch_counts()["window_attention_nhwc_bwd"]
    dqkv, dbias = ops.window_attention_nhwc_bwd(qkv, bias, g, 0.125, heads)
    torch.cuda.synchronize()
    assert ops.bf16_launch_counts()["window_attention_nhwc_bwd"] == before + 1
    assert dbias.dtype == torch.float32 and torch.isfinite(dbias).all()
    want_q, want_b = ops.window_attention_nhwc_bwd_plain(qkv, bias, g, 0.125, heads)
    f64_q, _ = _window_bwd_f64(qkv, bias, g, 0.125, heads)
    _bf16_within(dqkv, want_q, f64_q)
    assert _rel_err(dbias, want_b) <= TOL
    again = ops.window_attention_nhwc_bwd(qkv, bias, g, 0.125, heads)
    assert torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1])


@pytest.mark.parametrize("C,heads", [(768, 12), (1024, 16)])
@pytest.mark.parametrize("px,nB", [(256, 1), (512, 1), (512, 4)],
                         ids=["256px_nb1", "512px_nb1", "512px_nbnw"])
def test_window_attention_bwd_bf16_schedule(cuda, px, nB, C, heads):
    """Kernel 5's bf16 passes at both training sizes (one window a map at
    256 px; 2 x 2 windows at 512 px with a shared bias and one a window,
    the shifted layers' -inf masks included) and both Swin widths: dqkv
    within 1.5x the plain bf16 version's error against the f64 VJP, dbias
    within TOL of the plain version's, two launches bit-equal."""
    from sic_tpu_torch.models.swin import _full_shift_mask
    bf = torch.bfloat16
    n = px // 16
    qkv = _randn((2, n, n, 3 * C), px + nB + C, cuda).to(bf)
    g = _randn((2, n, n, C), px + 1, cuda).to(bf)
    bias = _randn((1, 256, 256), px + 2, cuda)
    if nB > 1:
        bias = (bias + torch.from_numpy(_full_shift_mask(n // 16, n // 16, 16))
                .to(cuda)).contiguous()
    dqkv, dbias = ops.window_attention_nhwc_bwd(qkv, bias, g, 0.125, heads)
    want_q, want_b = ops.window_attention_nhwc_bwd_plain(qkv, bias, g, 0.125, heads)
    f64_q, _ = _window_bwd_f64(qkv, bias, g, 0.125, heads)
    _bf16_within(dqkv, want_q, f64_q)
    assert dbias.shape == (nB, 256, 256) and _rel_err(dbias, want_b) <= TOL
    again = ops.window_attention_nhwc_bwd(qkv, bias, g, 0.125, heads)
    assert torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1])


def test_window_attention_bwd_bf16_compiles_to_bf16_tensor_core_instructions(cuda):
    """Kernel 5's library: its bf16 entry's functions (the stats pass in
    one-warpgroup blocks, the dk-dv and dq passes) hold bf16 HGMMA only,
    its f32 ones (the stats pass at both warpgroup counts, dk-dv, dq) none;
    the dbias pass (shared) holds none."""
    from sic_tpu_torch.ops import cuda_build
    cuda_build.build(("window_attention_bwd",))
    counts = cuda_build.sass_hgmma("window_attention_bwd")
    bf16_fns = [f for f in counts if "bfloat16" in f or "_bf16" in f]
    assert len(bf16_fns) == 3 and len(counts) == 8, counts
    for fn, c in counts.items():
        if fn == "bwd_dbias_kernel":
            assert c["hgmma"] == 0
        elif fn in bf16_fns:
            assert c["hgmma"] > 0 and c["bf16"] == c["hgmma"], (fn, c)
        else:
            assert c["hgmma"] > 0 and c["bf16"] == 0, (fn, c)


def test_bf16_feat_step_on_the_card_against_the_cpu(cuda):
    """One tiny-spec feat step with bf16 compute, bf16 Adam moments and
    bf16 frozen storage, and the same step in fp32, on the card and on the
    CPU from the same weights, batch and noise: the card's bf16-vs-fp32 gap
    within twice the CPU's own (tests/test_torch_train.py's rule against
    the JAX package), plus the fp32 steps' card-vs-CPU difference: every
    loss (or within one bf16 step of its magnitude), and the trainable
    gradients as one vector; each leaf's within three times."""
    import warnings

    from sic_tpu_torch import config as tcfg
    from sic_tpu_torch import train
    bf = torch.bfloat16
    rng = np.random.default_rng(9)
    x = torch.from_numpy(np.clip(rng.standard_normal((1, 256, 256, 3)) * 0.5, -1, 1)
                         .astype(np.float32))
    noise = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 8, 8, 16)).astype(np.float32))
    S = train.StageSpec
    strategy = train.TrainingStrategy(
        learning_rate=1e-4, start_epoch=0,
        stages=(S(1, 0, (1.0, 2.0), 2.0, 0.001),) * 3)
    out = {}
    for dev in ("cpu", "cuda"):
        for name, kw in (("f32", {}), ("bf16", dict(dtype=bf, mu_dtype=bf,
                                                    frozen_dtype=bf))):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _, state, steps = train.create_train_state(
                    tcfg.tiny_spec(), strategy, 0, device=dev, **kw,
                    img_cfg=train.ImgLossCfg(disc_ndf=16, disc_num_layers=2))
            logs = steps.feat_step(state, x.to(dev), noise=noise.to(dev))
            out[dev, name] = ({k: float(v) for k, v in logs.items()},
                              {"/".join(k): p.grad.double().cpu()
                               for k, p in state.trainable})
    (c32, g32), (c16, g16) = out["cpu", "f32"], out["cpu", "bf16"]
    (d32, h32), (d16, h16) = out["cuda", "f32"], out["cuda", "bf16"]
    for k in c16:
        assert np.isfinite(d16[k]), k
        assert abs(d16[k] - d32[k]) <= max(2 * abs(c16[k] - c32[k]), 2 ** -8 * abs(c32[k])) \
            + abs(d32[k] - c32[k]), (k, d16[k], d32[k], c16[k], c32[k])
    sq = torch.zeros(3, dtype=torch.float64)
    for k in g16:
        gaps = torch.stack([torch.linalg.vector_norm(h16[k] - h32[k]),
                            torch.linalg.vector_norm(g16[k] - g32[k]),
                            torch.linalg.vector_norm(h32[k] - g32[k])])
        sq += gaps ** 2
        card, cpu, f32_diff = gaps.tolist()
        assert card <= 3 * cpu + f32_diff + 1e-7 * torch.linalg.vector_norm(g32[k]), (k, gaps)
    card, cpu, f32_diff = sq.sqrt().tolist()
    assert card <= 2 * cpu + f32_diff, (card, cpu, f32_diff)


def test_attention_kernels_refuse_other_dtypes(cuda):
    """No fallback: a CUDA tensor of a dtype no entry takes (float16), or a
    bf16 bias, raises in each wrapper, and nothing launches."""
    before = ops.launch_counts()
    h = torch.float16
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        ops.seq_attention(_randn((2, 40, 3 * 128), 1, cuda).to(h), 0.125, 2)
    bias = _randn((1, 256, 256), 3, cuda)
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        ops.window_attention_nhwc(_randn((1, 16, 16, 3 * 128), 2, cuda).to(h),
                                  bias, 0.125, 2)
    q = _randn((8, 256, 64), 3, cuda)
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        ops.window_attention(q.to(h), q.to(h), q.to(h), bias, 0.125)
    with pytest.raises(ValueError, match="bias must be torch.float32"):
        qb = q.to(torch.bfloat16)
        ops.window_attention(qb, qb, qb, bias.to(torch.bfloat16), 0.125)
    qkv, g = _randn((1, 16, 16, 3 * 128), 4, cuda), _randn((1, 16, 16, 128), 5, cuda)
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        ops.window_attention_nhwc_bwd(qkv.to(h), bias, g.to(h), 0.125, 2)
    with pytest.raises(ValueError, match="g must be torch.bfloat16"):
        ops.window_attention_nhwc_bwd(qkv.to(torch.bfloat16), bias, g, 0.125, 2)
    assert ops.launch_counts() == before


def test_bf16_runtime_on_the_card(cuda):
    """load_runtime's default on CUDA is bf16.  The golden stream decodes
    to the fp32 runtime's h exactly and to pixels within the bound derived
    from the JAX package's own bf16-vs-fp32 gap (fixtures/golden_bf16.py);
    golden_input() encoded in bf16 decodes to its encoder's y_hat exactly
    in the bf16 and the fp32 runtime."""
    import sys
    from sic_tpu_torch.cli._common import load_runtime
    from sic_tpu_torch.config import tiny_spec
    from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
    sys.path.insert(0, str(GOLDEN.parents[1]))
    from fixtures.golden.generate import golden_input
    from fixtures.golden_bf16 import GAP_MULTIPLE, JAX_GAP_MAX, JAX_GAP_MEAN
    params = str(GOLDEN / "params.npz")
    rt = load_runtime(params, tiny_spec(), device="cuda", stream_part=1)
    rt32 = load_runtime(params, tiny_spec(), device="cuda", stream_part=1,
                        dtype="float32")
    try:
        assert rt.dtype == torch.bfloat16 and rt32.dtype == torch.float32
        enc, header = unpack_c2df(GOLDEN / "golden.c2df")
        enc = dict(sanitize_enc_result_types(enc), z_coder=header["z_coder"],
                   coding_batch=header["coding_batch"])
        before = ops.bf16_launch_counts()
        p, p32 = {}, {}
        x, x32 = rt.decode_only(**enc, probe=p), rt32.decode_only(**enc, probe=p32)
        after = ops.bf16_launch_counts()
        assert after["seq_attention"] > before["seq_attention"]
        assert after["window_attention_nhwc"] > before["window_attention_nhwc"]
        assert torch.equal(p["h_hat"], p32["h_hat"])
        diff = (x - x32).abs()
        assert diff.max().item() <= GAP_MULTIPLE * JAX_GAP_MAX
        assert diff.mean().item() <= GAP_MULTIPLE * JAX_GAP_MEAN
        probe = {}
        e = rt.encode_only(golden_input()[None], probe=probe)
        for r in (rt, rt32):
            out = {}
            r.decode_only(**e, coding_batch=8, probe=out)
            assert torch.equal(out["h_hat"], probe["y_hat"])
    finally:
        rt.close()
        rt32.close()


def _card_and_cpu(module):
    """``module`` on the card and an identical copy on the CPU."""
    import copy
    return copy.deepcopy(module).to("cuda"), module


def test_maskgit_generator_at_full_width_on_the_card(cuda):
    """MaskGITSpec() (hidden 768, 24 layers, 16 heads: head dim 48), seeded:
    conditioned and class-dropped logits on the card within 1e-3 of the
    largest CPU logit, kernel 1 launched at head dim 48 in every layer;
    the sampler's ids in vocabulary, no mask id, equal for one seed."""
    from sic_tpu_torch.models.maskgit import MaskGITGenerator, MaskGITSpec, generate
    from sic_tpu_torch.weights import init_seeded
    m = MaskGITGenerator(MaskGITSpec())
    init_seeded(m, seed=1)
    gpu, cpu = _card_and_cpu(m.eval().requires_grad_(False))
    g = np.random.default_rng(0)
    ids = torch.from_numpy(g.integers(0, 4097, (2, 32)))
    cond, drop = torch.tensor([3, 999]), torch.tensor([False, True])
    before = ops.head_dim_launch_counts().get(48, 0)
    with torch.no_grad():
        got = gpu(ids.to(cuda), cond.to(cuda), drop.to(cuda)).cpu()
        want = cpu(ids, cond, drop)
    assert ops.head_dim_launch_counts()[48] == before + 24
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()
    cond = torch.tensor([0, 1, 2, 3], device=cuda)
    a = generate(gpu, torch.Generator(device=cuda).manual_seed(5), cond)
    b = generate(gpu, torch.Generator(device=cuda).manual_seed(5), cond)
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < 4096


def test_titok_decode_tokens_at_full_width_on_the_card(cuda):
    """TiTok-L with the MaskGIT-VQGAN pixel decoder, seeded: decode_tokens
    of 32 tokens to 256x256 pixels on the card within 1e-3 of the CPU's
    (relative to their largest magnitude), kernel 1 at head dim 64."""
    from sic_tpu_torch.models.titok import TiTok
    from sic_tpu_torch.weights import init_seeded
    m = TiTok()
    init_seeded(m, seed=0)
    gpu, cpu = _card_and_cpu(m.eval().requires_grad_(False))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 4096, (1, 32)))
    before = ops.head_dim_launch_counts().get(64, 0)
    with torch.no_grad():
        got = gpu.decode_tokens(tokens.to(cuda)).cpu()
        want = cpu.decode_tokens(tokens)
    assert ops.head_dim_launch_counts()[64] == before + 24
    assert got.shape == (1, 256, 256, 3) and torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()


def test_uvit_generator_and_titok_s_decoder_at_full_width_on_the_card(cuda):
    """TiTok-S-128's generator (the U-ViT, 1024 wide, 21 blocks, 16 heads
    of 64: kernel 1 at qkv (2, 129, 3072)) and TiTok-S's decoder (512 wide,
    8 blocks, 8 heads of 64: (2, 385, 1536)) at published widths, with the
    benchmark's seeded draw, through the normal path on the card against
    the plain reference (``portbench/reference/maskgit_uvit.py``,
    ``portbench/reference/titok.py``) on the card with TF32 off: logits
    and pixels within 1e-3 of their largest magnitude, kernel 1 launched
    in every block at each shape."""
    import dataclasses

    from portbench.harness.weights import init_seeded
    from portbench.reference import config as rc, maskgit_uvit as ref
    from portbench.reference import maskgit_vqgan as rv, titok as rt
    from sic_tpu_torch.config import titok_s128_spec
    from sic_tpu_torch.models.maskgit_uvit import UViTGenerator, UViTSpec
    from sic_tpu_torch.models.maskgit_vqgan import MaskGITVQGANSpec
    from sic_tpu_torch.models.titok import TiTok
    ts, ps = titok_s128_spec(), MaskGITVQGANSpec()
    with torch.device(cuda):
        gen, titok = UViTGenerator(UViTSpec()), TiTok(ts, ps)
        rgen = ref.UViTGenerator(ref.UViTSpec())
        rtitok = rt.TiTok(rc.TiTokSpec(**dataclasses.asdict(ts)),
                          rv.MaskGITVQGANSpec(**dataclasses.asdict(ps)))
    for a, b, seed in ((gen, rgen, 1), (titok, rtitok, 0)):
        init_seeded(a, seed)
        init_seeded(b, seed)
        a.eval().requires_grad_(False)
        b.eval().requires_grad_(False)
    g = np.random.default_rng(0)
    ids = torch.from_numpy(g.integers(0, 4097, (2, 128))).to(cuda)
    cond, drop = torch.tensor([3, 999], device=cuda), torch.tensor([False, True], device=cuda)
    tokens = torch.from_numpy(g.integers(0, 4096, (2, 128))).to(cuda)
    ops.reset_launch_counts()
    with torch.no_grad():
        got, px = gen(ids, cond, drop), titok.decode_tokens(tokens)
        shapes = ops.heads_launch_counts()["seq_attention"]
        with ref.fp32():
            want, want_px = rgen(ids, cond, drop), rtitok.decode_tokens(tokens)
    assert ops.head_dim_launch_counts() == {64: 21 + 8}
    assert shapes == {16: 21, 8: 8}
    assert got.shape == (2, 128, 4096) and px.shape == (2, 256, 256, 3)
    for a, b in ((got, want), (px, want_px)):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()


# -- the fused NHWC GroupNorm + SiLU ----------------------------------------------


def _bf16_ulp(v):
    """The spacing of bf16 numbers at |v| (8 significand bits)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126))) - 7)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,dtype", [((8, 512, 512, 128), torch.bfloat16),
                                         ((8, 32, 32, 512), torch.bfloat16),
                                         ((16, 256, 256, 128), torch.float32)])
def test_group_norm_kernel_matches_plain(cuda, shape, dtype, silu):
    """The pixel decoders' shapes (flagship bf16 at 512x512 and at the
    attention blocks' 32x32, MaskGIT-VQGAN f32 at 256x256), inputs off
    zero mean.  Both compute in f32 and round once; only the order of the
    statistics' sums differs (groups of up to 4 M elements), and the
    kernel's SiLU takes the hardware's exp2 and reciprocal.  So the f32
    outputs differ by at most 1e-5 of the output's scale, and the bf16
    ones by that f32 gap plus one bf16 ulp (the rounding it can move; near
    zero the f32 gap is many ulps of the value).  Two launches give the
    same bits."""
    from sic_tpu_torch.ops.group_norm import group_norm_nhwc, group_norm_nhwc_plain
    C = shape[-1]
    x = (_randn(shape, C, cuda) * 2.0 + _randn((C,), 1, cuda) * 3.0).to(dtype)
    w, b = 1.0 + 0.5 * _randn((C,), 2, cuda), 0.5 * _randn((C,), 3, cuda)
    before = ops.group_norm_counts()
    got = group_norm_nhwc(x, w, b, 32, 1e-6, silu)
    assert ops.group_norm_counts() == {"launches": before["launches"] + 1,
                                       "composite": before["composite"]}
    assert got.dtype == dtype and got.is_contiguous() and got.shape == x.shape
    assert torch.equal(got, group_norm_nhwc(x, w, b, 32, 1e-6, silu))
    want = group_norm_nhwc_plain(x, w, b, 32, 1e-6, silu)
    got, want = got.float(), want.float()
    tol = 1e-5 * float(want.abs().max())
    if dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(torch.maximum(got.abs(), want.abs()))
    excess = (got - want).abs() - tol
    assert float(excess.max()) <= 0, (float(excess.max()), float((got - want).abs().max()))


def test_group_norm_kernel_refuses_what_it_cannot_take(cuda):
    """Groups of 3 bf16 channels (a 16-byte vector would straddle two),
    fp16, a strided input, channels that do not split into the groups, no
    images: each raises and launches nothing."""
    from sic_tpu_torch.ops.group_norm import group_norm_nhwc
    before = ops.group_norm_counts()["launches"]
    for x, groups in ((torch.zeros((1, 4, 4, 96), device=cuda, dtype=torch.bfloat16), 32),
                      (torch.zeros((1, 4, 4, 128), device=cuda, dtype=torch.float16), 32),
                      (torch.zeros((1, 4, 128, 4), device=cuda).transpose(2, 3), 32),
                      (torch.zeros((1, 4, 4, 128), device=cuda), 7),
                      (torch.zeros((0, 4, 4, 128), device=cuda), 32)):
        C = x.shape[-1]
        with pytest.raises(ValueError):
            group_norm_nhwc(x, torch.ones(C, device=cuda), torch.zeros(C, device=cuda),
                            groups, 1e-6, True)
    assert ops.group_norm_counts()["launches"] == before


def test_flagship_vqgan_decode_runs_every_group_norm_in_the_kernel(cuda):
    """The flagship's VQGAN decode (its 39 GroupNorms: 34 in resnet blocks
    and norm_out with SiLU, 4 in attention blocks without) of one 32x32
    latent to 512x512 in bf16 under no_grad launches the kernel 39 times
    and runs no composite norm; under autograd every norm is composite
    (the plain version) and the kernel is not launched.  Against the fp32
    decode, the kernel's pixels err on average no more than 1.25 times the
    plain version's (both round once; only the order of the statistics'
    sums and SiLU's exp differ)."""
    import copy
    from sic_tpu_torch.config import flagship_spec
    from sic_tpu_torch.models.layers import cast_compute
    from sic_tpu_torch.models.vqgan import VQGAN
    from sic_tpu_torch.weights import init_seeded
    spec = flagship_spec().vqgan
    m32 = VQGAN(spec)
    init_seeded(m32, seed=3)
    m32 = m32.to(cuda).eval()
    m = cast_compute(copy.deepcopy(m32), torch.bfloat16)
    z = _randn((1, 32, 32, spec.embed_dim), 4, cuda)
    with torch.no_grad():
        ref = m32.decode(z)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = m.decode(z.to(torch.bfloat16))
    assert ops.group_norm_counts() == {"launches": 39, "composite": 0}
    assert got.shape == (1, 512, 512, 3) and torch.isfinite(got.float()).all()
    ops.reset_launch_counts()
    composite = m.decode(z.to(torch.bfloat16)).detach()
    assert ops.group_norm_counts() == {"launches": 0, "composite": 39}
    err = float((got.float() - ref).abs().mean())
    assert err <= 1.25 * float((composite.float() - ref).abs().mean()), err


# -- the int8 mode: cuBLASLt's int8 GEMM through torch._int_mm -------------------


@pytest.mark.parametrize("M,K,N", [(8, 12, 1024), (578, 1024, 3072), (8, 16, 8),
                                   (1156, 4096, 1024), (17, 768, 2304)])
def test_int8_mm_on_the_card(cuda, M, K, N):
    """The int8 GEMM against its plain version, exactly, at padded shapes
    (K = 12, the decoder_embed's depth; M = 8, fewer than 17 rows) and at
    the flagship's Linear shapes; one launch counted each call."""
    from sic_tpu_torch.ops.quant import int8_mm, int8_mm_plain
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randint(-127, 128, (M, K), device=cuda, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, K), device=cuda, generator=g, dtype=torch.int8)
    before = int8_mm.launches
    acc = int8_mm(x, w)
    torch.cuda.synchronize()
    assert int8_mm.launches == before + 1
    assert acc.dtype == torch.int32 and acc.shape == (M, N)
    assert torch.equal(acc, int8_mm_plain(x, w))
    assert torch.equal(acc.cpu(), int8_mm(x.cpu(), w.cpu()))


def test_int8_mm_refuses_on_the_card(cuda):
    """Operands the GEMM cannot take raise on the card; nothing launches and
    nothing falls back to a float product."""
    from sic_tpu_torch.ops.quant import MAX_DEPTH, int8_mm
    before = int8_mm.launches
    i8 = dict(device=cuda, dtype=torch.int8)
    for x, w in ((torch.zeros(32, 16, device=cuda), torch.zeros(8, 16, **i8)),
                 (torch.zeros(32, 16, **i8), torch.zeros(8, 24, **i8)),
                 (torch.zeros(0, 16, **i8), torch.zeros(8, 16, **i8)),
                 (torch.zeros(17, MAX_DEPTH + 1, **i8), torch.zeros(8, MAX_DEPTH + 1, **i8))):
        with pytest.raises(ValueError):
            int8_mm(x, w)
    assert int8_mm.launches == before


@pytest.mark.parametrize("shape,out", [((2, 4, 12), 1024), ((4, 289, 1024), 3072),
                                       ((1, 32, 32, 768), 2304)])
def test_quant_linear_on_the_card(cuda, shape, out):
    """QuantLinear on the card against the same module on the CPU: x_q and
    the int32 accumulator exactly (the card's division, rounding and
    abs-max are IEEE, as the CPU's), the output within 1e-6 relative."""
    import copy
    from sic_tpu_torch.models.layers import Linear
    from sic_tpu_torch.ops.quant import QuantLinear, int8_mm, quantize_rows
    torch.manual_seed(0)
    lin = Linear(shape[-1], out)
    x = torch.randn(shape) * torch.rand(shape[:-1] + (1,)) * 4
    q = QuantLinear.from_linear(lin)
    qc = copy.deepcopy(q).to(cuda)
    xq, _ = quantize_rows(x)
    xq_c, _ = quantize_rows(x.to(cuda))
    assert torch.equal(xq_c.cpu(), xq)
    flat = xq.reshape(-1, shape[-1])
    assert torch.equal(int8_mm(flat.to(cuda), qc.weight_q).cpu(), int8_mm(flat, q.weight_q))
    got, want = qc(x.to(cuda)).cpu(), q(x)
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def test_int8_runtime_on_the_card(cuda):
    """load_runtime(quant="int8") on the card, fp32 and bf16: the golden
    stream decodes to the fp32 runtime's h exactly and to pixels within the
    bound derived from the JAX package's own int8-vs-fp32 gap
    (fixtures/golden_int8.py); the int8 GEMM and kernels 1 and 2 launch; a
    stream the int8 runtime writes decodes to its encoder's y_hat in the
    fp32 runtime."""
    import sys
    from sic_tpu_torch.cli._common import load_runtime
    from sic_tpu_torch.config import tiny_spec
    from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
    from sic_tpu_torch.ops.quant import int8_mm
    sys.path.insert(0, str(GOLDEN.parents[1]))
    from fixtures.golden.generate import golden_input
    from fixtures.golden_int8 import GAP_MULTIPLE, JAX_GAP_MAX, JAX_GAP_MEAN
    params = str(GOLDEN / "params.npz")
    rt32 = load_runtime(params, tiny_spec(), device="cuda", stream_part=1,
                        dtype="float32")
    enc, header = unpack_c2df(GOLDEN / "golden.c2df")
    enc = dict(sanitize_enc_result_types(enc), z_coder=header["z_coder"],
               coding_batch=header["coding_batch"])
    p32 = {}
    x32 = rt32.decode_only(**enc, probe=p32)
    try:
        for dtype in ("float32", "bfloat16"):
            rt = load_runtime(params, tiny_spec(), device="cuda", stream_part=1,
                              dtype=dtype, quant="int8")
            try:
                ops.reset_launch_counts()
                p = {}
                x = rt.decode_only(**enc, probe=p)
                counts = ops.launch_counts()
                assert int8_mm.launches > 0
                assert counts["seq_attention"] > 0 and counts["window_attention_nhwc"] > 0
                assert torch.equal(p["h_hat"], p32["h_hat"])
                diff = (x - x32).abs()
                assert diff.max().item() <= GAP_MULTIPLE * JAX_GAP_MAX
                assert diff.mean().item() <= GAP_MULTIPLE * JAX_GAP_MEAN
                probe = {}
                e = rt.encode_only(golden_input()[None], probe=probe)
                out = {}
                rt32.decode_only(**e, coding_batch=8, probe=out)
                assert torch.equal(out["h_hat"], probe["y_hat"])
            finally:
                rt.close()
    finally:
        rt32.close()


def test_factorized_tables_equal_on_the_card_and_the_cpu(cuda):
    """The factorized coder's tables come from table_cdf's fixed f32
    steps: the card's CDF equals the CPU's bit for bit, and so do the
    tables."""
    import copy
    from sic_tpu_torch.entropy import FactorizedCoder
    from sic_tpu_torch.entropy.factorized import BitEstimator, table_cdf
    torch.manual_seed(3)
    m = BitEstimator(16)
    with torch.no_grad():
        for p in m.parameters():
            p.mul_(50.0)
    mc = copy.deepcopy(m).to(cuda)
    x = torch.linspace(-60, 60, 1201)[:, None].repeat(1, 16)
    assert torch.equal(table_cdf(mc, x.to(cuda)).cpu(), table_cdf(m, x))
    a, b = FactorizedCoder(m), FactorizedCoder(mc)
    assert np.array_equal(a.quantized_cdf, b.quantized_cdf)
    assert np.array_equal(a.offset, b.offset)


# -- data and pipeline parallelism: two ranks on the one card (gloo) -----------

# PERF.md §2's card-vs-CPU training bounds: splitting a batch over ranks or
# microbatches changes the GEMMs' shapes, and so the summation order
CARD_LIMITS = {"feat": (1e-4, 1e-3), "pix": (1e-3, 5e-3)}


@pytest.fixture(scope="module")
def card_workers(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    from sic_tpu_torch.models import configure_numerics
    configure_numerics()
    import _torch_dist_workers as W
    W.DEVICE = "cuda:0"        # where the helpers build in this process
    yield W, tmp_path_factory.mktemp("ranks")
    W.DEVICE = "cpu"


@pytest.fixture(scope="module")
def card_dp(card_workers):
    W, tmp = card_workers
    x = W.global_batch()
    floor = W.rate_floor(x)
    ranks = W.run_task("dp", tmp, SIC_TEST_RATE_FLOOR=repr(floor),
                       SIC_TEST_DEVICE="cuda:0")
    ref = {}
    for stage in ("feat", "pix"):
        _, state, steps = W.train_state()
        state.rate_floor = floor
        logs = getattr(steps, f"{stage}_step")(state, torch.from_numpy(x).to("cuda:0"))
        ref[stage] = ({k: float(v) for k, v in logs.items()}, W.grads_of(state))
    return W, ranks, ref


@pytest.mark.parametrize("stage", ["feat", "pix"])
def test_two_ranks_on_the_card_equal_the_global_step(card_dp, stage):
    """Kernels 1, 2 and 5 in both ranks' steps; each rank's logs and
    gradients against the one-process step over the whole batch."""
    W, ranks, ref = card_dp
    loss_tol, grad_tol = CARD_LIMITS[stage]
    want_logs, want = ref[stage]
    grads = [k for k in want if not k.startswith("stats.")]
    for res in ranks:
        logs, got = res[stage]
        for k, v in want_logs.items():
            assert abs(logs[k] - v) <= loss_tol * abs(v) + 1e-7, (k, logs[k], v)
        err, key = W.worst_leaf({k: got[k] for k in grads}, {k: want[k] for k in grads})
        assert err <= grad_tol, (key, err)
    c = ranks[1]["controls"]
    assert float((c["noise"][0] - c["noise"][1]).norm()) > 0     # rows, not a local draw


def test_two_stage_pipeline_on_the_card_equals_the_sequential_trunks(card_workers):
    W, tmp = card_workers
    ranks = W.run_task("pipeline", tmp, SIC_TEST_DEVICE="cuda:0")
    x = W.global_batch(4, seed=11)
    loss, x_hat, grads = W.codec_grads(W.pp_codec(), x, W.pp_noise(x))
    for m in (2, 4):
        for res in ranks:
            got_loss, got_x, got = res[f"codec_m{m}"]
            assert abs(got_loss - loss) <= 1e-4 * abs(loss)
            assert float((got_x - x_hat).abs().max()) <= 1e-3
            err, key = W.worst_leaf(got, {k: grads[k] for k in got})
            assert err <= 1e-3, (m, key, err)
