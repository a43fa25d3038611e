"""The arithmetic of the tensor-core attention kernels (split TF32) on the
CPU: the forwards of kernels 1 and 2 (kernel 6 runs the same body) and the
backward of kernel 2 (kernel 5).

The card's attention kernels run both products on the tensor cores in
TF32, each operand split as hi = tf32(x), lo = tf32(x - hi) and summed as
lo.hi + hi.lo + hi.hi in f32 (3xTF32).  Here the same arithmetic is
emulated in plain torch (TF32 rounding: round to nearest, ties away from
zero, on the int32 view, then the low 13 bits cleared; a product of two
TF32 values is exact in f32) and held against an f64 reference, beside
the port's plain f32 version and a single TF32 pass.  At the GPU tests'
inputs (one head; the trunk's S 289 and a 16x16 window's s 256 with its
bias; unit and x4 magnitude) 3xTF32 must err by at most 4 times plain
f32's own error and a single pass by at least 100 times it: the GPU tests'
tolerance (1e-4) tells the two apart.  The backward is held the same way
on each of its outputs (dq, dk, dv, dbias), with its five products split
and summed tile by tile as the kernel does.
"""
import numpy as np
import pytest
import torch

from sic_tpu_torch import ops

SCALE = 0.125
D = 64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits) to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in split TF32: small terms first, one f32 accumulation."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def attend(q, k, v, bias, mm):
    """The kernels' order: logits of (q scale) k^T (+ bias), exponentials
    against the row max, unnormalised P v, divided by the row sum."""
    s = mm(q * SCALE, k.T)
    if bias is not None:
        s = s + bias
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return mm(p, v) / p.sum(-1, keepdim=True)


def _case(n, windowed, magnitude, seed):
    """One head's q, k, v (n, 64) f32 (and a window's bias), and the plain
    f32 version's output through the port's own plain function."""
    rng = np.random.default_rng(seed)
    qkv = (rng.standard_normal((n, 3 * D)) * magnitude).astype(np.float32)
    q, k, v = (torch.from_numpy(qkv[:, i * D:(i + 1) * D].copy()) for i in range(3))
    if not windowed:
        plain = ops.seq_attention_plain(torch.from_numpy(qkv)[None], SCALE, 1)[0]
        return q, k, v, None, plain
    ws = int(round(n ** 0.5))
    bias = torch.from_numpy(rng.standard_normal((1, n, n)).astype(np.float32))
    plain = ops.window_attention_nhwc_plain(
        torch.from_numpy(qkv).reshape(1, ws, ws, 3 * D), bias, SCALE, 1)
    return q, k, v, bias[0], plain.reshape(n, D)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -12, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 * 2 ** -10,
                         -(1.0 + 2 ** -10), 1.0, 3.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    r = tf32(y)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((r - y).abs() <= y.abs() * 2 ** -11).all()
    # hi + lo carries about 21 significant bits
    lo = tf32(y - r)
    assert ((r + lo - y).abs() <= y.abs() * 2 ** -21).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("magnitude", [1.0, 4.0])
@pytest.mark.parametrize("n,windowed", [(289, False), (256, True)])
def test_split_tf32_attention_keeps_f32_accuracy(n, windowed, magnitude, seed):
    q, k, v, bias, plain = _case(n, windowed, magnitude, seed)
    ref = attend(q.double(), k.double(), v.double(),
                 None if bias is None else bias.double(), torch.matmul)
    err_f32 = (plain.double() - ref).abs().max().item()
    err_3x = (attend(q, k, v, bias, mm3).double() - ref).abs().max().item()
    err_1x = (attend(q, k, v, bias, mm1).double() - ref).abs().max().item()
    assert err_f32 > 0
    assert err_3x <= 4 * err_f32, (err_3x, err_f32)
    assert err_1x >= 100 * err_f32, (err_1x, err_f32)


TILE = 64


def backward(q, k, v, bias, g, mm):
    """Kernel 5's arithmetic for one window-head: the row statistics from
    the forward (lse, and D = g . O with O summed a key tile at a time),
    then per (key tile, query tile) S^T = k (q scale)^T and dP^T = v g^T,
    P^T = exp(S^T + bias^T - lse), dS^T = P^T (dP^T - D), dv and dk each
    tile's product in a fresh accumulator added in f32; dq = dS k scale a
    key tile at a time; dbias = dS."""
    n = q.shape[0]
    tiles = range(0, n, TILE)
    qs = q * SCALE
    s = mm(qs, k.T) + bias
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = sum(mm(p[:, j:j + TILE], v[j:j + TILE]) for j in tiles) / l
    lse = (m + torch.log(l)).T
    dcol = (g * o).sum(-1, keepdim=True).T
    ds = torch.empty_like(s)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for j in tiles:
        J = slice(j, j + TILE)
        for i in tiles:
            I = slice(i, i + TILE)
            pt = torch.exp(mm(k[J], qs[I].T) + bias[I, J].T - lse[:, I])
            dst = pt * (mm(v[J], g[I].T) - dcol[:, I])
            dv[J] += mm(pt, g[I])
            dk[J] += mm(dst, qs[I])
            ds[I, J] = dst.T
    dq = torch.zeros_like(q)
    for j in tiles:
        dq += mm(ds[:, j:j + TILE], k[j:j + TILE])
    return dq * SCALE, dk, dv, ds


def backward_f64(q, k, v, bias, g):
    q, k, v, bias, g = (t.double() for t in (q, k, v, bias, g))
    p = torch.softmax(q * SCALE @ k.T + bias, -1)
    dp = g @ v.T
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return ds @ k * SCALE, ds.T @ (q * SCALE), p.T @ g, ds


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("magnitude", [1.0, 4.0])
def test_split_tf32_attention_backward_keeps_f32_accuracy(magnitude, seed):
    """One 16x16 window-head (s 256) with its bias: every output of the
    emulated kernel within 4 times plain f32's error against f64 (the
    port's plain version's autograd), a single TF32 pass 100 times or
    more."""
    n, ws = 256, 16
    rng = np.random.default_rng(100 + seed)
    qkv = (rng.standard_normal((n, 3 * D)) * magnitude).astype(np.float32)
    q, k, v = (torch.from_numpy(qkv[:, i * D:(i + 1) * D].copy()) for i in range(3))
    bias = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    dqkv, dbias = ops.window_attention_nhwc_bwd_plain(
        torch.from_numpy(qkv).reshape(1, ws, ws, 3 * D), bias[None],
        g.reshape(1, ws, ws, D), SCALE, 1)
    dqkv = dqkv.reshape(n, 3 * D)
    plain = (dqkv[:, :D], dqkv[:, D:2 * D], dqkv[:, 2 * D:], dbias[0])
    ref = backward_f64(q, k, v, bias, g)
    three = backward(q, k, v, bias, g, mm3)
    one = backward(q, k, v, bias, g, mm1)
    for name, p, r, x3, x1 in zip(("dq", "dk", "dv", "dbias"), plain, ref, three, one):
        err_f32 = (p.double() - r).abs().max().item()
        err_3x = (x3.double() - r).abs().max().item()
        err_1x = (x1.double() - r).abs().max().item()
        assert err_f32 > 0, name
        assert err_3x <= 4 * err_f32, (name, err_3x, err_f32)
        assert err_1x >= 100 * err_f32, (name, err_1x, err_f32)
