"""Window attention: NHWC over a packed qkv projection with its gradient,
and over separate (G, s, d) q, k, v tensors.

CUDA kernels, all split-TF32 ``wgmma`` on the tensor cores with tiles
loaded by TMA (``csrc/attention_tc.cuh`` holds the forward body they
share): ``csrc/window_attention.cu`` (the NHWC forward, replacing the TPU
kernel ``sic_tpu/ops/window_attention.py::_nhwc_kernel``),
``csrc/window_attention_bwd.cu`` (its backward, replacing
``_nhwc_bwd_kernel``) and ``csrc/window_attention_gsd.cu`` (the (G, s, d)
forward, replacing ``_attention_kernel``).  Every Swin layer runs the NHWC
pair: the detail branch's ``feat_in``, ``feat_out_swin``, ``feat_up_swin``,
the ``FeatBlock`` refiners and the eight layers of FeatMerge.  The (G, s, d)
op :func:`window_attention` is a public op of its own, as in the JAX
package, where no model layer calls it either.  On a CUDA tensor each
entry point is a ``torch.autograd.Function`` whose forward is a kernel;
the NHWC backward is the backward kernel, the (G, s, d) backward the JAX
package's recompute in plain torch (the JAX package has no backward kernel
for it).  On a CPU tensor each is its plain version under autograd.  The
plain versions are also the kernels' oracles on the card.  The cyclic
shift of shifted layers stays outside (in ``models/swin.py``), as in the
JAX package.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build

HEAD_DIM = 64


def _window_size(bias: torch.Tensor) -> int:
    s = bias.shape[-1]
    ws = int(round(math.sqrt(s)))
    if ws * ws != s:
        raise ValueError(f"bias rows {s} are not a square window")
    return ws


def window_attention_nhwc_plain(qkv: torch.Tensor, bias: torch.Tensor,
                                scale: float, heads: int) -> torch.Tensor:
    """qkv (B, H, W, 3C), bias (nB, s, s) f32 -> (B, H, W, C); window
    (i, j) takes ``bias[(i * nww + j) % nB]`` (the JAX package's
    ``_nhwc_reference``)."""
    B, H, W, c3 = qkv.shape
    C = c3 // 3
    d = C // heads
    ws = _window_size(bias)
    s = ws * ws
    nwh, nww = H // ws, W // ws
    nW = nwh * nww
    t = qkv.reshape(B, nwh, ws, nww, ws, 3, heads, d)
    t = t.permute(5, 0, 6, 1, 3, 2, 4, 7).reshape(3, B, heads, nW, s, d)
    q, k, v = t[0], t[1], t[2]
    win = torch.arange(nW, device=bias.device) % bias.shape[0]
    dots = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    dots = dots + bias.float()[win]
    probs = torch.softmax(dots, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v)                      # (B, heads, nW, s, d)
    out = out.reshape(B, heads, nwh, nww, ws, ws, d)
    return out.permute(0, 2, 4, 3, 5, 1, 6).reshape(B, H, W, C)


def window_attention_nhwc_bwd_plain(qkv: torch.Tensor, bias: torch.Tensor,
                                    g: torch.Tensor, scale: float,
                                    heads: int):
    """The VJP of :func:`window_attention_nhwc_plain` at (qkv, bias) for
    the output gradient ``g``: (dqkv (B, H, W, 3C), dbias (nB, s, s))."""
    with torch.enable_grad():
        a = qkv.detach().requires_grad_(True)
        b = bias.detach().requires_grad_(True)
        out = window_attention_nhwc_plain(a, b, scale, heads)
        return torch.autograd.grad(out, (a, b), g)


def _check_kernel_args(qkv, bias, heads, name):
    cuda_build.require_cuda(qkv, "qkv", torch.float32)
    cuda_build.require_cuda(bias, "bias", torch.float32)
    B, H, W, c3 = qkv.shape
    C = c3 // 3
    ws = _window_size(bias)
    if c3 != 3 * C or C != heads * HEAD_DIM or H % ws or W % ws \
            or bias.dim() != 3:
        raise ValueError(f"{name} kernel: qkv {tuple(qkv.shape)}, bias "
                         f"{tuple(bias.shape)}, heads {heads} (head dim "
                         f"must be {HEAD_DIM})")
    return B, H, W, C, ws


# window sides the forward kernel takes: a 64-token tile is whole window rows
FORWARD_WINDOWS = (8, 16, 32, 64)


def _forward_kernel(qkv, bias, scale, heads):
    B, H, W, C, ws = _check_kernel_args(qkv, bias, heads, "window_attention_nhwc")
    if ws not in FORWARD_WINDOWS or B == 0 or bias.shape[0] == 0 \
            or bias.shape[1] != ws * ws or qkv.data_ptr() % 16 \
            or bias.data_ptr() % 16:
        raise ValueError(f"window_attention_nhwc kernel: window {ws} (must be "
                         f"one of {FORWARD_WINDOWS}), qkv {tuple(qkv.shape)} "
                         f"and bias {tuple(bias.shape)} non-empty, both on "
                         "16-byte boundaries (their tensor maps)")
    out = torch.empty((B, H, W, C), device=qkv.device, dtype=qkv.dtype)
    rc = _lib("window_attention", "sic_window_attention", 3).sic_window_attention(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W, C, heads,
        ws, bias.shape[0], float(scale), cuda_build.stream_of(qkv))
    cuda_build.check_launch(rc, "window_attention_nhwc")
    cuda_build.count_launch(window_attention_nhwc)
    return out


class _WindowAttention(torch.autograd.Function):
    """Forward kernel, backward kernel (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, qkv, bias, scale, heads):
        ctx.save_for_backward(qkv, bias)
        ctx.scale, ctx.heads = scale, heads
        return _forward_kernel(qkv, bias, scale, heads)

    @staticmethod
    def backward(ctx, g):
        qkv, bias = ctx.saved_tensors
        dqkv, dbias = window_attention_nhwc_bwd(qkv, bias, g.contiguous(),
                                                ctx.scale, ctx.heads)
        return dqkv, dbias, None, None


def window_attention_nhwc(qkv: torch.Tensor, bias: torch.Tensor,
                          scale: float, heads: int) -> torch.Tensor:
    """qkv: (B, H, W, 3C) float32, channel layout [q heads*d | k | v];
    bias: (nB, s, s) float32 additive logits bias (relative position plus
    any -inf shift mask), nB dividing into the window count.  Returns
    (B, H, W, C) head-major.  A CPU tensor takes the plain version; a CUDA
    tensor launches the forward kernel (head dim 64) or raises, and its
    gradient (to qkv and bias) launches the backward kernel."""
    if qkv.device.type == "cpu":
        return window_attention_nhwc_plain(qkv, bias, scale, heads)
    return _WindowAttention.apply(qkv, bias, scale, heads)


window_attention_nhwc.launches = 0


def window_attention_nhwc_bwd(qkv: torch.Tensor, bias: torch.Tensor,
                              g: torch.Tensor, scale: float, heads: int):
    """The gradient of :func:`window_attention_nhwc`: (dqkv (B, H, W, 3C),
    dbias (nB, s, s) f32).  dbias is summed over the batch and the heads,
    and over the windows too when nB == 1; nB must be 1 or the window count.
    A CPU tensor takes the plain version's autograd; a CUDA tensor launches
    the backward kernel (head dim 64, a window side the forward kernel
    takes) or raises."""
    B, H, W, c3 = qkv.shape
    ws = _window_size(bias)
    nW = (H // ws) * (W // ws)
    nB = bias.shape[0]
    if nB not in (1, nW):
        raise ValueError(f"bias rows must be 1 or {nW}, got {nB}")
    if qkv.device.type == "cpu":
        return window_attention_nhwc_bwd_plain(qkv, bias, g, scale, heads)
    B, H, W, C, ws = _check_kernel_args(qkv, bias, heads, "window_attention_nhwc_bwd")
    cuda_build.require_cuda(g, "g", torch.float32)
    s = ws * ws
    if tuple(g.shape) != (B, H, W, C) or ws not in FORWARD_WINDOWS or B == 0 \
            or any(t.data_ptr() % 16 for t in (qkv, bias, g)):
        raise ValueError(f"window_attention_nhwc_bwd kernel: g "
                         f"{tuple(g.shape)} for qkv {tuple(qkv.shape)}, "
                         f"window {ws} (must be one of {FORWARD_WINDOWS}: "
                         "64-token tiles of whole window rows), qkv, bias and "
                         "g on 16-byte boundaries (their tensor maps)")
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((nB, s, s), device=qkv.device, dtype=torch.float32)
    # scratch: dS per (batch, window, head) and the per-row (lse, D) stats
    ds = torch.empty((B, nW, heads, s, s), device=qkv.device, dtype=torch.float32)
    stats = torch.empty((B, nW, heads, s, 2), device=qkv.device, dtype=torch.float32)
    rc = _lib("window_attention_bwd", "sic_window_attention_bwd", 7).sic_window_attention_bwd(
        qkv.data_ptr(), bias.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
        dbias.data_ptr(), ds.data_ptr(), stats.data_ptr(), B, H, W, C, heads,
        ws, nB, float(scale), cuda_build.stream_of(qkv))
    cuda_build.check_launch(rc, "window_attention_nhwc_bwd")
    cuda_build.count_launch(window_attention_nhwc_bwd)
    return dqkv, dbias


window_attention_nhwc_bwd.launches = 0


def _lib(name: str, fn_name: str, n_pointers: int) -> ctypes.CDLL:
    """The kernel library ``name`` with ``fn_name``'s signature set: its
    first ``n_pointers`` arguments are pointers, then seven ints (B, H, W,
    C, heads, ws, nB), the float scale and the stream."""
    lib = cuda_build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


# -- (G, s, d) window attention ----------------------------------------------


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, scale: float) -> torch.Tensor:
    """q, k, v (G, s, d), bias (nW, s, s) f32 -> (G, s, d); window-head g
    takes ``bias[g % nW]`` (the JAX package's ``_forward_reference``):
    f32 logits and softmax, probabilities cast to ``v``'s type."""
    G, s, _ = q.shape
    nW = bias.shape[0]
    dots = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    dots = (dots.reshape(G // nW, nW, s, s) + bias).reshape(G, s, s)
    probs = torch.softmax(dots, dim=-1).to(v.dtype)
    return torch.matmul(probs, v).to(q.dtype)


def window_attention_bwd_plain(q, k, v, bias, g, scale: float):
    """The VJP of :func:`window_attention_plain` for the output gradient
    ``g``, recomputed in f32 as the JAX package's ``_bwd`` does: (dq, dk,
    dv, dbias), dbias (nW, s, s) summed over the ``G // nW`` groups."""
    G, s, _ = q.shape
    nW = bias.shape[0]
    q32, k32, v32, g32 = q.float(), k.float(), v.float(), g.float()
    dots = torch.matmul(q32 * scale, k32.transpose(-1, -2))
    dots = (dots.reshape(G // nW, nW, s, s) + bias).reshape(G, s, s)
    probs = torch.softmax(dots, dim=-1)
    dv = torch.matmul(probs.transpose(-1, -2), g32)
    dprobs = torch.matmul(g32, v32.transpose(-1, -2))
    ddots = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True))
    dq = torch.matmul(ddots, k32) * scale
    dk = torch.matmul(ddots.transpose(-1, -2), q32 * scale)
    dbias = ddots.reshape(G // nW, nW, s, s).sum(0)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dbias.to(bias.dtype))


def _gsd_kernel(q, k, v, bias, scale):
    """Launch the (G, s, d) kernel.  Its tensor maps need every base on a
    16-byte boundary and the bias's row stride a multiple of 16 bytes:
    where s % 4 != 0 (a 7x7 window: s = 49) the bias's last axis is padded
    with zeros to a multiple of 4, once per call; the padded columns lie
    past s, where the kernel masks every key, so they change nothing."""
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        cuda_build.require_cuda(t, name, torch.float32)
    G, s, d = q.shape
    if d != HEAD_DIM or tuple(k.shape) != tuple(q.shape) \
            or tuple(v.shape) != tuple(q.shape) or bias.dim() != 3 \
            or tuple(bias.shape[1:]) != (s, s) or G == 0 or s == 0:
        raise ValueError(f"window_attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, bias "
                         f"{tuple(bias.shape)} (non-empty, head dim must be "
                         f"{HEAD_DIM})")
    if any(t.data_ptr() % 16 for t in (q, k, v, bias)):
        raise ValueError("window_attention kernel: q, k, v and bias must lie "
                         "on 16-byte boundaries (their tensor maps)")
    row = -(-s // 4) * 4
    if row != s:
        bias = torch.nn.functional.pad(bias, (0, row - s))
    out = torch.empty_like(q)
    lib = cuda_build.load("window_attention_gsd")
    fn = lib.sic_window_attention_gsd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), G, s, d, bias.shape[0], row, float(scale),
            cuda_build.stream_of(q))
    cuda_build.check_launch(rc, "window_attention")
    cuda_build.count_launch(window_attention)
    return out


class _WindowAttentionGSD(torch.autograd.Function):
    """Forward kernel, backward by plain f32 recompute (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return _gsd_kernel(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        return (*window_attention_bwd_plain(q, k, v, bias, g, ctx.scale), None)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float) -> torch.Tensor:
    """q, k, v: (G, s, d) with G a multiple of ``bias.shape[0]``; bias:
    (nW, s, s) f32 additive logits bias (position bias plus any -inf shift
    mask), window-head g taking ``bias[g % nW]``.  Returns (G, s, d).  A
    CPU tensor takes the plain version under autograd; a CUDA tensor
    launches the kernel (f32, head dim 64, contiguous) or raises, and its
    gradient (to q, k, v and bias) is the plain f32 recompute."""
    G, nW = q.shape[0], bias.shape[0]
    if nW < 1 or G % nW:
        raise ValueError(f"window_attention: G {G} is not a multiple of the "
                         f"{nW} bias windows")
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention runs on CPU or CUDA tensors, "
                         f"got {q.device}")
    return _WindowAttentionGSD.apply(q, k, v, bias, scale)


window_attention.launches = 0
