"""NHWC window attention over a packed qkv projection, with its gradient.

CUDA kernels: ``csrc/window_attention.cu`` (the forward, replacing the TPU
kernel ``sic_tpu/ops/window_attention.py::_nhwc_kernel``) and
``csrc/window_attention_bwd.cu`` (the backward, replacing
``_nhwc_bwd_kernel``).  Every Swin layer runs them: the detail branch's
``feat_in``, ``feat_out_swin``, ``feat_up_swin``, the ``FeatBlock``
refiners and the eight layers of FeatMerge.  On a CUDA tensor
:func:`window_attention_nhwc` is a ``torch.autograd.Function`` whose forward
is the forward kernel and whose backward is the backward kernel; on a CPU
tensor it is :func:`window_attention_nhwc_plain` under autograd.  The plain
versions are also the kernels' oracles on the card.  The cyclic shift of
shifted layers stays outside (in ``models/swin.py``), as in the JAX package.
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


def _forward_kernel(qkv, bias, scale, heads):
    B, H, W, C, ws = _check_kernel_args(qkv, bias, heads, "window_attention_nhwc")
    out = torch.empty((B, H, W, C), device=qkv.device, dtype=qkv.dtype)
    rc = _lib("window_attention", "sic_window_attention", 3).sic_window_attention(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W, C, heads,
        ws, bias.shape[0], float(scale), cuda_build.stream_of(qkv))
    cuda_build.check_launch(rc, "window_attention_nhwc")
    window_attention_nhwc.launches += 1
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
    the backward kernel or raises."""
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
    if tuple(g.shape) != (B, H, W, C) or s % 64:
        raise ValueError(f"window_attention_nhwc_bwd kernel: g "
                         f"{tuple(g.shape)} for qkv {tuple(qkv.shape)}, "
                         f"window {ws} (ws * ws must be a multiple of 64)")
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
    window_attention_nhwc_bwd.launches += 1
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
