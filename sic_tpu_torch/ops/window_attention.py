"""NHWC window attention over a packed qkv projection.

CUDA kernel: ``csrc/window_attention.cu`` (replaces the TPU kernel
``sic_tpu/ops/window_attention.py::_nhwc_kernel``).  Every Swin layer of the
decode path runs it: ``feat_up_swin``, the ``_FeatBlock`` refiners and the
eight layers of FeatMerge.  :func:`window_attention_nhwc_plain` is the same
function in plain PyTorch: it serves CPU tensors and is the kernel's oracle
on the card.  The cyclic shift of shifted layers stays outside (in
``models/swin.py``), as in the JAX package.
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


def window_attention_nhwc(qkv: torch.Tensor, bias: torch.Tensor,
                          scale: float, heads: int) -> torch.Tensor:
    """qkv: (B, H, W, 3C) float32, channel layout [q heads*d | k | v];
    bias: (nB, s, s) float32 additive logits bias (relative position plus
    any -inf shift mask), nB dividing into the window count.  Returns
    (B, H, W, C) head-major.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (head dim 64) or raises."""
    if qkv.device.type == "cpu":
        return window_attention_nhwc_plain(qkv, bias, scale, heads)
    cuda_build.require_cuda(qkv, "qkv", torch.float32)
    cuda_build.require_cuda(bias, "bias", torch.float32)
    B, H, W, c3 = qkv.shape
    C = c3 // 3
    ws = _window_size(bias)
    if c3 != 3 * C or C != heads * HEAD_DIM or H % ws or W % ws \
            or bias.dim() != 3:
        raise ValueError(f"window_attention_nhwc kernel: qkv "
                         f"{tuple(qkv.shape)}, bias {tuple(bias.shape)}, "
                         f"heads {heads} (head dim must be {HEAD_DIM})")
    out = torch.empty((B, H, W, C), device=qkv.device, dtype=qkv.dtype)
    lib = _lib()
    rc = lib.sic_window_attention(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W, C, heads,
        ws, bias.shape[0], float(scale), cuda_build.stream_of(qkv))
    cuda_build.check_launch(rc, "window_attention_nhwc")
    window_attention_nhwc.launches += 1
    return out


window_attention_nhwc.launches = 0


def _lib():
    lib = cuda_build.load("window_attention")
    fn = lib.sic_window_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
