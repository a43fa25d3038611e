"""Sequence self-attention over a packed qkv projection.

CUDA kernel: ``csrc/seq_attention.cu`` (replaces the TPU kernel
``sic_tpu/ops/seq_attention.py::_seq_attn_kernel``): fp32 attention on
the tensor cores in split TF32 (``wgmma``), tiles loaded by TMA.  The ViT
trunks (S = 289), the cross-attention blocks (S = 545) and the CLIP image
tower (S = 50) run it in every layer.
:func:`seq_attention_plain` is the same function in plain PyTorch: it
serves CPU tensors and is the kernel's oracle on the card.  On a CUDA tensor
:func:`seq_attention` is a ``torch.autograd.Function``: the kernel forward,
and a backward that recomputes through the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

HEAD_DIM = 64


def seq_attention_plain(qkv: torch.Tensor, scale: float,
                        heads: int) -> torch.Tensor:
    """qkv (B, S, 3C) packed [q | k | v] -> (B, S, C) head-major; f32
    logits and softmax (the JAX package's ``_seq_attn_reference``)."""
    B, S, c3 = qkv.shape
    C = c3 // 3
    d = C // heads
    q, k, v = torch.split(qkv, C, dim=-1)

    def split(t):  # (B, S, C) -> (B, heads, S, d)
        return t.reshape(B, S, heads, d).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v)
    return out.transpose(1, 2).reshape(B, S, C)


def _forward_kernel(qkv: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    cuda_build.require_cuda(qkv, "qkv", torch.float32)
    B, S, c3 = qkv.shape
    C = c3 // 3
    if c3 != 3 * C or C != heads * HEAD_DIM:
        raise ValueError(f"seq_attention kernel needs head dim {HEAD_DIM}: "
                         f"qkv {tuple(qkv.shape)}, heads {heads}")
    if B == 0 or S == 0 or qkv.data_ptr() % 16:
        raise ValueError(f"seq_attention kernel: qkv {tuple(qkv.shape)} must "
                         "be non-empty and start on a 16-byte boundary (its "
                         "tensor map)")
    out = torch.empty((B, S, C), device=qkv.device, dtype=qkv.dtype)
    lib = _lib()
    rc = lib.sic_seq_attention(qkv.data_ptr(), out.data_ptr(), B, S, C,
                               heads, float(scale),
                               cuda_build.stream_of(qkv))
    cuda_build.check_launch(rc, "seq_attention")
    cuda_build.count_launch(seq_attention)
    return out


class _SeqAttention(torch.autograd.Function):
    """Forward kernel; the backward recomputes through the plain version
    under autograd, as the JAX package's custom VJP recomputes through its
    reference (it has no backward kernel for this function)."""

    @staticmethod
    def forward(ctx, qkv, scale, heads):
        ctx.save_for_backward(qkv)
        ctx.scale, ctx.heads = scale, heads
        return _forward_kernel(qkv, scale, heads)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            a = qkv.detach().requires_grad_(True)
            out = seq_attention_plain(a, ctx.scale, ctx.heads)
            (dqkv,) = torch.autograd.grad(out, a, g)
        return dqkv, None, None


def seq_attention(qkv: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    """qkv: (B, S, 3C) float32, channel layout [q heads*d | k | v]; returns
    (B, S, C) in head-major channel order.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (head dim 64) or raises, and
    its gradient recomputes through the plain version."""
    if qkv.device.type == "cpu":
        return seq_attention_plain(qkv, scale, heads)
    return _SeqAttention.apply(qkv, scale, heads)


seq_attention.launches = 0


def _lib():
    lib = cuda_build.load("seq_attention")
    fn = lib.sic_seq_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
