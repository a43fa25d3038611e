"""Sequence self-attention over a packed qkv projection.

CUDA kernel: ``csrc/seq_attention.cu`` (replaces the TPU kernel
``sic_tpu/ops/seq_attention.py::_seq_attn_kernel``), on the tensor cores
(``wgmma``) with tiles loaded by TMA: an f32 entry in split TF32 and a
bf16 entry (bf16 products, f32 accumulation, logits and softmax; the bf16
serving mode).  The ViT trunks (S = 289; TiTok-L's encoder and decoder
too), the cross-attention blocks (S = 545) and the CLIP image tower
(S = 50, f32) run it in every layer at head dim 64, the MaskGIT generator
(S = 33) at head dim 48.  The kernel takes every head dim the JAX kernel
does up to its body's 64 columns whose row is a multiple of 16 bytes
(:func:`kernel_takes_head_dim`): 32, 48 and 64 in f32 and bf16.
:func:`seq_attention_plain` is the same function in plain PyTorch: it
serves CPU tensors and is the kernel's oracle on the card.  On a CUDA tensor
:func:`seq_attention` is a ``torch.autograd.Function``: the kernel forward,
and a backward that recomputes through the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# the widest head the kernel's body holds
MAX_HEAD_DIM = 64
# the dtypes the kernel has an entry for
DTYPES = (torch.float32, torch.bfloat16)


def kernel_takes_head_dim(d: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes heads of ``d`` channels of ``dtype``: at
    most 64 (its tiles' width; TMA fills the columns past d with zeros),
    and a row of d elements a multiple of 16 bytes (a tensor-map stride)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 0 < d <= MAX_HEAD_DIM and (d * itemsize) % 16 == 0


def seq_attention_plain(qkv: torch.Tensor, scale: float,
                        heads: int) -> torch.Tensor:
    """qkv (B, S, 3C) packed [q | k | v] -> (B, S, C) head-major; f32
    logits and softmax, probabilities rounded to qkv's type before the
    product with v (the JAX package's ``_seq_attn_reference``)."""
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
    cuda_build.require_cuda(qkv, "qkv", DTYPES)
    B, S, c3 = qkv.shape
    C = c3 // 3
    d = C // heads if heads > 0 else 0
    if c3 != 3 * C or C != heads * d or not kernel_takes_head_dim(d, qkv.dtype):
        raise ValueError(f"seq_attention kernel takes a head dim of at most "
                         f"{MAX_HEAD_DIM} whose row is a multiple of 16 bytes: "
                         f"qkv {tuple(qkv.shape)} {qkv.dtype}, heads {heads}")
    if B == 0 or S == 0 or qkv.data_ptr() % 16:
        raise ValueError(f"seq_attention kernel: qkv {tuple(qkv.shape)} must "
                         "be non-empty and start on a 16-byte boundary (its "
                         "tensor map)")
    out = torch.empty((B, S, C), device=qkv.device, dtype=qkv.dtype)
    rc = _entry(qkv.dtype)(qkv.data_ptr(), out.data_ptr(), B, S, C, heads,
                           float(scale), cuda_build.stream_of(qkv))
    cuda_build.check_launch(rc, "seq_attention")
    cuda_build.count_launch(seq_attention, qkv.dtype, head_dim=d, heads=heads)
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
    """qkv: (B, S, 3C) float32 or bfloat16, channel layout [q heads*d | k |
    v]; returns (B, S, C) of qkv's type in head-major channel order.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel's
    entry for its type (a head dim :func:`kernel_takes_head_dim`) or
    raises, and its gradient recomputes through the plain version."""
    if qkv.device.type == "cpu":
        return seq_attention_plain(qkv, scale, heads)
    return _SeqAttention.apply(qkv, scale, heads)


seq_attention.launches = 0
seq_attention.launches_bf16 = 0
seq_attention.launches_by_head_dim = {}
seq_attention.launches_by_heads = {}


def _entry(dtype: torch.dtype):
    """The C entry of the kernel for ``dtype``, its signature set."""
    lib = cuda_build.load("seq_attention")
    fn = getattr(lib, cuda_build.entry_symbol("sic_seq_attention", dtype))
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
