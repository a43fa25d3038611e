"""Shared layers of the port: NHWC convolution, pre-LN transformer blocks,
and the compute-dtype rules the modules share.

Sequences are batch-major ``(B, S, D)`` and feature maps NHWC, as in the
JAX package.  The qkv projection stays packed so the attention kernel reads
``[q | k | v]`` straight from one matmul's output (torch
``nn.MultiheadAttention`` checkpoints map 1:1 onto ``in_proj``/``out_proj``).

Compute dtype apart from storage dtype.  A :class:`Linear` or
:class:`Conv2d` has a compute dtype (``compute_dtype``, f32 unless
:func:`set_compute_dtype` names another) and casts its input, weight and
bias to it on every call, as flax's Dense and Conv do with ``dtype``
set; the gradient flows back through the cast to the stored parameter.
So f32 parameters computed in bf16 are flax's ``dtype=bf16``, and bf16-
stored (frozen) parameters computed in f32 are flax's ``dtype=None`` with
bf16 parameters, where promotion upcasts the kernel.  :func:`cast_compute`
also casts the weights to the compute dtype once, for the serving
runtime's bf16 copy (the same numbers as the cast on every call).
:class:`LayerNorm` and :class:`GroupNorm` normalise in f32 with their
parameters upcast, whatever their storage, and return the input's dtype,
as flax's norms compute their statistics and affine in f32.  Elementwise
steps run in the activation's dtype; positional parameters are cast to it
where the JAX module casts them.  In fp32 every rule is the identity.

Across processes (``parallel/``): a :class:`Linear` split by tensor
parallelism (``tp``: its group and ``"column"`` or ``"row"``) holds this
rank's rows (a column-parallel projection: output features) or columns (a
row-parallel one: input features; its bias is added once, after the
all-reduce); :class:`MultiheadSelfAttention` then runs its local heads.
Under the width split (:func:`~sic_tpu_torch.parallel.collectives.tile_parallel`)
a :class:`Conv2d` exchanges its halo columns with the neighbouring ranks
and a :class:`GroupNorm` takes its statistics over the whole width.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import seq_attention
from ..ops.group_norm import (count_composite, group_norm_nhwc,
                              group_norm_nhwc_plain)
from ..ops.quant import QuantLinear
from ..parallel.collectives import (copy_to_model, reduce_from_model,
                                    tile_group, tile_halo, tile_sum)


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype):
    return None if p is None else p.to(dtype)


def _f32(p: Optional[torch.Tensor]):
    return _cast(p, torch.float32)


class Linear(nn.Linear):
    """nn.Linear in its compute dtype: input, weight and bias cast to it.

    ``sensitive``: the layer stays float in the int8 serving mode (the JAX
    package's ``QDense(..., sensitive=True)``): a projection whose output
    feeds a codebook choice, where a small perturbation flips an index
    (``ops.quant.quantize_linears`` skips it)."""

    compute_dtype = torch.float32
    tp = None       # (model Group, "column" | "row") under tensor parallelism

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 sensitive: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.sensitive = sensitive

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x, w, b = x.to(dt), self.weight.to(dt), _cast(self.bias, dt)
        if self.tp is None:
            return F.linear(x, w, b)
        group, mode = self.tp
        if mode == "column":
            return F.linear(copy_to_model(x, group), w, b)
        return _row_parallel(x, w, b, group)


def _row_parallel(x, w, b, group):
    """A row-parallel projection: the ranks' partial products summed, then
    the bias, once."""
    y = reduce_from_model(F.linear(x, w), group)
    return y if b is None else y + b


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5, the JAX package's, unless ``eps`` names
    another) in f32, its parameters upcast, returning the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, _f32(self.weight),
                            _f32(self.bias), self.eps).to(x.dtype)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Make every Linear, Conv2d and int8 QuantLinear in ``module`` compute
    in ``dtype`` (their parameters keep their storage dtype)."""
    for m in module.modules():
        if isinstance(m, (Linear, Conv2d, QuantLinear)):
            m.compute_dtype = dtype
    return module


def cast_compute(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """:func:`set_compute_dtype`, and cast the weights and biases of every
    Linear and Conv2d in ``module`` to ``dtype`` once (norms, positional
    parameters, codebooks and an int8 QuantLinear's scales and bias keep
    theirs): the serving runtime's copy."""
    for m in set_compute_dtype(module, dtype).modules():
        if isinstance(m, (Linear, Conv2d)):
            m.to(dtype)
    return module


class Conv2d(nn.Conv2d):
    """Convolution on NHWC tensors with torch-layout (OIHW) weights, in its
    compute dtype (input, weight and bias cast to it).

    Padding follows flax's SAME for the odd kernels used here.  A 1x1
    stride-1 convolution runs as a matmul over the channel axis."""

    compute_dtype = torch.float32

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1,
                 stride: int = 1, groups: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=kernel_size // 2 if stride == 1 else 0,
                         groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x, w, b = x.to(dt), self.weight.to(dt), _cast(self.bias, dt)
        if self.kernel_size == (1, 1) and self.stride == (1, 1) \
                and self.groups == 1:
            return F.linear(x, w[:, :, 0, 0], b)
        if tile_group() is None:
            return self.conv_local(x, w, b)
        kw, sw = self.kernel_size[1], self.stride[1]
        if sw == 1:
            # 'same': the neighbours' k//2 columns, then no pad on the width
            p = kw // 2
            return self.conv_local(tile_halo(x, p, p), w, b,
                                   padding=(self.padding[0], 0))
        if self.padding == (0, 0) and kw == sw and x.shape[2] % sw == 0:
            return self.conv_local(x, w, b)      # patches within the slab
        raise ValueError(f"no width split for a {self.kernel_size} conv at "
                         f"stride {self.stride} on a {x.shape[2]}-wide slab")

    def conv_local(self, x, w=None, b=None, padding=None) -> torch.Tensor:
        """The convolution of the NHWC tensor ``x`` as it stands (no halo),
        in the compute dtype (``w``/``b``: already cast)."""
        dt = self.compute_dtype
        if w is None:
            x, w, b = x.to(dt), self.weight.to(dt), _cast(self.bias, dt)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.stride,
                     self.padding if padding is None else padding,
                     self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


def conv_same(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]):
    """A stride-1, zero-padded ('same') convolution of the NHWC tensor
    ``x`` with the OIHW kernel ``w`` (odd), on slabs under the width split."""
    ph, pw = w.shape[2] // 2, w.shape[3] // 2
    if tile_group() is not None:        # the halo stands in for the pad
        x, pw = tile_halo(x, pw, pw), 0
    return F.conv2d(x.permute(0, 3, 1, 2), w, b,
                    padding=(ph, pw)).permute(0, 2, 3, 1)


def _norm_group():
    """The group a GroupNorm takes its statistics over (the tile group)."""
    return tile_group()


class GroupNorm(nn.GroupNorm):
    """GroupNorm over the channel axis of an NHWC tensor, in f32 with its
    parameters upcast, returning the input's dtype; with ``silu`` (no
    parameter) SiLU follows, fused.  On width slabs its mean and variance
    are the whole image's (two passes, each summed over the tile group).

    Which path runs is decided by what the call shows: on width slabs,
    the two passes; with autograd recording (grad mode on and the input,
    weight or bias requiring grad), the plain version, which is
    differentiable; both are PyTorch's composite ops, counted in
    ``ops.group_norm_counts()["composite"]``.  Otherwise
    :func:`~sic_tpu_torch.ops.group_norm_nhwc`: the plain version for a
    CPU tensor and the fused kernel for a CUDA one."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 silu: bool = False):
        super().__init__(num_groups, num_channels, eps=eps)
        self.silu = silu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = _norm_group()
        if group is not None:
            count_composite()
            y = self._split_norm(x, group)
            return F.silu(y) if self.silu else y
        args = (self.weight, self.bias, self.num_groups, self.eps, self.silu)
        if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad
                                        or self.bias.requires_grad):
            count_composite()
            return group_norm_nhwc_plain(x, *args)
        return group_norm_nhwc(x.contiguous(), *args)

    def _split_norm(self, x: torch.Tensor, group) -> torch.Tensor:
        """The norm of a width slab, its statistics summed over ``group``."""
        B, H, W, C = x.shape
        G = self.num_groups
        xf = x.float().reshape(B, H, W, G, C // G)
        n = H * W * group.size * (C // G)
        mean = tile_sum(xf.sum(dim=(1, 2, 4)), group) / n
        d = xf - mean[:, None, None, :, None]
        var = tile_sum((d * d).sum(dim=(1, 2, 4)), group) / n
        y = (d * torch.rsqrt(var + self.eps)[:, None, None, :, None]).reshape(B, H, W, C)
        return (y * _f32(self.weight) + _f32(self.bias)).to(x.dtype)


class Embed(nn.Module):
    """A token-embedding table; its one parameter is named as flax's
    ``nn.Embed`` leaf (``embedding``, (vocab, width))."""

    def __init__(self, num: int, width: int):
        super().__init__()
        self.embedding = nn.Parameter(0.02 * torch.randn(num, width))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding[tokens]


class MultiheadSelfAttention(nn.Module):
    """Packed-qkv self attention: through the sequence-attention kernel,
    or, with an additive ``attn_mask`` (the CLIP text tower's causal mask),
    through plain einsums with f32 logits, as the JAX package does (no
    served path takes the masked branch).  ``qkv_bias=False``: the qkv
    projection has no bias (U-ViT's blocks)."""

    def __init__(self, d_model: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"{d_model} not divisible by {num_heads} heads")
        self.num_heads = num_heads          # this rank's, under ``tp``
        self.head_dim = d_model // num_heads
        self.in_proj = Linear(d_model, 3 * d_model, bias=qkv_bias)
        self.out_proj = Linear(d_model, d_model)

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, S, _ = x.shape
        head_dim = self.head_dim
        inner = self.num_heads * head_dim
        qkv = self.in_proj(x)
        if attn_mask is None:
            out = seq_attention(qkv, head_dim ** -0.5, self.num_heads)
        else:
            q, k, v = (t.reshape(B, S, self.num_heads, head_dim).transpose(1, 2)
                       for t in qkv.split(inner, dim=-1))
            logits = torch.einsum("bhqd,bhkd->bhqk", (q * head_dim ** -0.5).float(),
                                  k.float())
            probs = torch.softmax(logits + attn_mask.float(), dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
            out = out.transpose(1, 2).reshape(B, S, inner)
        return self.out_proj(out)


class MLP(nn.Module):
    """Exact-GELU MLP (torch ``c_fc``/``c_proj`` naming)."""

    def __init__(self, d_model: int, hidden: int):
        super().__init__()
        self.c_fc = Linear(d_model, hidden)
        self.c_proj = Linear(hidden, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block (reference: titok/blocks.py:26-64)."""

    def __init__(self, d_model: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True):
        super().__init__()
        self.ln_1 = LayerNorm(d_model)
        self.attn = MultiheadSelfAttention(d_model, num_heads, qkv_bias)
        self.ln_2 = LayerNorm(d_model)
        self.mlp = MLP(d_model, int(d_model * mlp_ratio))

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), attn_mask)
        return x + self.mlp(self.ln_2(x))
