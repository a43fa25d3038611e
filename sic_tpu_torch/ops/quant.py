"""W8A8 dynamic-quantized Linear: the serving runtime's int8 mode.

Counterpart of the JAX package's ``ops/quant.py``.  A :class:`QuantLinear`
holds its weight pre-quantized (``weight_q`` int8 in Linear's ``(out, in)``
layout, ``weight_s`` a per-output-channel f32 scale), quantizes its input
per row at call time (symmetric abs-max), multiplies int8 by int8 into an
int32 accumulator and rescales in f32.  :func:`quantize_linears` turns every
``layers.Linear`` of a module tree that is not ``sensitive`` into one, from
the f32 weights, as ``quantize_dense_tree`` rewrites the JAX tree.

The product.  The JAX package leaves it to XLA's ``dot_general``
(``sic_tpu/ops/quant.py:99``), outside any Pallas kernel, so it is no TPU
kernel to port: :func:`int8_mm` runs ``torch._int_mm`` on a CUDA tensor,
cuBLASLt's int8 tensor-core GEMM (``weight_q.t()``, column-major, is the
operand layout it takes without a copy).  CUDA's ``_int_mm`` takes more
than 16 rows and a depth and width that are multiples of 8, so the wrapper
pads with zero rows and columns, which leaves every sum exact (the codec's
``decoder_embed`` has a depth of 12, a small request fewer than 17 rows).
A shape it cannot make valid raises; it never falls back to a float
product.  On the CPU the product is ``torch._int_mm`` too, an exact integer
product (an f32 one would not be: ``|acc|`` reaches 127^2 * 4096, past
2^24).  :func:`int8_mm_plain` is the same integer function written out.

The per-row quantization and the rescale stay plain PyTorch, as the JAX
package leaves them to XLA.  Under ``jit`` XLA computes the row scale
``max(amax, 1e-12) / 127`` as a product with the f32 reciprocal of 127 (a
division by a constant), and so does :func:`quantize_rows`: a one-ulp
different scale would move ``x / x_s`` and, at a ``.5`` tie, flip one
``x_q``.  (XLA's CPU backend also fuses the rescale's last product and the
bias add into one FMA; the port rounds the product first, which moves the
output by at most an ulp and no ``x_q``.)
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

QUANT_MODES = (None, "int8")

# CUDA ``_int_mm``'s shape rule: more than 16 rows; depth and width
# multiples of 8
INT_MM_MIN_ROWS = 17
INT_MM_ALIGN = 8
# the deepest product whose int32 accumulator cannot overflow (127 * 127 a term)
MAX_DEPTH = (2 ** 31 - 1) // (127 * 127)
# 1 / 127 rounded to f32: XLA's rewrite of the division by the constant 127
INV_127 = float(np.float32(1.0) / np.float32(127.0))

_count_lock = threading.Lock()


def resolve_quant(quant) -> Optional[str]:
    """``None`` or ``"none"`` -> None (float), ``"int8"`` -> ``"int8"``;
    anything else raises."""
    if quant in (None, "none"):
        return None
    if quant not in QUANT_MODES:
        raise ValueError(f"quant {quant!r}: one of none, int8")
    return quant


def quantize_kernel(w: np.ndarray):
    """Symmetric per-output-column int8 quantization of a flax-layout
    ``(in, out)`` kernel (the JAX package's function, in numpy).  All-zero
    columns (the zero-init ``zero_add`` gates) get scale 1 and weights 0,
    which reproduces the float output exactly."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=0)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale


def _check_operands(x_q: torch.Tensor, w_q: torch.Tensor) -> None:
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8_mm takes int8 operands, not {x_q.dtype} and {w_q.dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"int8_mm: x_q (M, K) and w_q (N, K), not "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    M, K = x_q.shape
    if M == 0 or K == 0 or w_q.shape[0] == 0:
        raise ValueError(f"int8_mm: empty operand {tuple(x_q.shape)} x "
                         f"{tuple(w_q.shape)}")
    if K > MAX_DEPTH:
        raise ValueError(f"int8_mm: depth {K} could overflow the int32 "
                         f"accumulator (at most {MAX_DEPTH})")
    if x_q.device != w_q.device:
        raise ValueError(f"int8_mm: operands on {x_q.device} and {w_q.device}")


def int8_mm_plain(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``x_q (M, K) @ w_q (N, K).T`` as int32, the integer math written out:
    the f64 product of int8 values is exact (every partial sum is an
    integer below 2^31, far inside f64's 2^53), on the CPU and the card."""
    _check_operands(x_q, w_q)
    return (x_q.double() @ w_q.double().t()).to(torch.int32)


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pad_for_int_mm(x_q: torch.Tensor, w_q: torch.Tensor):
    """``(x_q, w_q)`` zero-padded to CUDA ``_int_mm``'s shape rule: at
    least 17 rows of x_q, a depth K and a width N (w_q's rows) that are
    multiples of 8.  Zero rows and columns add nothing to any sum; the
    product's first M rows and N columns are the unpadded product."""
    M, K = x_q.shape
    N = w_q.shape[0]
    Mp, Kp, Np = max(M, INT_MM_MIN_ROWS), _pad_to(K, INT_MM_ALIGN), _pad_to(N, INT_MM_ALIGN)
    a = x_q if (Mp, Kp) == (M, K) else F.pad(x_q, (0, Kp - K, 0, Mp - M))
    b = w_q if (Np, Kp) == (N, K) else F.pad(w_q, (0, Kp - K, 0, Np - N))
    return a.contiguous(), b.contiguous()


def int8_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``x_q (M, K) @ w_q (N, K).T`` -> (M, N) int32, exactly.  A CPU
    tensor takes ``torch._int_mm``'s CPU product; a CUDA tensor cuBLASLt's
    int8 GEMM through ``torch._int_mm`` (:func:`pad_for_int_mm` first),
    counted in ``int8_mm.launches``.  An operand it cannot take raises."""
    _check_operands(x_q, w_q)
    if x_q.device.type == "cpu":
        return torch._int_mm(x_q, w_q.t())
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_mm: no product for {x_q.device}")
    M, N = x_q.shape[0], w_q.shape[0]
    a, b = pad_for_int_mm(x_q, w_q)
    acc = torch._int_mm(a, b.t())
    with _count_lock:
        int8_mm.launches += 1
    return acc if acc.shape == (M, N) else acc[:M, :N]


int8_mm.launches = 0


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantization of ``x`` in f32, as XLA computes
    the JAX ``QuantDense``'s under ``jit``: ``x_s = max(amax, 1e-12) *
    f32(1/127)`` (its rewrite of the division by the constant), ``x_q =
    clip(round_half_even(x / x_s), -127, 127)``.  Returns (x_q int8, x_s
    f32 with a trailing axis of 1)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    x_s = torch.clamp_min(amax, 1e-12) * INV_127
    x_q = torch.clamp(torch.round(xf / x_s), -127.0, 127.0).to(torch.int8)
    return x_q, x_s


class QuantLinear(nn.Module):
    """int8-weight Linear with per-row dynamic activation quantization (the
    JAX package's ``QuantDense``)::

        x_s = max(max|x| per row, 1e-12) / 127;  x_q = round(x / x_s)  (int8)
        out = (x_q @ weight_q.T) * x_s * weight_s + bias              (int32 acc)

    computed in f32 and returned in ``compute_dtype`` (f32, or the bf16 of
    a bf16 runtime, as ``QuantDense(dtype=...)``).  Its tensors are
    buffers: it serves, it does not train."""

    compute_dtype = torch.float32

    def __init__(self, weight_q: torch.Tensor, weight_s: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        if weight_q.dtype != torch.int8 or weight_q.dim() != 2:
            raise ValueError(f"weight_q: int8 (out, in), not {weight_q.dtype} "
                             f"{tuple(weight_q.shape)}")
        self.out_features, self.in_features = weight_q.shape
        self.register_buffer("weight_q", weight_q.contiguous())
        self.register_buffer("weight_s", weight_s.float().contiguous())
        self.register_buffer("bias", None if bias is None else bias.float().contiguous())

    @classmethod
    def from_linear(cls, linear: nn.Linear) -> "QuantLinear":
        """Quantize an f32 Linear (weight (out, in)) as ``quantize_kernel``
        quantizes its flax kernel (in, out)."""
        w = linear.weight.detach()
        q, s = quantize_kernel(w.float().cpu().numpy().T)
        bias = None if linear.bias is None else linear.bias.detach().float().clone()
        return cls(torch.from_numpy(np.ascontiguousarray(q.T)).to(w.device),
                   torch.from_numpy(s).to(w.device), bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_q, x_s = quantize_rows(x)
        lead = x_q.shape[:-1]
        acc = int8_mm(x_q.reshape(-1, self.in_features), self.weight_q)
        out = acc.reshape(*lead, self.out_features).float() * x_s * self.weight_s
        if self.bias is not None:
            out = out + self.bias
        return out.to(self.compute_dtype)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}")


def quantize_linears(module: nn.Module) -> nn.Module:
    """Replace, in place, every ``layers.Linear`` of ``module`` that is not
    ``sensitive`` by a :class:`QuantLinear` of its weights (the JAX
    package's ``quantize_dense_tree``, whose 2-D kernels are exactly its
    Dense layers).  Convolutions, norms, codebooks and the sensitive
    Linears stay as they are.  Returns ``module``."""
    from ..models.layers import Linear
    for name, child in list(module.named_children()):
        if isinstance(child, Linear):
            if not child.sensitive:
                setattr(module, name, QuantLinear.from_linear(child))
        else:
            quantize_linears(child)
    return module
