"""GroupNorm over the channel axis of an NHWC tensor, optionally followed
by SiLU.

CUDA kernel: ``csrc/group_norm.cu``.  It replaces no TPU kernel: the JAX
package leaves GroupNorm and swish to XLA, which fuses them.  Eager
PyTorch ran the same function as an f32 copy, a layout copy, moments,
affine, a cast and a SiLU pass, about 40 bytes an element, in the VQGAN
pixel decoders' 39 norms a decode.  The kernel is bound by bytes: a stats
pass and an apply pass read the input twice and write it once (6 bytes an
element in bf16, 12 in f32), statistics, affine and SiLU in f32, the output
rounded once to the input's dtype, in contiguous NHWC.  No atomics: the
same input gives the same bits.

:func:`group_norm_nhwc_plain` is the same function in plain PyTorch
(``F.group_norm`` on the f32 input, SiLU in f32, one rounding): it serves
CPU tensors and is the kernel's oracle on the card.  Calls are counted in
``group_norm_nhwc.launches``; the callers that keep PyTorch's composite
ops (autograd, the width split: ``models.layers.GroupNorm``) count them in
``group_norm_nhwc.composite`` through :func:`count_composite`.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch
import torch.nn.functional as F

from . import cuda_build

# the kernel's block (csrc/group_norm.cu kThreads)
THREADS = 256
# blocks a pass: four on each of the H100's 132 SMs
TARGET_BLOCKS = 528
# partials an image, each merged again by every apply block of that image
MAX_CHUNKS = 128
# elements a block takes at least: below it the merge of the partials that
# starts every apply block outweighs its streaming
MIN_CHUNK = 16384
# the dtypes the kernel has an entry for
DTYPES = (torch.float32, torch.bfloat16)


def group_norm_nhwc_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, num_groups: int, eps: float,
                          silu: bool = False) -> torch.Tensor:
    """x (B, H, W, C) -> GroupNorm over C (statistics and affine in f32,
    ``weight`` and ``bias`` upcast), SiLU in f32 with ``silu``, rounded
    once to x's dtype."""
    y = F.group_norm(x.float().permute(0, 3, 1, 2), num_groups, weight.float(),
                     bias.float(), eps).permute(0, 2, 3, 1)
    return (F.silu(y) if silu else y).to(x.dtype)


def _vector(dtype: torch.dtype) -> int:
    """Elements of one 16-byte load."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def kernel_takes(C: int, num_groups: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes C channels in ``num_groups`` groups of
    ``dtype``: a row of whole 16-byte vectors, at most one a thread of its
    block, and a group that is whole vectors or a whole share (1/2, 1/4,
    1/8) of one."""
    if dtype not in DTYPES or C <= 0 or num_groups <= 0 or C % num_groups:
        return False
    n, cpg = _vector(dtype), C // num_groups
    return (C % n == 0 and C // n <= THREADS
            and (cpg % n == 0 or n % cpg == 0))


def chunking(B: int, HW: int, C: int, dtype: torch.dtype):
    """(S, P): each image's pixels in S chunks of P (the last may be
    shorter, none empty), a block of each pass a chunk.  About
    TARGET_BLOCKS blocks in all, at most MAX_CHUNKS an image, at least
    MIN_CHUNK elements a chunk where the image holds that many, P a
    multiple of the pixels a block's threads cover at once."""
    rows = THREADS // (C // _vector(dtype))
    S = max(1, min(MAX_CHUNKS, math.ceil(TARGET_BLOCKS / B),
                   math.ceil(HW * C / MIN_CHUNK), math.ceil(HW / rows)))
    P = math.ceil(math.ceil(HW / S) / rows) * rows
    return math.ceil(HW / P), P


def group_norm_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """x: (B, H, W, C) float32 or bfloat16; ``weight``, ``bias``: (C,),
    read as f32.  Returns GroupNorm over C (then SiLU with ``silu``) of
    x's dtype.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (contiguous x, C and groups it
    :func:`kernel_takes`) or raises.  No gradient: the kernel serves
    inference."""
    if x.device.type == "cpu":
        return group_norm_nhwc_plain(x, weight, bias, num_groups, eps, silu)
    cuda_build.require_cuda(x, "x", DTYPES)
    if x.dim() != 4:
        raise ValueError(f"group_norm_nhwc takes (B, H, W, C), got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if not kernel_takes(C, num_groups, x.dtype):
        raise ValueError(f"group_norm_nhwc kernel: {C} {x.dtype} channels in "
                         f"{num_groups} groups (a row of at most {THREADS} "
                         "16-byte vectors, a group whole vectors or a whole "
                         "share of one)")
    if B == 0 or H * W == 0 or B > 65535 or x.data_ptr() % 16:
        raise ValueError(f"group_norm_nhwc kernel: x {tuple(x.shape)} must be "
                         "non-empty, at most 65535 images, and start on a "
                         "16-byte boundary")
    w, b = (p.to(device=x.device, dtype=torch.float32).contiguous()
            for p in (weight, bias))
    if w.shape != (C,) or b.shape != (C,):
        raise ValueError(f"group_norm_nhwc: weight and bias must be ({C},)")
    S, P = chunking(B, H * W, C, x.dtype)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    part = torch.empty((B, S, num_groups, 3), device=x.device, dtype=torch.float32)
    rc = _entry(x.dtype)(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                         part.data_ptr(), B, H * W, C, num_groups, S, P,
                         float(eps), int(silu), cuda_build.stream_of(x))
    cuda_build.check_launch(rc, "group_norm_nhwc")
    cuda_build.count_launch(group_norm_nhwc)
    return y


group_norm_nhwc.launches = 0
group_norm_nhwc.composite = 0
_composite_lock = threading.Lock()


def count_composite() -> None:
    """Add one to ``group_norm_nhwc.composite``: a GroupNorm that ran
    PyTorch's composite ops (under autograd, or on width slabs)."""
    with _composite_lock:
        group_norm_nhwc.composite += 1


def _entry(dtype: torch.dtype):
    """The C entry of the kernel for ``dtype``, its signature set."""
    lib = cuda_build.load("group_norm")
    fn = getattr(lib, cuda_build.entry_symbol("sic_group_norm", dtype))
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
