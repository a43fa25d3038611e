"""Hand-written CUDA kernels of the codec and training paths and of the
(G, s, d) window-attention op, each beside its plain PyTorch version.  A
wrapper takes the plain version for CPU tensors and launches its kernel for
CUDA tensors; it counts its launches.  ``quant`` holds the int8 mode's
W8A8 Linear, whose product is cuBLASLt's int8 GEMM (``int8_mm``, counted
apart: it ports no TPU kernel); ``group_norm`` the VQGAN decoders' fused
NHWC GroupNorm + SiLU (counted apart too, by :func:`group_norm_counts`:
it ports no TPU kernel)."""
from .group_norm import group_norm_nhwc, group_norm_nhwc_plain
from .quant import (QuantLinear, int8_mm, int8_mm_plain, quantize_kernel,
                    quantize_linears)
from .rans_decode import (pack_substreams, rans_decode_plane,
                          rans_decode_plane_plain, split_substreams)
from .rans_encode import rans_encode_plane, rans_encode_plane_plain
from .seq_attention import seq_attention, seq_attention_plain
from .window_attention import (window_attention, window_attention_bwd_plain,
                               window_attention_nhwc, window_attention_nhwc_bwd,
                               window_attention_nhwc_bwd_plain,
                               window_attention_nhwc_plain,
                               window_attention_plain)

KERNEL_WRAPPERS = {
    "seq_attention": seq_attention,
    "window_attention_nhwc": window_attention_nhwc,
    "window_attention_nhwc_bwd": window_attention_nhwc_bwd,
    "rans_decode_plane": rans_decode_plane,
    "rans_encode_plane": rans_encode_plane,
    "window_attention": window_attention,
}


# the wrappers whose kernel has a bf16 entry beside the f32 one
BF16_ENTRIES = ("seq_attention", "window_attention_nhwc",
                "window_attention_nhwc_bwd", "window_attention")


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def bf16_launch_counts() -> dict:
    """Launches of the bf16 entries since the last
    :func:`reset_launch_counts` (included in :func:`launch_counts`)."""
    return {name: KERNEL_WRAPPERS[name].launches_bf16 for name in BF16_ENTRIES}


def head_dim_launch_counts() -> dict:
    """Kernel 1's launches since the last :func:`reset_launch_counts`, by
    head dim (included in :func:`launch_counts`)."""
    return dict(seq_attention.launches_by_head_dim)


# the wrappers that count their launches by head count too
HEADS_COUNTED = ("seq_attention", "window_attention_nhwc", "window_attention_nhwc_bwd")


def heads_launch_counts() -> dict:
    """Launches since the last :func:`reset_launch_counts` of the attention
    kernels that take packed qkv, by head count (a tensor-parallel rank's
    are its local heads)."""
    return {name: dict(KERNEL_WRAPPERS[name].launches_by_heads)
            for name in HEADS_COUNTED}


def group_norm_counts() -> dict:
    """GroupNorms since the last :func:`reset_launch_counts`: ``launches``
    of the kernel and ``composite`` calls that ran PyTorch's ops (under
    autograd, or on width slabs)."""
    return {"launches": group_norm_nhwc.launches,
            "composite": group_norm_nhwc.composite}


def reset_launch_counts() -> None:
    int8_mm.launches = 0
    group_norm_nhwc.launches = 0
    group_norm_nhwc.composite = 0
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    for name in BF16_ENTRIES:
        KERNEL_WRAPPERS[name].launches_bf16 = 0
    seq_attention.launches_by_head_dim.clear()
    for name in HEADS_COUNTED:
        KERNEL_WRAPPERS[name].launches_by_heads.clear()


__all__ = ["seq_attention", "seq_attention_plain", "window_attention_nhwc",
           "window_attention_nhwc_plain", "window_attention_nhwc_bwd",
           "window_attention_nhwc_bwd_plain", "window_attention",
           "window_attention_plain", "window_attention_bwd_plain",
           "rans_decode_plane",
           "rans_decode_plane_plain", "rans_encode_plane",
           "rans_encode_plane_plain", "pack_substreams", "split_substreams",
           "KERNEL_WRAPPERS", "BF16_ENTRIES", "launch_counts",
           "bf16_launch_counts", "head_dim_launch_counts",
           "heads_launch_counts", "HEADS_COUNTED",
           "reset_launch_counts", "QuantLinear", "int8_mm", "int8_mm_plain",
           "quantize_kernel", "quantize_linears", "group_norm_nhwc",
           "group_norm_nhwc_plain", "group_norm_counts"]
