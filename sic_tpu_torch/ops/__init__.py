"""Hand-written CUDA kernels of the codec and training paths and of the
(G, s, d) window-attention op, each beside its plain PyTorch version.  A
wrapper takes the plain version for CPU tensors and launches its kernel for
CUDA tensors; it counts its launches."""
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


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = ["seq_attention", "seq_attention_plain", "window_attention_nhwc",
           "window_attention_nhwc_plain", "window_attention_nhwc_bwd",
           "window_attention_nhwc_bwd_plain", "window_attention",
           "window_attention_plain", "window_attention_bwd_plain",
           "rans_decode_plane",
           "rans_decode_plane_plain", "rans_encode_plane",
           "rans_encode_plane_plain", "pack_substreams", "split_substreams",
           "KERNEL_WRAPPERS", "launch_counts", "reset_launch_counts"]
