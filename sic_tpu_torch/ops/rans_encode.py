"""rANS plane encode for many substreams on the device.

CUDA kernel: ``csrc/rans_encode.cu`` (replaces the TPU kernel
``sic_tpu/ops/rans_encode.py::_encode_kernel``), one block per substream:
producer warps expand each chunk of positions into coding operations in
shared memory and one warp walks them.  It runs once per plane of
the bottleneck's device encode, last plane first, so the symbol and index
planes never leave the device: only the finished entropy-coded bytes do.
Byte-exact to the native encoder (``cpp/sic_rans.cc:40-135``).

Rows are in forward position order, one per substream, with the per-part
split of the native coder (:func:`split_plane_rows`); the kernel walks each
row from its end, since rANS encodes last in, first out.  The emission
buffer is an int32 ``(S, nwords)`` tensor whose bytes each substream fills
in emission order; :func:`finalize_streams` reverses them on the host and
:func:`frame_substreams` frames each image's substreams into one stream.
:func:`rans_encode_plane_plain` is the encode in plain PyTorch, vectorised
over substreams: it serves CPU tensors and is the kernel's oracle on the
card.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import cuda_build
from .rans_tables import kernel_table_args

_PROB_BITS = 16
_RANS_L = 1 << 23
_BYPASS_BITS = 2
_BYPASS_MAX = (1 << _BYPASS_BITS) - 1
_MAX_CHUNKS = 16   # 2-bit chunks of a uint32 bypass value


# -- host side ----------------------------------------------------------------

def encode_buffer_words(npos_per_part: int, word_bucket: int = 512) -> int:
    """Emission-buffer width: 2 bytes per position, pow2-bucketed (the JAX
    package's policy, which keeps its compiled-shape set small)."""
    bucket = max(1, word_bucket)
    need = max(1, -(-npos_per_part * 2 // 4))
    while bucket < need:
        bucket *= 2
    return bucket


def split_plane_rows(plane_sym: torch.Tensor, plane_idx: torch.Tensor,
                     nparts: int):
    """(B, n) planes -> (B*nparts, n//nparts) per-part rows matching the
    native coder's contiguous part split (sic_rans.cc:297-308).  Unlike the
    JAX package's rows these stay in forward order: the kernel walks them
    from the end.  Requires ``n % nparts == 0``."""
    B, n = plane_sym.shape
    if n % nparts:
        raise ValueError(f"plane of {n} positions does not split into "
                         f"{nparts} substreams")
    each = n // nparts
    return (plane_sym.reshape(B * nparts, each),
            plane_idx.reshape(B * nparts, each))


def frame_substreams(parts: Sequence[bytes]) -> bytes:
    """Multi-substream container framing (sic_rans.cc:310-343): the flag
    byte carries the part count and header width; the last part's size is
    implied by the total."""
    nparts = len(parts)
    maximum = max((len(p) for p in parts[:-1]), default=0)
    per_header = 4 if maximum > 65535 else 2
    out = bytearray()
    out.append(((nparts - 1) << 4) + (1 if per_header == 2 else 0))
    for p in parts[:-1]:
        out += len(p).to_bytes(per_header, "little")
    for p in parts:
        out += p
    return bytes(out)


def finalize_streams(words: np.ndarray, meta: np.ndarray,
                     nstreams: int) -> Optional[List[bytes]]:
    """Fetched ``(S, nwords)`` emission rows + ``(S, 4)`` state -> per-
    substream byte strings ``LE32(x) + emitted bytes reversed``
    (sic_rans.cc:111-133).  Returns None if any real row overflowed."""
    if np.any(meta[:nstreams, 2] != 0):
        return None
    out = []
    raw = words.view(np.uint8).reshape(words.shape[0], -1)
    for i in range(nstreams):
        x = int(meta[i, 0])
        n = int(meta[i, 1])
        out.append(int.to_bytes(x, 4, "little") + bytes(raw[i, :n][::-1]))
    return out


def initial_state(S: int, device=None) -> torch.Tensor:
    """(S, 4) int64 encoder state before the last plane: x = L, cursor 0,
    no overflow."""
    st = torch.zeros((S, 4), dtype=torch.int64, device=device)
    st[:, 0] = _RANS_L
    return st


# -- plain version ------------------------------------------------------------

def rans_encode_plane_plain(sym, idx, words, state, cdf, sizes, offsets):
    """Encode one plane for S substreams; same arguments and results as
    :func:`rans_encode_plane`.  Everything that depends only on the symbols
    and indexes is computed for the whole plane at once; then a loop over
    positions, last to first, vectorised over substreams, runs the state
    updates.  A substream that overflows its row stops there, as in the
    kernel."""
    S, npos = idx.shape
    ncdf, width = cdf.shape
    dev = idx.device
    ar = torch.arange(S, device=dev)
    buf = words.view(torch.uint8).view(S, -1)
    cap = buf.shape[1]
    x = state[:, 0].clone()
    pos = state[:, 1].clone()
    ov = state[:, 2] != 0

    # state-independent part, whole plane: (S, npos)
    ci = idx.long()
    live = (ci >= 0) & (ci < ncdf)
    cic = ci.clamp(0, ncdf - 1)
    max_value = sizes.long()[cic] - 2
    value = sym.long() - offsets.long()[cic]
    neg = value < 0
    over = ~neg & (value >= max_value)
    esc = live & (neg | over)
    raw_val = torch.where(neg, -2 * value - 1,
                          torch.where(over, 2 * (value - max_value),
                                      torch.zeros_like(value)))
    slot = torch.where(neg | over, max_value, value).clamp(0, width - 2)
    row = cdf.long()[cic]
    lo = row.gather(2, slot[..., None]).squeeze(2)
    hi = row.gather(2, (slot + 1)[..., None]).squeeze(2)
    start = lo & 0xFFFF
    freq = (hi - lo) & 0xFFFF
    shifts = torch.arange(_MAX_CHUNKS, device=dev) * _BYPASS_BITS
    n_bypass = ((raw_val[..., None] >> shifts) != 0).sum(-1)
    n_bypass = torch.where(esc, n_bypass, torch.zeros_like(n_bypass))
    raw = live & (freq == 0)                 # a uint16 range of 0: raw bits
    esc_host = esc.any(0).cpu().numpy()
    raw_host = raw.any(0).cpu().numpy()
    nb_max = int(n_bypass.max()) if esc_host.any() else 0

    def emit_while(lanes, x_max):
        """Renormalise: emit low bytes while x >= x_max (at most twice)."""
        nonlocal x, pos, ov
        for _ in range(2):
            go = lanes & ~ov & (x >= x_max)
            full = go & (pos >= cap)
            ov = ov | full
            go = go & ~full
            at = ar * cap + pos.clamp(max=cap - 1)
            flat = buf.view(-1)
            flat[at] = torch.where(go, (x & 0xFF).to(torch.uint8), flat[at])
            pos = torch.where(go, pos + 1, pos)
            x = torch.where(go, x >> 8, x)

    def put_raw(lanes, val):
        nonlocal x
        emit_while(lanes, 1 << 29)
        x = torch.where(lanes & ~ov, (x << _BYPASS_BITS) | val, x)

    for i in range(npos - 1, -1, -1):
        if esc_host[i]:
            e, nb, rv = esc[:, i], n_bypass[:, i], raw_val[:, i]
            for j in range(nb_max - 1, -1, -1):
                put_raw(e & (j < nb), (rv >> (_BYPASS_BITS * j)) & _BYPASS_MAX)
            put_raw(e, nb % _BYPASS_MAX)
            for t in range(nb_max // _BYPASS_MAX):
                put_raw(e & (t < nb // _BYPASS_MAX), torch.full_like(x, _BYPASS_MAX))
        lv, st, fr = live[:, i], start[:, i], freq[:, i]
        if raw_host[i]:
            put_raw(raw[:, i], st)
        sy = lv & (fr != 0)
        frs = torch.where(sy, fr, torch.ones_like(fr))
        emit_while(sy, frs << 15)
        x = torch.where(sy & ~ov, ((x // frs) << _PROB_BITS) + x % frs + st, x)
    new_state = torch.stack([x, pos, ov.long(), torch.zeros_like(x)], dim=1)
    return words, new_state


# -- kernel wrapper -----------------------------------------------------------

def rans_encode_plane(sym, idx, words, state, cdf, sizes, offsets):
    """Encode one symbol plane for S independent substreams.

    Args (all tensors on one device):
      sym:     (S, npos) int32 symbols, forward position order.
      idx:     (S, npos) int32 CDF-row indexes (< 0: skipped position).
      words:   (S, nwords) int32 emission buffer, written in place.
      state:   (S, 4) int64 encoder state (x, byte cursor, overflow, 0):
               :func:`initial_state` before the last plane, then threaded
               through the calls from the last plane to the first.
      cdf:     (ncdf, width) int32 quantized CDF rows.
      sizes:   (ncdf,) int32 per-row CDF lengths.
      offsets: (ncdf,) int32 per-row symbol offsets.

    Returns ``(words, new_state)``.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (one block a substream; rows of at most
    128 entries) or raise."""
    if idx.device.type == "cpu":
        return rans_encode_plane_plain(sym, idx, words, state, cdf, sizes,
                                       offsets)
    S, npos = idx.shape
    ncdf = cdf.shape[0]
    for name, t, dt in (("sym", sym, torch.int32), ("idx", idx, torch.int32),
                        ("words", words, torch.int32),
                        ("state", state, torch.int64), ("cdf", cdf, torch.int32),
                        ("sizes", sizes, torch.int32),
                        ("offsets", offsets, torch.int32)):
        cuda_build.require_cuda(t, name, dt)
    if tuple(sym.shape) != (S, npos) or words.shape[0] != S or \
            tuple(state.shape) != (S, 4) or sizes.numel() != ncdf or \
            offsets.numel() != ncdf:
        raise ValueError("rans_encode_plane: inconsistent argument shapes")
    cdf_p, sizes_p, offsets_p, stride = kernel_table_args(cdf, sizes, offsets)
    new_state = torch.empty((S, 4), dtype=torch.int64, device=idx.device)
    lib = _lib()
    rc = lib.sic_rans_encode_plane(
        sym.data_ptr(), idx.data_ptr(), cdf_p, sizes_p, offsets_p,
        words.data_ptr(), state.data_ptr(), new_state.data_ptr(), S, npos,
        4 * words.shape[1], ncdf, stride, cuda_build.stream_of(idx))
    cuda_build.check_launch(rc, "rans_encode_plane")
    rans_encode_plane.launches += 1
    return words, new_state


rans_encode_plane.launches = 0


def _lib():
    lib = cuda_build.load("rans_encode")
    fn = lib.sic_rans_encode_plane
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
