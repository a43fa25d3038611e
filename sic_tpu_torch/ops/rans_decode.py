"""rANS plane decode for many substreams on the device.

CUDA kernel: ``csrc/rans_decode.cu`` (replaces the TPU kernel
``sic_tpu/ops/rans_decode.py::_decode_kernel``), one block of one warp per
substream, its table, indexes and stream bytes staged in shared memory.
It runs once per step of the 4-step autoregressive h-stream decode, so the
decode never leaves the device between the prior CNN and the
reconstruction.  Bit-exact to the native decoder
(``cpp/sic_rans.cc:146-229``).

Host framing (:func:`split_substreams`, :func:`pack_substreams`) turns a
framed stream into per-substream word rows; :func:`rans_decode_plane_plain`
is the decode in plain PyTorch, vectorised over substreams: it serves CPU
tensors and is the kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from . import cuda_build
from .rans_tables import kernel_table_args

_PROB_BITS = 16
_MASK16 = (1 << _PROB_BITS) - 1
_RANS_L = 1 << 23
_BYPASS_BITS = 2
_BYPASS_MAX = (1 << _BYPASS_BITS) - 1


# -- host-side stream framing -------------------------------------------------

def split_substreams(stream: bytes) -> List[bytes]:
    """Parse the multi-substream container into per-part byte strings
    (format: cpp/sic_rans.cc sic_dec_set_stream)."""
    if len(stream) < 1:
        raise ValueError("empty rANS stream")
    flag = stream[0]
    nstreams = (flag >> 4) + 1
    per_header = 2 if (flag & 0x0F) == 1 else 4
    off = 1
    if off + (nstreams - 1) * per_header > len(stream):
        raise ValueError("truncated rANS substream header")
    sizes = []
    for _ in range(nstreams - 1):
        sizes.append(int.from_bytes(stream[off:off + per_header], "little"))
        off += per_header
    if off + sum(sizes) > len(stream):
        raise ValueError("inconsistent rANS substream sizes")
    sizes.append(len(stream) - off - sum(sizes))
    parts = []
    for sz in sizes:
        parts.append(stream[off:off + sz])
        off += sz
    return parts


def pack_substreams(parts: Sequence[bytes]):
    """Pad part byte strings into one word matrix + lengths + initial
    decoder states, one row per substream.

    Returns numpy ``(words (S, nwords) uint32, lengths (S, 1) int32,
    state (S, 2) int64)``: ``state[:, 0]`` is the rANS state from the first
    4 little-endian bytes and ``state[:, 1]`` the next byte position (4).
    (The JAX package pads rows to 8 and words to a power of two for its
    TPU kernel's tiling and compile cache; the CUDA kernel needs neither.)"""
    S = len(parts)
    max_len = max((len(p) for p in parts), default=4)
    nwords = max(1, -(-max_len // 4))
    words = np.zeros((S, nwords), dtype=np.uint32)
    lengths = np.zeros((S, 1), dtype=np.int32)
    state = np.zeros((S, 2), dtype=np.int64)
    for i, p in enumerate(parts):
        if len(p) < 4:
            # the native decoder rejects truncated substreams too
            raise ValueError(f"substream {i} is {len(p)} bytes; rANS needs >= 4")
        padded = np.zeros(nwords * 4, dtype=np.uint8)
        padded[:len(p)] = np.frombuffer(p, dtype=np.uint8)
        words[i] = padded.view("<u4")
        lengths[i, 0] = len(p)
        state[i, 0] = int.from_bytes(p[:4], "little")
        state[i, 1] = 4
    return words, lengths, state


def words_tensor(words: np.ndarray, device=None) -> torch.Tensor:
    """uint32 word matrix -> int32 tensor holding the same bits."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(device)


# -- plain version ------------------------------------------------------------

def rans_decode_plane_plain(idx, words, lengths, state, cdf, sizes, offsets):
    """Decode one plane for S substreams; same arguments and results as
    :func:`rans_decode_plane`.  Loops over positions, vectorised over
    substreams, with every C++ loop of the decoder run until no substream
    needs another pass."""
    S, npos = idx.shape
    ncdf, width = cdf.shape
    dev = idx.device
    ar = torch.arange(S, device=dev)
    stream = words.contiguous().view(torch.uint8).reshape(S, -1).long()
    nbytes = stream.shape[1]
    lens = lengths.reshape(-1).long()
    x = state[:, 0].long().clone()
    pos = state[:, 1].long().clone()
    cdf64, sizes64, offs64 = cdf.long(), sizes.long(), offsets.long()
    cols = torch.arange(width, device=dev)
    out = torch.zeros((S, npos), dtype=torch.int32, device=dev)

    def refill(lanes):
        nonlocal x, pos
        need = lanes & (x < _RANS_L) & (pos < lens)
        byte = stream[ar, pos.clamp(max=nbytes - 1)]
        x = torch.where(need, (x << 8) | byte, x)
        pos = torch.where(need, pos + 1, pos)
        return need

    def raw_bits(lanes):
        nonlocal x
        val = x & _BYPASS_MAX
        x = torch.where(lanes, x >> _BYPASS_BITS, x)
        refill(lanes)
        return val

    for i in range(npos):
        ci = idx[:, i].long()
        live = (ci >= 0) & (ci < ncdf)
        cic = ci.clamp(0, ncdf - 1)
        row = cdf64[cic]                                   # (S, width)
        size = sizes64[cic]
        cum = x & _MASK16
        in_range = (cols >= 1) & (cols <= (size - 1)[:, None])
        s = ((row <= cum[:, None]) & in_range).sum(dim=1)
        start = row.gather(1, s[:, None]).squeeze(1)
        nxt = row.gather(1, (s + 1).clamp(max=width - 1)[:, None]).squeeze(1)
        x = torch.where(live, (nxt - start) * (x >> _PROB_BITS)
                        + (x & _MASK16) - start, x)
        while bool(refill(live).any()):
            pass
        value = s
        esc = live & (s == size - 2)
        if bool(esc.any()):
            val = raw_bits(esc)
            n_bypass = torch.where(esc, val, torch.zeros_like(val))
            more = esc & (val == _BYPASS_MAX)
            while bool(more.any()):
                val = raw_bits(more)
                n_bypass = torch.where(more, n_bypass + val, n_bypass)
                more = more & (val == _BYPASS_MAX)
            raw_val = torch.zeros_like(x)
            j = 0
            more = esc & (n_bypass > 0)
            while bool(more.any()):
                val = raw_bits(more)
                if j < 32 // _BYPASS_BITS:
                    raw_val = torch.where(more, raw_val | (val << (_BYPASS_BITS * j)),
                                          raw_val)
                j += 1
                more = esc & (n_bypass > j)
            half = raw_val >> 1
            esc_value = torch.where((raw_val & 1) == 1, -half - 1, half + size - 2)
            value = torch.where(esc, esc_value, value)
        out[:, i] = torch.where(live, value + offs64[cic],
                                torch.zeros_like(value)).to(torch.int32)
    return out, torch.stack([x, pos], dim=1)


# -- kernel wrapper -----------------------------------------------------------

def rans_decode_plane(idx, words, lengths, state, cdf, sizes, offsets):
    """Decode one symbol plane for S independent substreams.

    Args (all tensors on one device):
      idx:     (S, npos) int32 CDF-row indexes (< 0: skipped position).
      words:   (S, nwords) int32, the little-endian stream bytes' bits.
      lengths: (S,) or (S, 1) int32 byte length of each substream.
      state:   (S, 2) int64 decoder state (x, byte position).
      cdf:     (ncdf, width) int32 quantized CDF rows.
      sizes:   (ncdf,) int32 per-row CDF lengths.
      offsets: (ncdf,) int32 per-row symbol offsets.

    Returns ``(symbols (S, npos) int32, new_state (S, 2) int64)``.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (one
    block a substream; rows of at most 128 entries) or raise."""
    if idx.device.type == "cpu":
        return rans_decode_plane_plain(idx, words, lengths, state, cdf,
                                       sizes, offsets)
    S, npos = idx.shape
    ncdf = cdf.shape[0]
    lengths = lengths.reshape(-1)
    for name, t, dt in (("idx", idx, torch.int32), ("words", words, torch.int32),
                        ("lengths", lengths, torch.int32),
                        ("state", state, torch.int64), ("cdf", cdf, torch.int32),
                        ("sizes", sizes, torch.int32),
                        ("offsets", offsets, torch.int32)):
        cuda_build.require_cuda(t, name, dt)
    if words.shape[0] != S or lengths.shape[0] != S or \
            tuple(state.shape) != (S, 2) or sizes.numel() != ncdf or \
            offsets.numel() != ncdf:
        raise ValueError("rans_decode_plane: inconsistent argument shapes")
    cdf_p, sizes_p, offsets_p, stride = kernel_table_args(cdf, sizes, offsets)
    sym = torch.empty((S, npos), dtype=torch.int32, device=idx.device)
    new_state = torch.empty((S, 2), dtype=torch.int64, device=idx.device)
    lib = _lib()
    rc = lib.sic_rans_decode_plane(
        idx.data_ptr(), words.data_ptr(), lengths.data_ptr(),
        state.data_ptr(), cdf_p, sizes_p, offsets_p, sym.data_ptr(),
        new_state.data_ptr(), S, npos, words.shape[1], ncdf, stride,
        cuda_build.stream_of(idx))
    cuda_build.check_launch(rc, "rans_decode_plane")
    rans_decode_plane.launches += 1
    return sym, new_state


rans_decode_plane.launches = 0


def _lib():
    lib = cuda_build.load("rans_decode")
    fn = lib.sic_rans_decode_plane
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
