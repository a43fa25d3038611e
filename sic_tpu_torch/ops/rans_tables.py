"""The CDF table as the rANS kernels take it: one packed block.

Both kernels (``csrc/rans_decode.cu``, ``csrc/rans_encode.cu``) copy the
whole table into shared memory with one bulk copy, and the decode's lanes
read 4 entries of a row with one 16-byte load.  So the rows are padded to
a stride that is a multiple of 4 and laid out back to back with the sizes
and offsets, in one 16-byte-aligned allocation padded to 16 bytes.  Each
row's entries past its size hold 0xffffffff, above every cum, so the
decode's count over a lane's 4 entries needs no mask.  The wrappers pass
the block's three parts as the kernel's ``cdf``, ``sizes`` and ``offsets``
and the stride as its ``width``; callers keep passing the plain
``(ncdf, width)`` table.  One packed copy is kept per table tensor and
rebuilt when any of the three tensors is replaced or written to; one lock
guards the cache, since concurrent decodes (``decode_only_many``) look it
up, prune it and insert into it from several threads.

The kernels take quantized CDFs as the coder builds them
(``entropy/tables.py``): every row strictly increasing from 0 to 1 << 16
over its ``size`` >= 2 entries.  The plain versions take any table; a
table the kernels cannot take raises ``ValueError`` here.
"""
from __future__ import annotations

import threading
import weakref

import torch

MAX_STRIDE = 128   # 32 lanes x 4 entries: a row fills at most one warp

_cache: dict = {}
_cache_lock = threading.Lock()


def packed_stride(width: int) -> int:
    return -(-width // 4) * 4


def check_table(cdf: torch.Tensor, sizes: torch.Tensor) -> None:
    """Raise unless every row is a quantized CDF: 2 <= size <= width,
    row[0] = 0, row[size - 1] = 1 << 16, strictly increasing between."""
    rows, size = cdf.long().cpu(), sizes.reshape(-1).long().cpu()
    width = rows.shape[1]
    cols = torch.arange(width)
    inside = cols[None, :] < size[:, None]
    step_ok = (rows[:, 1:] > rows[:, :-1]) | ~inside[:, 1:]
    last = rows.gather(1, (size - 1).clamp(0, width - 1)[:, None])[:, 0]
    ok = ((size >= 2) & (size <= width) & (rows[:, 0] == 0)
          & (last == 1 << 16) & step_ok.all(1))
    if not bool(ok.all()):
        bad = int((~ok).nonzero()[0, 0])
        raise ValueError(f"CDF row {bad} is not a quantized CDF (strictly "
                         f"increasing from 0 to 65536 over 2 <= size <= "
                         f"{width} entries): the rANS kernels cannot take it")


def _pack(cdf: torch.Tensor, sizes: torch.Tensor, offsets: torch.Tensor):
    check_table(cdf, sizes)
    ncdf, width = cdf.shape
    stride = packed_stride(width)
    total = -(-ncdf * (stride + 2) // 4) * 4
    block = torch.zeros(total, dtype=torch.int32, device=cdf.device)
    inside = (torch.arange(stride, device=cdf.device)[None, :]
              < sizes.reshape(-1, 1))
    rows = torch.full((ncdf, stride), -1, dtype=torch.int32, device=cdf.device)
    rows[:, :width] = cdf
    block[:ncdf * stride] = torch.where(inside, rows, -1).reshape(-1)
    block[ncdf * stride:ncdf * (stride + 1)] = sizes.reshape(-1)
    block[ncdf * (stride + 1):ncdf * (stride + 2)] = offsets.reshape(-1)
    return block, stride


def packed_tables(cdf: torch.Tensor, sizes: torch.Tensor,
                  offsets: torch.Tensor):
    """``(block, stride)`` for the table ``cdf`` (ncdf, width) with its
    ``sizes`` and ``offsets``: the packed copy, built on first use and
    kept while the three tensors live unchanged."""
    width = cdf.shape[1]
    if packed_stride(width) > MAX_STRIDE:
        raise ValueError(f"CDF rows of {width} entries: the rANS kernels take "
                         f"at most {MAX_STRIDE}")
    srcs = (cdf, sizes, offsets)
    versions = tuple(t._version for t in srcs)
    with _cache_lock:
        hit = _cache.get(id(cdf))
        if hit is not None:
            refs, vers, block, stride = hit
            if all(r() is t for r, t in zip(refs, srcs)) and vers == versions:
                return block, stride
        block, stride = _pack(cdf, sizes, offsets)
        for key in [k for k, v in _cache.items() if v[0][0]() is None]:
            del _cache[key]
        _cache[id(cdf)] = (tuple(weakref.ref(t) for t in srcs), versions,
                           block, stride)
    return block, stride


def kernel_table_args(cdf, sizes, offsets):
    """The kernel's ``cdf, sizes, offsets`` pointers and ``width`` for the
    packed copy of this table."""
    block, stride = packed_tables(cdf, sizes, offsets)
    ncdf = cdf.shape[0]
    base = block.data_ptr()
    return (base, base + 4 * ncdf * stride, base + 4 * ncdf * (stride + 1),
            stride)
