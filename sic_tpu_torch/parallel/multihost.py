"""Multi-process runs: process discovery, the backend, barriers, and the
data-parallel reductions.

Counterpart of the JAX package's ``parallel/multihost.py`` (reference:
src/compress.py:33-55 env-var rank setup, 206-246 sampler sharding,
293-306 rank-0 barrier + FAISS merge).  ``WORLD_SIZE`` / ``RANK`` select
the process grid and ``MASTER_ADDR`` / ``MASTER_PORT`` the coordinator, the
variables torchrun sets; ``torch.distributed`` takes the place of JAX's
coordination service.

The backend is chosen once, at setup, from the topology, and printed:
NCCL when the process runs on a CUDA device and the host has a card for
each of its ranks; gloo otherwise (ranks sharing one card, and the CPU).
Gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` but not for
point-to-point transfers; the pipeline's own helper (``pipeline.py``)
copies through the host for those.  A call that fails raises: no backend
is swapped for another, and a rank whose peer died ends with an error at
its next collective.

In a data-parallel step every batch mean and batch statistic of the JAX
package's single global batch becomes a mean over the ranks' equal
shares: :func:`global_mean` (differentiable), :func:`all_mean` and
:func:`reduce_grads`, over a :class:`Group`.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import sys
from typing import Any, Iterable, Optional, Tuple

import torch

from ..data import shard_list  # noqa: F401  (the one copy; re-exported)

# generous handshake window: co-scheduled processes on a loaded host can be
# minutes apart reaching the rendezvous (the JAX package's 900 s)
HANDSHAKE_S = 900
# elements of one flat all-reduce of gradients (256 MB of f32)
BUCKET_ELEMS = 1 << 26


def env_world() -> Tuple[int, int, Optional[str]]:
    """(rank, world_size, coordinator) from the torchrun-style environment."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    coordinator = f"{addr}:{port}" if addr and port else None
    return rank, world, coordinator


def resolve_world(rank: Optional[int] = None, world: Optional[int] = None,
                  coordinator: Optional[str] = None
                  ) -> Tuple[int, int, Optional[str]]:
    """(rank, world, coordinator): the arguments, else the environment."""
    env_rank, env_world_size, env_coord = env_world()
    return (env_rank if rank is None else rank,
            env_world_size if world is None else world,
            coordinator or env_coord)


def rank_device(rank: int, device=None) -> str:
    """The device of rank ``rank``: ``device`` when given, else
    ``cuda:(LOCAL_RANK or rank) % device_count`` (``cuda`` without a card,
    which the entry points then refuse)."""
    if device is not None:
        return str(device)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        return "cuda"
    return f"cuda:{int(os.environ.get('LOCAL_RANK', rank)) % n}"


def choose_backend(device, world: int, placed: bool = True) -> Tuple[str, str]:
    """(backend, why): ``nccl`` when ``device`` is a CUDA device, the ranks
    were placed one to a card (``placed``: no explicit device) and the host
    has a card for each of its ranks; else ``gloo``.  The host's rank count
    is ``LOCAL_WORLD_SIZE`` (torchrun sets it); without it, ``world`` when
    the host has that many cards, and a ``ValueError`` otherwise: a
    multi-node launch could not be told from ranks sharing a card."""
    if torch.device(device).type != "cuda":
        return "gloo", "not on a CUDA device"
    if not placed:
        return "gloo", f"the device was named ({device}); ranks may share it"
    cards = torch.cuda.device_count()
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is None:
        if world > cards:
            raise ValueError(
                f"{world} ranks and {cards} CUDA devices on this host: set "
                "LOCAL_WORLD_SIZE (and LOCAL_RANK) to this host's ranks, as "
                "torchrun does, or name each rank's device")
        return "nccl", f"{world} ranks, {cards} CUDA devices"
    if cards >= int(local):
        return "nccl", f"{local} ranks on this host, {cards} CUDA devices"
    return "gloo", f"{local} ranks on this host share {cards} CUDA devices"


def setup_distributed(rank: Optional[int] = None, world: Optional[int] = None,
                      coordinator: Optional[str] = None, device=None,
                      placed: bool = True) -> Tuple[int, int]:
    """Form the process group when world > 1; returns (rank, world).

    A no-op single-process.  ``device``: this rank's device (for the
    backend choice, :func:`choose_backend`).  World > 1 needs a
    coordinator address; the rendezvous waits up to :data:`HANDSHAKE_S`
    for every rank, then raises.  A process already in a group of this
    rank and size keeps it."""
    rank, world, coordinator = resolve_world(rank, world, coordinator)
    if world <= 1:
        return 0, 1
    if coordinator is None:
        raise ValueError(
            "multi-process run needs a coordinator address "
            "(--coordinator or MASTER_ADDR/MASTER_PORT)")
    import torch.distributed as dist
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError(
                f"this process is rank {dist.get_rank()} of "
                f"{dist.get_world_size()} already, not {rank} of {world}")
        return rank, world
    backend, why = choose_backend(device if device is not None else "cuda",
                                  world, placed)
    if backend == "nccl":
        torch.cuda.set_device(torch.device(device))
    print(f"[dist] rank {rank}/{world}: backend {backend} on {device} ({why})",
          file=sys.stderr, flush=True)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=HANDSHAKE_S))
    warmup_collectives(device if backend == "nccl" else "cpu")
    return rank, world


def warmup_collectives(device="cpu") -> None:
    """One all-reduce right after the rendezvous, while the ranks are
    still aligned in time: a backend's first collective sets up its
    connections, and the JAX package saw gloo's key exchange time out when
    that first collective came after minutes of skewed set-up work (a model
    build, a compile) on each rank."""
    import torch.distributed as dist
    t = torch.zeros(1, device=device)
    dist.all_reduce(t)


def distributed() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def global_rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if distributed() else 0


def barrier(tag: str = "sic_tpu_barrier") -> None:
    """Block until every process reaches this point (reference:
    dist.barrier(), compress.py:293).  No-op single-process.  ``tag``
    names the point in the error a dead peer raises."""
    if not distributed():
        return
    import torch.distributed as dist
    try:
        dist.barrier()
    except Exception as e:
        raise RuntimeError(f"barrier {tag!r} failed on rank "
                           f"{dist.get_rank()}: {e}") from e


def shutdown() -> None:
    """Leave the process group (every rank calls it, at the end)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# -- groups of a process grid ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in one axis of the process grid: the process
    group, the global ranks along the axis in order, and this rank's index
    among them."""
    group: Any
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def axis_groups(shape, combos=()) -> dict:
    """This process's :class:`Group` along each axis of the process grid
    ``shape`` (``((name, size), ...)``, the last axis fastest: the global
    rank is the row-major index of the grid position, as the JAX package's
    ``make_mesh`` lays devices out), and along each tuple of axes in
    ``combos`` (key ``"a_b"``: the ranks that share every other axis).  An
    axis (or tuple) of size 1 has no entry; single-process, none has.
    Every rank builds every group, in one order, as
    ``torch.distributed.new_group`` needs."""
    if not distributed():
        return {}
    import torch.distributed as dist
    import numpy as np
    names = [n for n, _ in shape]
    sizes = [int(s) for _, s in shape]
    world, rank = dist.get_world_size(), dist.get_rank()
    if int(np.prod(sizes)) != world:
        raise ValueError(f"{world} processes do not form a "
                         f"{' x '.join(map(str, sizes))} grid {tuple(names)}")
    coords = [np.unravel_index(r, sizes) for r in range(world)]
    mine = {}
    for axes in [(n,) for n in names] + [tuple(c) for c in combos]:
        idx = [names.index(a) for a in axes]
        if int(np.prod([sizes[i] for i in idx])) == 1:
            continue
        lines = {}
        for r, c in enumerate(coords):
            rest = tuple(int(c[i]) for i in range(len(sizes)) if i not in idx)
            lines.setdefault(rest, []).append(r)
        for rest in sorted(lines):
            ranks = tuple(lines[rest])
            g = dist.new_group(list(ranks))
            if rank in ranks:
                mine["_".join(axes)] = Group(g, ranks, ranks.index(rank))
    return mine


def grid_groups(pp: int = 1) -> Tuple[Optional[Group], Optional[Group]]:
    """(data, pipe) groups of the current process on a (world/pp, pp)
    grid, pipe fastest (global rank = d * pp + p), the JAX package's
    ``(data, pipe)`` mesh (:func:`axis_groups`).  An axis of size 1 is
    None."""
    if not distributed():
        return None, None
    import torch.distributed as dist
    world = dist.get_world_size()
    if world % pp:
        raise ValueError(f"{world} processes not divisible by pp={pp}")
    g = axis_groups((("data", world // pp), ("pipe", pp)))
    return g.get("data"), g.get("pipe")


def take_rows(x, data: Optional[Group]):
    """This rank's contiguous block of a global batch (rows
    ``[i * per, (i + 1) * per)``, ``per = ceil(len / size)``); the whole
    batch without a data group.  A short final batch may leave a rank
    fewer rows, or none."""
    if data is None:
        return x
    per = -(-len(x) // data.size)
    return x[data.index * per:(data.index + 1) * per]


def all_mean(t: torch.Tensor, data: Optional[Group]) -> torch.Tensor:
    """The mean of ``t`` over the data group, in place (not differentiated)."""
    if data is not None:
        import torch.distributed as dist
        dist.all_reduce(t, group=data.group)
        t.div_(data.size)
    return t


class _GlobalMean(torch.autograd.Function):
    """Mean over the ranks of the data group, forward and backward.  A loss
    term of every rank that reads the mean gets, in the backward, the mean
    of the ranks' gradients; with gradients averaged over the group after
    the backward, a parameter's gradient is then the one of the global
    batch's loss (the one-process step's)."""

    @staticmethod
    def forward(ctx, t, data):
        ctx.data = data
        return all_mean(t.clone(), data)

    @staticmethod
    def backward(ctx, g):
        return all_mean(g.clone(), ctx.data), None


def global_mean(t: torch.Tensor, data: Optional[Group]) -> torch.Tensor:
    """``t`` (a per-rank mean over equal shares of the global batch) as the
    global batch's mean, differentiably; ``t`` itself without a group."""
    return t if data is None else _GlobalMean.apply(t, data)


def buckets(items, tensor=lambda t: t):
    """``items`` in consecutive lists whose tensors (``tensor(item)``) share
    a dtype and device, each list of at most :data:`BUCKET_ELEMS` elements
    or a single item: the unit of one flat collective."""
    by_kind = {}
    for it in items:
        t = tensor(it)
        by_kind.setdefault((t.dtype, t.device), []).append(it)
    for group in by_kind.values():
        chunk, n = [], 0
        for it in group:
            k = tensor(it).numel()
            if chunk and n + k > BUCKET_ELEMS:
                yield chunk
                chunk, n = [], 0
            chunk.append(it)
            n += k
        if chunk:
            yield chunk


def reduce_grads(params: Iterable[torch.Tensor], data: Optional[Group]) -> None:
    """Average the gradients of ``params`` over the data group (or any
    group whose ranks' gradients are averaged), in :func:`buckets`."""
    if data is None:
        return
    import torch.distributed as dist
    for chunk in buckets([p.grad for p in params if p.grad is not None]):
        flat = torch.cat([g.reshape(-1) for g in chunk])
        dist.all_reduce(flat, group=data.group)
        flat.div_(data.size)
        off = 0
        for g in chunk:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def gather_to_first(obj, group: Optional[Group]):
    """Every rank's ``obj`` (picklable, on the host) as a list on the
    group's first rank, in the group's order; None elsewhere.  Without a
    group: ``[obj]``."""
    if group is None:
        return [obj]
    import torch.distributed as dist
    out = [None] * group.size if group.index == 0 else None
    dist.gather_object(obj, out, dst=group.ranks[0], group=group.group)
    return out
