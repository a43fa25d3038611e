"""Collectives with autograd, and the width split's context.

The JAX package annotates shardings and lets GSPMD insert the collectives;
the port writes them out.  Three kinds:

- ``model`` (tensor parallelism, Megatron's pair): :func:`copy_to_model`
  is the identity forward and an all-reduce of the gradient backward (the
  input of a column-parallel projection); :func:`reduce_from_model` is an
  all-reduce forward and the identity backward (the output of a
  row-parallel projection).  Every rank of the group holds the same
  activations and the same gradients of them outside the split blocks.
- ``data`` (FSDP): :func:`all_gather_cat` and :func:`reduce_scatter_sum`
  on plain tensors, between steps (no autograd).
- ``tile`` (the width split): :func:`tile_halo`, :func:`tile_gather`,
  :func:`tile_scatter`, :func:`tile_shift`, :func:`tile_sum` and
  :func:`tile_mean`.  Each rank holds a slab of ``W / tile`` columns of
  every image-shaped activation.  Gradients follow one rule: every rank
  seeds its (replicated) loss with 1 and a parameter's gradient is the
  mean of the ranks' (:func:`~.multihost.reduce_grads` over the data and
  tile ranks together).  A tensor every rank holds alike then has the
  mean of the ranks' gradients as its gradient, and a slab (held by one
  rank) ``tile`` times its gradient.  So each op's backward is its adjoint
  under that reading: the gather's is a reduce-scatter of sums, an
  all-reduce's an all-reduce, a halo's the return of the halo's gradient
  to its owner, a shift's the opposite shift, and the scatter's the
  gathered slab gradients over ``tile``, the same on every rank (not the
  zero-padded slab, which is the same mean: a replicated region's backward
  may gate on the sign of its gradient, as the bottleneck's lower bound
  does, and must see the whole one).  Compute that runs replicated after a
  gather is then counted once, whatever the rank count.

Gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` only; every
other collective of a gloo group on a CUDA tensor goes through the host,
on every call (:func:`_host_staged`), never as a retry after an error.

The width split is switched on for a block of code by :func:`tile_parallel`
and off inside :func:`no_tile` (a region whose inputs were gathered);
:func:`tile_group` is what the layers read.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch

from .multihost import Group

_STATE = threading.local()


# -- plumbing -------------------------------------------------------------------

def _host_staged(t: torch.Tensor, group: Group) -> bool:
    """True when ``group`` runs gloo and ``t`` is on a CUDA device: then a
    collective other than all-reduce and broadcast copies through the
    host."""
    import torch.distributed as dist
    return t.is_cuda and dist.get_backend(group.group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (a new tensor; ``t`` itself without
    a group)."""
    if group is None:
        return t
    import torch.distributed as dist
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, group=group.group)
    return out


def all_gather_cat(t: torch.Tensor, group: Optional[Group], dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (one shape on every rank) concatenated along
    ``dim`` in the group's order."""
    if group is None:
        return t
    import torch.distributed as dist
    src = t.detach().movedim(dim, 0).contiguous()
    staged = _host_staged(src, group)
    if staged:
        src = src.cpu()
    out = src.new_empty((group.size * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group.group)
    return out.to(t.device).movedim(0, dim).contiguous()


def reduce_scatter_sum(t: torch.Tensor, group: Optional[Group], dim: int = 0) -> torch.Tensor:
    """This rank's chunk (``dim`` split into ``group.size`` equal parts) of
    the sum of ``t`` over the ranks."""
    if group is None:
        return t
    import torch.distributed as dist
    src = t.detach().movedim(dim, 0).contiguous()
    if src.shape[0] % group.size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split in "
                         f"{group.size}")
    staged = _host_staged(src, group)
    if staged:
        src = src.cpu()
    out = src.new_empty((src.shape[0] // group.size,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group.group)
    return out.to(t.device).movedim(0, dim).contiguous()


def chunk_of(t: torch.Tensor, group: Optional[Group], dim: int) -> torch.Tensor:
    """This rank's equal chunk of ``t`` along ``dim`` (a view)."""
    if group is None:
        return t
    n = t.shape[dim] // group.size
    if n * group.size != t.shape[dim]:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split in "
                         f"{group.size}")
    return t.narrow(dim, group.index * n, n)


# -- tensor parallelism over ``model`` -------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient backward."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """All-reduce forward, identity backward."""
    return x if group is None else _ReduceFromModel.apply(x, group)


# -- the width split over ``tile`` -----------------------------------------------

def tile_group() -> Optional[Group]:
    """The tile group the layers split the width over here (None: none)."""
    return getattr(_STATE, "tile", None)


@contextlib.contextmanager
def tile_parallel(group: Optional[Group]):
    """Run the block with image-shaped activations split over ``group``'s
    ranks along the width (None: unsplit)."""
    prev = tile_group()
    _STATE.tile = group
    try:
        yield
    finally:
        _STATE.tile = prev


def no_tile():
    """A block whose inputs were gathered: the layers run unsplit in it."""
    return tile_parallel(None)


class _TileSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def tile_sum(x: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    """The sum of the ranks' ``x`` over the tile group (default: the
    current one), differentiable."""
    group = group if group is not None else tile_group()
    return x if group is None else _TileSum.apply(x, group)


def tile_mean(x: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    """The mean over the tile group of the ranks' ``x``: a mean over a
    slab becomes the image's (the slabs are equal)."""
    group = group if group is not None else tile_group()
    return x if group is None else _TileSum.apply(x, group) / group.size


class _TileGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_sum(g, ctx.group, ctx.dim), None, None


class _TileScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.shape = group, dim, x.shape
        return chunk_of(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, ctx.dim) / ctx.group.size, None, None


def tile_gather(x: torch.Tensor, group: Optional[Group] = None, dim: int = 2):
    """The whole width of the slabs ``x`` (NHWC: ``dim`` 2) on every rank."""
    group = group if group is not None else tile_group()
    return x if group is None else _TileGather.apply(x, group, dim)


def tile_scatter(x: torch.Tensor, group: Optional[Group] = None, dim: int = 2):
    """This rank's slab of a whole-width ``x`` every rank holds."""
    group = group if group is not None else tile_group()
    return x if group is None else _TileScatter.apply(x, group, dim)


def _neighbours_strips(strip: torch.Tensor, group: Group):
    """Every rank's ``strip`` (one shape on all ranks), as a list."""
    return list(all_gather_cat(strip.unsqueeze(0), group, 0).unbind(0))


class _TileHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, left, right, dim):
        ctx.group, ctx.lr, ctx.dim, ctx.W = group, (left, right), dim, x.shape[dim]
        W, r, n = x.shape[dim], group.index, group.size
        if left > W or right > W:
            raise ValueError(f"halo ({left}, {right}) wider than the slab {W}")
        # what my neighbours need of me: my first `right` columns (for the
        # left neighbour) and my last `left` columns (for the right one)
        strip = torch.cat([x.narrow(dim, 0, right), x.narrow(dim, W - left, left)], dim)
        strips = _neighbours_strips(strip, group)
        shape = list(x.shape)
        parts = []
        if left:
            shape[dim] = left
            parts.append(strips[r - 1].narrow(dim, right, left) if r > 0
                         else x.new_zeros(shape))
        parts.append(x)
        if right:
            shape[dim] = right
            parts.append(strips[r + 1].narrow(dim, 0, right) if r < n - 1
                         else x.new_zeros(shape))
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        (left, right), dim, W = ctx.lr, ctx.dim, ctx.W
        group, r, n = ctx.group, ctx.group.index, ctx.group.size
        # the halo's gradients go back to their owners
        strip = torch.cat([g.narrow(dim, 0, left), g.narrow(dim, left + W, right)], dim)
        strips = _neighbours_strips(strip, group)
        gx = g.narrow(dim, left, W).clone()
        if left and r < n - 1:      # my right neighbour's left halo is my tail
            gx.narrow(dim, W - left, left).add_(strips[r + 1].narrow(dim, 0, left))
        if right and r > 0:         # my left neighbour's right halo is my head
            gx.narrow(dim, 0, right).add_(strips[r - 1].narrow(dim, left, right))
        return gx, None, None, None, None


def tile_halo(x: torch.Tensor, left: int, right: int,
              group: Optional[Group] = None, dim: int = 2) -> torch.Tensor:
    """The slab ``x`` widened by ``left`` columns of the left neighbour's
    and ``right`` of the right neighbour's (zeros past the image's edges,
    a convolution's zero padding)."""
    group = group if group is not None else tile_group()
    if group is None or not (left or right):
        return x
    return _TileHalo.apply(x, group, left, right, dim)


class _TileShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift, dim):
        ctx.group, ctx.shift, ctx.dim = group, shift, dim
        return _shift(x, group, shift, dim)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift, ctx.dim), None, None, None


def _shift(x, group, shift, dim):
    W, r, n = x.shape[dim], group.index, group.size
    s = abs(shift)
    if s > W:
        raise ValueError(f"shift {shift} wider than the slab {W}")
    if shift < 0:       # roll left: my tail comes from the right neighbour's head
        strips = _neighbours_strips(x.narrow(dim, 0, s), group)
        return torch.cat([x.narrow(dim, s, W - s), strips[(r + 1) % n]], dim)
    strips = _neighbours_strips(x.narrow(dim, W - s, s), group)
    return torch.cat([strips[(r - 1) % n], x.narrow(dim, 0, W - s)], dim)


def tile_roll(x: torch.Tensor, shift: int, group: Optional[Group] = None,
              dim: int = 2) -> torch.Tensor:
    """``torch.roll(x, shift, dim)`` of the whole width, on the slabs:
    cyclic across the ranks (``|shift|`` at most a slab)."""
    group = group if group is not None else tile_group()
    if group is None:
        return torch.roll(x, shifts=shift, dims=dim)
    return x if shift == 0 else _TileShift.apply(x, group, shift, dim)


def run_gathered(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """``fn`` on the whole width: the slab ``x`` gathered, ``fn`` run
    unsplit (the same on every rank of the tile group), and its result cut
    back to this rank's slab.  Without a tile group, ``fn(x)``."""
    group = tile_group()
    if group is None:
        return fn(x)
    with no_tile():
        out = fn(tile_gather(x, group))
    return tile_scatter(out, group)
