"""Process grids and the shardings of the JAX package's ``parallel/mesh.py``.

The JAX package builds a device mesh in one process and annotates leaves
with ``PartitionSpec``s; GSPMD inserts the collectives.  The port's grid is
one of processes (:class:`Mesh`: named axes over ``torch.distributed``
groups, rank = row-major grid position, the last axis fastest) and its
shardings are placements of torch tensors that the modules and steps run
explicitly:

- :func:`shard_state` / :func:`shard_batch`: replicated parameters
  (broadcast from rank 0, then checked equal) and a rank's rows of a batch
  over ``data`` and its width slab over ``tile``;
- :func:`fsdp_plan` (``fsdp_sharding``): each leaf of at least 2^16
  elements split on its largest ``data``-divisible dimension, chosen on the
  JAX package's (untransposed) layout, ties to the first, as its rule
  breaks them; :class:`FSDP` keeps a rank's shards of those leaves (and so
  of their Adam moments) between steps, gathers them for a step and
  reduce-scatters their gradients;
- :data:`DEFAULT_TP_RULES` / :func:`tp_plan` (``tp_sharding``): the JAX
  rules in the port's leaf names and torch layouts (a flax kernel's
  ``(None, "model")`` is a torch weight's dim 0); :func:`apply_tp` splits a
  model's attention and MLP blocks head-aligned over ``model``
  (``layers.Linear.tp``);
- :class:`Layout`: a rank's local tensor of a leaf from the one-process
  tensor and back (collective), for checkpoints and deployment files.

Deviation from the JAX package: it splits the packed ``3 d`` qkv
dimension into contiguous halves and lets GSPMD reshard at the head
split; the port gives rank r the heads ``[r H/tp, (r+1) H/tp)`` of q, k and
v, packed ``[q_r | k_r | v_r]``, so the attention kernels read the local
projection's output directly.  A block whose head count (or hidden width)
does not divide by ``tp`` stays replicated, as a non-divisible leaf does in
JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .collectives import all_gather_cat, chunk_of, reduce_scatter_sum
from .multihost import Group, axis_groups, buckets, distributed, take_rows

FSDP_MIN_SIZE = 1 << 16


# -- the grid -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process grid: ``shape`` ((axis, size), ...) and this process's
    :class:`Group` along each axis of size > 1 (``groups``; also
    ``"data_tile"``, the ranks whose gradients are averaged)."""
    shape: Tuple[Tuple[str, int], ...]
    groups: Dict[str, Group]

    def size(self, axis: str) -> int:
        return dict(self.shape).get(axis, 1)

    @property
    def data(self) -> Optional[Group]:
        return self.groups.get("data")

    @property
    def model(self) -> Optional[Group]:
        return self.groups.get("model")

    @property
    def tile(self) -> Optional[Group]:
        return self.groups.get("tile")

    @property
    def grad_group(self) -> Optional[Group]:
        """The ranks that hold the same parameters and average their
        gradients: data and tile together."""
        return self.groups.get("data_tile") or self.data or self.tile


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = ("data", "tile")) -> Mesh:
    """The process grid over the current process group (the JAX
    package's ``make_mesh`` over devices): by default a factor of 2 on
    ``tile`` when the process count is even, the rest on ``data``.  Every
    rank calls it, with the same arguments."""
    import torch.distributed as dist
    n = dist.get_world_size() if distributed() else 1
    if shape is None:
        tile = 2 if n % 2 == 0 and n > 1 else 1
        shape = (n // tile, tile)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} for axes {axis_names}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"{n} processes do not form a {shape} grid")
    grid = tuple(zip(axis_names, (int(s) for s in shape)))
    combos = (("data", "tile"),) if {"data", "tile"} <= set(axis_names) else ()
    return Mesh(grid, axis_groups(grid, combos))


def shard_batch(x, mesh: Optional[Mesh]):
    """This rank's part of a host batch: its rows over ``data`` and, for
    (B, H, W, C) images, its slab of ``W / tile`` columns over ``tile``
    (the JAX package's ``image_sharding``)."""
    if mesh is None:
        return x
    x = take_rows(x, mesh.data)
    tile = mesh.tile
    if tile is not None and getattr(x, "ndim", 0) == 4:
        W = x.shape[2]
        if W % tile.size:
            raise ValueError(f"width {W} does not split over {tile.size} tiles")
        w = W // tile.size
        x = x[:, :, tile.index * w:(tile.index + 1) * w]
    return x


def shard_state(modules: Iterable[nn.Module], group: Optional[Group] = None) -> None:
    """Replicate the parameters and buffers of ``modules`` over ``group``
    (default: every process): broadcast from its first rank, then check
    that every rank holds the same values (a per-tensor f64 sum and sum of
    squares, their maximum against their minimum over the ranks), and
    raise if not."""
    if not distributed():
        return
    import torch.distributed as dist
    g = None if group is None else group.group
    src = 0 if group is None else group.ranks[0]
    tensors = [t for m in modules for t in list(m.parameters()) + list(m.buffers())]
    if not tensors:
        return
    # NCCL takes CUDA tensors only: a host buffer travels through the device
    dev = tensors[0].device
    via_dev = dist.get_backend(g) == "nccl"
    with torch.no_grad():
        for t in tensors:
            if via_dev and t.device != dev:
                tmp = t.data.to(dev)
                dist.broadcast(tmp, src, group=g)
                t.data.copy_(tmp)
            else:
                dist.broadcast(t.data, src, group=g)
    sums = torch.stack([torch.stack([t.detach().double().sum(),
                                     (t.detach().double() ** 2).sum()]).to(dev)
                        for t in tensors]).reshape(-1)
    hi, lo = sums.clone(), -sums
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=g)
    dist.all_reduce(lo, op=dist.ReduceOp.MAX, group=g)
    if not torch.equal(hi, -lo):
        bad = int(torch.nonzero(hi != -lo)[0]) // 2
        raise RuntimeError(f"replicated state differs across ranks "
                           f"(tensor {bad} of {len(tensors)})")


# -- leaf layouts: JAX (flax) against torch ---------------------------------------

def named_leaves(model: nn.Module):
    """(flax key, torch name, owning module, leaf name, parameter)."""
    from ..weights import _owners, flax_key
    for name, mod, leaf, p in _owners(model):
        yield flax_key(name, mod), name, mod, leaf, p


def _flax_dims(mod: nn.Module, leaf: str, ndim: int) -> List[int]:
    """For each dimension of the JAX package's layout of a leaf, the torch
    dimension it is: a Linear's kernel (in, out) is its weight's (1, 0), a
    convolution's HWIO its OIHW's (2, 3, 1, 0)."""
    if leaf == "weight" and isinstance(mod, nn.Linear):
        return [1, 0]
    if leaf == "weight" and isinstance(mod, nn.Conv2d):
        return [2, 3, 1, 0]
    return list(range(ndim))


def _fsdp_dim(shape_flax, dims, n: int, min_size: int, free=None) -> Optional[int]:
    """The JAX rule on the flax layout: the largest ``n``-divisible
    dimension (among ``free``) of a leaf of at least ``min_size``
    elements, the first of equals; as a torch dimension."""
    size = int(np.prod(shape_flax)) if len(shape_flax) else 0
    if n <= 1 or size < min_size:
        return None
    cand = [d for d in range(len(shape_flax))
            if shape_flax[d] % n == 0 and (free is None or d in free)]
    if not cand:
        return None
    return dims[max(cand, key=lambda d: shape_flax[d])]


def fsdp_plan(model: nn.Module, n: int, min_size: int = FSDP_MIN_SIZE
              ) -> Dict[str, Optional[int]]:
    """``fsdp_sharding`` in the port's terms: flax key -> the torch
    dimension split over ``n`` data ranks (None: replicated)."""
    plan = {}
    for key, _name, mod, leaf, p in named_leaves(model):
        dims = _flax_dims(mod, leaf, p.ndim)
        shape = [p.shape[d] for d in dims]
        plan[key] = _fsdp_dim(shape, dims, n, min_size)
    return plan


# the JAX package's DEFAULT_TP_RULES in torch names and layouts: (leaf
# pattern, torch dim split over ``model``); a column-parallel weight splits
# its output rows (dim 0) with its bias, a row-parallel one its input
# columns (dim 1) and keeps its bias whole
DEFAULT_TP_RULES: Tuple[Tuple[str, int], ...] = (
    (r"(^|\.)in_proj\.weight$", 0),
    (r"(^|\.)in_proj\.bias$", 0),
    (r"(^|\.)out_proj\.weight$", 1),
    (r"(^|\.)c_fc\.weight$", 0),
    (r"(^|\.)c_fc\.bias$", 0),
    (r"(^|\.)c_proj\.weight$", 1),
    (r"(^|\.)to_qkv\.weight$", 0),
    (r"(^|\.)to_out\.weight$", 1),
    (r"(^|\.)mlp_fc1\.weight$", 0),
    (r"(^|\.)mlp_fc1\.bias$", 0),
    (r"(^|\.)mlp_fc2\.weight$", 1),
)

# the split blocks: (column Linear, row Linear, parts of the column
# output (3: packed q, k, v), the attribute holding the head count)
_TP_UNITS = {"MultiheadSelfAttention": ("in_proj", "out_proj", 3, "num_heads"),
             "WindowAttention": ("to_qkv", "to_out", 3, "heads"),
             "MLP": ("c_fc", "c_proj", 1, None),
             "SwinBlock": ("mlp_fc1", "mlp_fc2", 1, None),
             "ConvNeXtBlock": ("mlp_fc1", "mlp_fc2", 1, None)}


def _tp_units(model: nn.Module, n: int):
    """(module name, module, column, row, parts, heads attr) of every block
    whose heads (attention) or hidden width (MLP) divide by ``n``."""
    for name, mod in model.named_modules():
        unit = _TP_UNITS.get(type(mod).__name__)
        if unit is None or n <= 1:
            continue
        col, row, parts, heads = unit
        width = getattr(mod, heads) if heads else getattr(mod, col).out_features
        if width % n == 0:
            yield name, mod, col, row, parts, heads


def tp_plan(model: nn.Module, n: int, fsdp_n: int = 1,
            min_size: int = FSDP_MIN_SIZE) -> Dict[str, Tuple[Optional[int], Optional[int]]]:
    """``tp_sharding`` in the port's terms: flax key -> (torch dim split
    over ``n`` model ranks, torch dim split over ``fsdp_n`` data ranks),
    each None where unsplit.  A split leaf's FSDP dim is the largest of its
    free dimensions (JAX's ``fsdp_axis``); any other leaf takes
    :func:`fsdp_plan`'s rule when ``fsdp_n`` > 1."""
    split = {}
    for name, mod, col, row, _parts, _heads in _tp_units(model, n):
        for lin in (col, row):
            for leaf, _ in getattr(mod, lin).named_parameters():
                tname = ".".join(x for x in (name, lin, leaf) if x)
                if _rule_dim(tname) is not None:
                    split[tname] = _rule_dim(tname)
    plan = {}
    for key, tname, mod, leaf, p in named_leaves(model):
        dims = _flax_dims(mod, leaf, p.ndim)
        shape = [p.shape[d] for d in dims]
        tp = split.get(tname)
        if tp is None:
            plan[key] = (None, _fsdp_dim(shape, dims, fsdp_n, min_size))
        else:
            free = [i for i, d in enumerate(dims) if d != tp]
            plan[key] = (tp, _fsdp_dim(shape, dims, fsdp_n, min_size, free))
    return plan


def _tp_split(t: torch.Tensor, dim: int, parts: int, group: Group) -> torch.Tensor:
    """Rank r's block of each of the ``parts`` equal parts of ``dim``."""
    n, r = group.size, group.index
    k = t.shape[dim] // (parts * n)
    return t.unflatten(dim, (parts, n, k)).select(dim + 1, r).flatten(dim, dim + 1)


def _tp_join(t: torch.Tensor, dim: int, parts: int, group: Group) -> torch.Tensor:
    """Inverse of :func:`_tp_split`, over the model group (collective)."""
    every = all_gather_cat(t.unsqueeze(0), group, 0)   # (n, ...)
    k = t.shape[dim] // parts
    every = every.unflatten(dim + 1, (parts, k))       # (n, .., parts, k, ..)
    return every.movedim(0, dim + 1).flatten(dim, dim + 2).contiguous()


def apply_tp(model: nn.Module, group: Optional[Group]) -> Dict[str, Tuple[int, int]]:
    """Split ``model``'s blocks head-aligned over the model ``group`` in
    place: each column projection keeps this rank's output rows (of each of
    q, k, v), each row projection the matching input columns, and the
    attention its local heads.  Returns torch name -> (dim, parts) of every
    split parameter."""
    split = {}
    if group is None:
        return split
    for name, mod, col, row, parts, heads in list(_tp_units(model, group.size)):
        pre = f"{name}." if name else ""
        c, r = getattr(mod, col), getattr(mod, row)
        with torch.no_grad():
            c.weight.data = _tp_split(c.weight.data, 0, parts, group).clone()
            split[f"{pre}{col}.weight"] = (0, parts)
            if c.bias is not None:
                c.bias.data = _tp_split(c.bias.data, 0, parts, group).clone()
                split[f"{pre}{col}.bias"] = (0, parts)
            r.weight.data = _tp_split(r.weight.data, 1, 1, group).clone()
            split[f"{pre}{row}.weight"] = (1, 1)
        c.tp, r.tp = (group, "column"), (group, "row")
        if heads:
            setattr(mod, heads, getattr(mod, heads) // group.size)
    return split


# -- FSDP ------------------------------------------------------------------------

def _flat_rows(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` as (n, numel / n): row r is rank r's chunk of ``dim``."""
    return t.movedim(dim, 0).reshape(n, -1)


class FSDP:
    """ZeRO-3 over a data group: between steps each planned parameter
    holds this rank's chunk of its planned dimension (so do its Adam
    moments, which the optimizer makes in the parameter's shape);
    :meth:`unshard` gathers the whole tensors for a step (all of them at
    once: the JAX package's GSPMD gathers them per use), and
    :meth:`reshard` reduce-scatters their gradients (the mean over the
    group) and puts the chunks back.  Gathers and reduce-scatters go in
    :func:`~.multihost.buckets` of :data:`~.multihost.BUCKET_ELEMS`."""

    def __init__(self, named: Iterable[Tuple[str, nn.Parameter]],
                 dims: Dict[str, Optional[int]], group: Group):
        self.group = group
        self.leaves = [(name, p, dims[name]) for name, p in named
                       if dims.get(name) is not None]
        self.dims = {name: d for name, _, d in self.leaves}
        with torch.no_grad():
            for _, p, d in self.leaves:
                p.data = chunk_of(p.data, group, d).clone()
        self._chunks = None

    @property
    def whole(self) -> bool:
        return self._chunks is not None

    def unshard(self) -> None:
        """Whole parameters for a step (a no-op when they are whole)."""
        if self.whole:
            return
        n = self.group.size
        self._chunks = [p.data for _, p, _ in self.leaves]
        for _, p, _ in self.leaves:
            p.grad = None           # the last step's, chunk-shaped, consumed
        for chunk in buckets([(p, d) for _, p, d in self.leaves],
                             lambda pd: pd[0].data):
            flat = torch.cat([p.data.movedim(d, 0).reshape(-1) for p, d in chunk])
            every = all_gather_cat(flat.unsqueeze(0), self.group, 0)   # (n, total)
            off = 0
            for p, d in chunk:
                moved = p.data.movedim(d, 0)
                k = moved.numel()
                whole = every[:, off:off + k].reshape(
                    (n * moved.shape[0],) + tuple(moved.shape[1:]))
                p.data = whole.movedim(0, d).contiguous()
                off += k

    def reshard(self, reduce: bool = True) -> None:
        """Each gradient's chunk of its mean over the group (``reduce``),
        and the parameters back to their chunks."""
        if not self.whole:
            return
        n = self.group.size
        with_grad = [(p, d) for _, p, d in self.leaves if p.grad is not None]
        grads = {}
        for chunk in buckets(with_grad if reduce else [], lambda pd: pd[0].grad):
            flat = torch.cat([_flat_rows(p.grad, d, n) for p, d in chunk], 1)
            mine = reduce_scatter_sum(flat, self.group, 0).reshape(-1).div_(n)
            off = 0
            for p, d in chunk:
                moved = p.grad.movedim(d, 0)
                k = p.grad.numel() // n
                shape = (moved.shape[0] // n,) + tuple(moved.shape[1:])
                grads[id(p)] = mine[off:off + k].reshape(shape).movedim(0, d).contiguous()
                off += k
        for (_, p, _), c in zip(self.leaves, self._chunks):
            p.grad = None
            p.data = c
            p.grad = grads.get(id(p))
        self._chunks = None


# -- local <-> one-process tensors --------------------------------------------------

@dataclasses.dataclass
class Layout:
    """How each split leaf of a rank relates to the one-process tensor:
    ``tp`` name -> (dim, parts) over ``model``, then ``fsdp`` name -> dim
    over ``data``.  Names are a state dict's keys."""
    tp: Dict[str, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    fsdp: Dict[str, int] = dataclasses.field(default_factory=dict)
    model: Optional[Group] = None
    data: Optional[Group] = None

    def __bool__(self) -> bool:
        return bool(self.tp or self.fsdp)

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The one-process tensor of leaf ``name`` from this rank's ``t``
        (collective over the groups that split it; every rank calls it for
        the same names in the same order)."""
        if name in self.fsdp:
            t = all_gather_cat(t, self.data, self.fsdp[name])
        if name in self.tp:
            dim, parts = self.tp[name]
            t = _tp_join(t, dim, parts, self.model)
        return t

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's tensor of leaf ``name`` from the one-process ``t``."""
        if name in self.tp:
            dim, parts = self.tp[name]
            t = _tp_split(t, dim, parts, self.model)
        if name in self.fsdp:
            t = chunk_of(t, self.data, self.fsdp[name])
        return t.clone() if (name in self.tp or name in self.fsdp) else t

    @contextlib.contextmanager
    def whole_params(self, named: Iterable[Tuple[str, nn.Parameter]]):
        """The parameters ``named`` (name, parameter) hold their one-process
        tensors inside the block, their local ones again after it."""
        named = [(n, p) for n, p in named if n in self.tp or n in self.fsdp]
        kept = [p.data for _, p in named]
        with torch.no_grad():
            for n, p in named:
                p.data = self.full(n, p.data)
        try:
            yield
        finally:
            for (_, p), d in zip(named, kept):
                p.data = d


def state_bytes(modules: Iterable[nn.Module], optimizers=()) -> int:
    """Bytes of the parameters of ``modules`` and of the tensors in the
    optimizers' states, as this rank holds them."""
    total = sum(p.numel() * p.element_size() for m in modules for p in m.parameters())
    for opt in optimizers:
        for st in opt.state.values():
            total += sum(v.numel() * v.element_size() for v in st.values()
                         if isinstance(v, torch.Tensor) and v.dim() > 0)
    return total


def param_names(module: nn.Module, prefix: str = "") -> Dict[int, str]:
    """id(parameter) -> its state-dict name (with ``prefix``)."""
    return {id(p): prefix + n for n, p in module.named_parameters()}


def _rule_dim(name: str) -> Optional[int]:
    """The DEFAULT_TP_RULES dim of a torch leaf name (None: no rule)."""
    for pat, dim in DEFAULT_TP_RULES:
        if re.search(pat, name):
            return dim
    return None
