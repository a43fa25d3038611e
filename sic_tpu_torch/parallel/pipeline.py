"""GPipe pipeline parallelism over processes, and the stacked-trunk layouts.

Counterpart of the JAX package's ``parallel/pipeline.py``.  There a trunk's
per-layer parameters are stacked on a leading axis, sharded over a
``pipe`` mesh axis, and ``shard_map`` runs the GPipe schedule with
``ppermute``.  Here each stage is a process of a ``pipe`` group
(:class:`~.multihost.Group`) that holds only its own layers' modules; the
schedule is the same: ``M`` microbatches (default: one a stage), ``M + P -
1`` steps in which stage ``p`` runs microbatch ``t - p``, a bubble of
``(P - 1) / (P - 1 + M)``, activations one hop down the stages.

:func:`spmd_pipeline` is one differentiable op, replicated in and out over
the group as the JAX op is with its masked ``psum``: every stage passes the
same input; the last stage's output is broadcast to every stage.  Its
backward runs the reverse schedule: each stage keeps its microbatches'
inputs and graphs from the forward, backpropagates the output gradient it
receives, and sends its input gradient one hop back; stage 0's input
gradient is broadcast, so the replicated autograd upstream is the same on
every stage.

Point-to-point transfers go through :func:`_send` / :func:`_recv`: under
gloo, which takes no CUDA tensor for ``send``/``recv``, they copy through
the host explicitly (ranks sharing one card); under NCCL they send the
device tensor.

The layout functions (:func:`stack_trunk`, :func:`stack_hybrid_cells`,
:func:`unstack_hybrid_cells`, :func:`codec_params_stack`,
:func:`codec_params_canonicalize`) convert flat ``params/...`` dicts of
numpy arrays between the port's named layout (``transformer_{i}``,
``inter_blocks_{i}``, ``feat_blocks_{i}``) and the JAX package's stacked
``trunk_cells`` layout, for a checkpoint that came from a JAX ``--pp``
run.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def bubble_fraction(n_stages: int, n_microbatch: int) -> float:
    """Share of a stage's steps that idle: ``(P - 1) / (P - 1 + M)``."""
    return (n_stages - 1) / (n_stages - 1 + n_microbatch)


def _gloo(group) -> bool:
    import torch.distributed as dist
    return dist.get_backend(group.group) == "gloo"


def _send(t: torch.Tensor, dst: int, group, tag: int):
    """Post a send of ``t`` to global rank ``dst``; returns (work, buffer)
    to wait on.  Gloo sends a host copy."""
    import torch.distributed as dist
    buf = t.detach().contiguous()
    if buf.is_cuda and _gloo(group):
        buf = buf.cpu()
    return dist.isend(buf, dst, group=group.group, tag=tag), buf


def _recv(like: torch.Tensor, src: int, group, tag: int) -> torch.Tensor:
    """Receive a tensor shaped as ``like`` from global rank ``src`` onto
    ``like``'s device (under gloo through a host buffer)."""
    import torch.distributed as dist
    host = like.is_cuda and _gloo(group)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if host else like.device)
    dist.recv(buf, src, group=group.group, tag=tag)
    return buf.to(like.device) if host else buf


def _broadcast(ts, src_index: int, group):
    import torch.distributed as dist
    for t in ts:
        dist.broadcast(t, group.ranks[src_index], group=group.group)
    return ts


def _split(xs, m: int):
    for a in xs:
        if a.shape[0] % m:
            raise ValueError(f"leading dim {a.shape[0]} not divisible by "
                             f"{m} microbatches")
    return [a.split(a.shape[0] // m) for a in xs]


class _Schedule:
    """One pipeline call: the stage's function and where it sits."""

    def __init__(self, stage_fn, group, n_microbatch):
        self.stage_fn, self.group = stage_fn, group
        self.P = group.size if group is not None else 1
        self.p = group.index if group is not None else 0
        self.M = n_microbatch or self.P
        self.saved = None

    def forward(self, xs, keep_graph: bool):
        P, p, M, grp = self.P, self.p, self.M, self.group
        mbs = _split(xs, M)
        outs, saved, pending = [None] * M, [None] * M, []
        for t in range(M + P - 1):
            m = t - p
            if not 0 <= m < M:
                continue            # the bubble
            like = tuple(mb[m] for mb in mbs)
            inp = like if p == 0 else tuple(
                _recv(a, grp.ranks[p - 1], grp, 8 * m + i)
                for i, a in enumerate(like))
            if keep_graph:
                inp = tuple(a.detach().requires_grad_(a.is_floating_point())
                            for a in inp)
                with torch.enable_grad():
                    out = tuple(self.stage_fn(inp))
                saved[m] = (inp, out)
            else:
                out = tuple(self.stage_fn(inp))
            if p < P - 1:
                pending += [_send(o, grp.ranks[p + 1], grp, 8 * m + i)
                            for i, o in enumerate(out)]
            else:
                outs[m] = tuple(o.detach() for o in out)
        for work, _ in pending:
            work.wait()
        self.saved = saved
        if p == P - 1:
            result = [torch.cat([o[i] for o in outs]) for i in range(len(xs))]
        else:
            result = [torch.empty_like(a) for a in xs]
        return tuple(_broadcast(result, P - 1, grp) if P > 1 else result)

    def backward(self, grads):
        P, p, M, grp = self.P, self.p, self.M, self.group
        g_mbs = _split(grads, M)
        in_grads, pending = [None] * M, []
        base = 8 * M
        for m in reversed(range(M)):
            inp, out = self.saved[m]
            g = tuple(gm[m] for gm in g_mbs) if p == P - 1 else tuple(
                _recv(o, grp.ranks[p + 1], grp, base + 8 * m + i)
                for i, o in enumerate(out))
            pairs = [(o, gi) for o, gi in zip(out, g) if o.requires_grad]
            if pairs:
                torch.autograd.backward([o for o, _ in pairs],
                                        [gi for _, gi in pairs])
            ig = tuple(a.grad if a.grad is not None else torch.zeros_like(a)
                       for a in inp)
            if p > 0:
                pending += [_send(a, grp.ranks[p - 1], grp, base + 8 * m + i)
                            for i, a in enumerate(ig)]
            else:
                in_grads[m] = ig
        for work, _ in pending:
            work.wait()
        self.saved = None
        if p == 0:
            result = [torch.cat([ig[i] for ig in in_grads])
                      for i in range(len(grads))]
        else:
            result = [torch.empty_like(g) for g in grads]
        return tuple(_broadcast(result, 0, grp) if P > 1 else result)


class _PipelineOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, anchor, *xs):
        ctx.sched = sched
        return sched.forward(xs, keep_graph=True)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + ctx.sched.backward(grads)


def spmd_pipeline(stage_fn: Callable, x: Sequence[torch.Tensor], group=None,
                  n_microbatch: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """Run the carry ``x`` (a tuple of tensors whose leading dims split
    into ``n_microbatch`` equal microbatches, default one a stage) through
    the stages of ``group`` (:class:`~.multihost.Group`; None: one stage
    in this process), GPipe-scheduled.  ``stage_fn(carry) -> carry`` applies
    this process's stage and keeps the carry's shapes.  Every stage passes
    the same ``x`` and gets the last stage's output; differentiable when
    gradients are enabled (the stage's parameters get their gradients in
    the op's backward, every stage's input gradient is stage 0's)."""
    sched = _Schedule(stage_fn, group, n_microbatch)
    if not torch.is_grad_enabled():
        return sched.forward(tuple(x), keep_graph=False)
    anchor = torch.empty(0, requires_grad=True)   # the op always joins the graph
    return _PipelineOp.apply(sched, anchor, *x)


def pipeline_vit_trunk(blocks, x: torch.Tensor, group=None,
                       n_microbatch: Optional[int] = None) -> torch.Tensor:
    """Pipeline a trunk of ``ResidualAttentionBlock``s (``blocks``, e.g. a
    TiTok encoder's ``transformer``) over ``group``: stage ``p`` applies
    blocks ``[p * L / P, (p + 1) * L / P)``; equal to ``for blk in blocks:
    x = blk(x)``.  ``x``: the ``(B, S, D)`` sequence after the model's
    pre-trunk embedding."""
    P = group.size if group is not None else 1
    p = group.index if group is not None else 0
    L = len(blocks)
    if L % P:
        raise ValueError(f"{L} layers not divisible by {P} stages")
    mine = list(blocks)[p * L // P:(p + 1) * L // P]

    def stage(carry):
        (a,) = carry
        for blk in mine:
            a = blk(a)
        return (a,)

    return spmd_pipeline(stage, (x,), group, n_microbatch)[0]


# -- layouts over flat params/... dicts ----------------------------------------

def stack_trunk(params: Dict[str, np.ndarray], prefix: str = "transformer_"):
    """Lift the leaves under ``<prefix><i>/`` for consecutive ``i`` from 0
    into one dict keyed by the rest of the path, each leaf stacked on a
    leading layer axis.  ``params`` is a flat dict of one model's subtree
    (keys ``<prefix><i>/<leaf path>``).  Returns ``(stacked, n_layers)``."""
    pat = re.compile(re.escape(prefix) + r"(\d+)/(.+)$")
    found: Dict[int, Dict[str, np.ndarray]] = {}
    for k, v in params.items():
        m = pat.match(k)
        if m:
            found.setdefault(int(m.group(1)), {})[m.group(2)] = v
    n = len(found)
    if n == 0:
        raise ValueError(f"no '{prefix}<i>' subtrees in params")
    if sorted(found) != list(range(n)):
        raise ValueError(f"'{prefix}<i>' not numbered 0..{n - 1}: {sorted(found)}")
    keys = sorted(found[0])
    if any(sorted(found[i]) != keys for i in range(n)):
        raise ValueError(f"the '{prefix}<i>' subtrees differ in their leaves")
    return {k: np.stack([np.asarray(found[i][k]) for i in range(n)])
            for k in keys}, n


def _sub(tree: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in tree.items() if k.startswith(prefix)}


def stack_hybrid_cells(tree: Dict[str, np.ndarray], num_layers: int,
                       insert_pos) -> Dict[str, np.ndarray]:
    """A hybrid trunk's flat named leaves (``transformer_{i}/...``,
    ``inter_blocks_{i}/...``, ``feat_blocks_{i}/...``, keys relative to the
    encoder or decoder) -> the JAX package's stacked ``trunk_cells/...``
    layout: ``vit_{j}``, ``inter`` and ``feat_block`` leaves with a leading
    cell axis, zeros for an insert-free cell's interaction leaves (they sit
    behind a 0-gate there).  Other keys pass through."""
    from ..models.hybrid import cell_partition
    k = cell_partition(num_layers, insert_pos)
    n_cells = num_layers // k
    live = [p for p in insert_pos if p < num_layers]
    if not live:
        raise ValueError("trunk has no live insert positions; nothing to stack")
    inter_t = _sub(tree, f"inter_blocks_{live[0]}/")
    fb_t = _sub(tree, f"feat_blocks_{live[0]}/")
    cells = []
    for c in range(n_cells):
        cell = {}
        for j in range(k):
            for kk, v in _sub(tree, f"transformer_{c * k + j}/").items():
                cell[f"vit_{j}/{kk}"] = v
        end = c * k + k - 1
        for name, sub, tmpl in (("inter", "inter_blocks", inter_t),
                                ("feat_block", "feat_blocks", fb_t)):
            src = _sub(tree, f"{sub}_{end}/") if end in live else \
                {kk: np.zeros_like(v) for kk, v in tmpl.items()}
            cell.update({f"{name}/{kk}": v for kk, v in src.items()})
        cells.append(cell)
    trunk_re = re.compile(r"^(transformer_|inter_blocks_|feat_blocks_)\d+/")
    out = {kk: v for kk, v in tree.items() if not trunk_re.match(kk)}
    for kk in cells[0]:
        out[f"trunk_cells/{kk}"] = np.stack([np.asarray(c[kk]) for c in cells])
    return out


def unstack_hybrid_cells(tree: Dict[str, np.ndarray], num_layers: int,
                         insert_pos) -> Dict[str, np.ndarray]:
    """Inverse of :func:`stack_hybrid_cells` (an insert-free cell's dead
    interaction leaves are dropped)."""
    from ..models.hybrid import cell_partition
    k = cell_partition(num_layers, insert_pos)
    live = [p for p in insert_pos if p < num_layers]
    stacked = _sub(tree, "trunk_cells/")
    out = {kk: v for kk, v in tree.items() if not kk.startswith("trunk_cells/")}
    vit_re = re.compile(r"^vit_(\d+)/(.+)$")
    for c in range(num_layers // k):
        end = c * k + k - 1
        for kk, v in stacked.items():
            m = vit_re.match(kk)
            if m:
                out[f"transformer_{c * k + int(m.group(1))}/{m.group(2)}"] = v[c]
            elif end in live:
                name, rest = kk.split("/", 1)
                sub = "inter_blocks" if name == "inter" else "feat_blocks"
                out[f"{sub}_{end}/{rest}"] = v[c]
    return out


def codec_params_canonicalize(params: Dict[str, np.ndarray], spec):
    """A full codec's flat ``params/...`` dict with stacked ``trunk_cells``
    -> the named ``transformer_{i}`` layout the port's modules load (a
    no-op when already named)."""
    return _convert_codec_layout(params, spec, to_stacked=False)


def codec_params_stack(params: Dict[str, np.ndarray], spec):
    """Inverse of :func:`codec_params_canonicalize` (a no-op when already
    stacked): the layout a JAX ``Codec(..., pp=...)`` loads."""
    return _convert_codec_layout(params, spec, to_stacked=True)


def _convert_codec_layout(params, spec, to_stacked: bool):
    out = dict(params)
    L = spec.titok.num_layers
    for side, ipos in (("encoder", spec.insert_pos_enc),
                       ("decoder", spec.insert_pos_dec)):
        prefix = f"params/hybrid_codec/{side}/"
        sub = _sub(params, prefix)
        if not sub:
            continue
        stacked_now = any(k.startswith("trunk_cells/") for k in sub)
        if to_stacked == stacked_now:
            continue
        conv = stack_hybrid_cells if to_stacked else unstack_hybrid_cells
        for k in sub:
            del out[prefix + k]
        out.update({prefix + k: v for k, v in conv(sub, L, ipos).items()})
    return out
