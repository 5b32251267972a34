"""The tensor-parallel collectives as autograd functions (Megatron's
conjugate pair), and the gradient reductions of a sharded train step.

The JAX package differentiates through ``jax.lax.psum`` and GSPMD's
gathers; here each collective is a ``torch.autograd.Function`` with its
transpose as the backward:

* :func:`reduce_from` (Megatron's ``g``): ``all_reduce`` forward, identity
  backward, after a row-parallel product.  Every rank of the group holds
  the same downstream gradient, which is each partial product's;
* :func:`copy_to` (Megatron's ``f``): identity forward, ``all_reduce`` of
  the input gradient backward, before the column-parallel products that
  read a replicated activation: each rank's columns give only their part
  of that activation's gradient;
* :func:`gather_from`: ``all_gather`` forward; the backward keeps this
  rank's slice of the gradient.  It does not reduce-scatter: every rank
  computes the same replicated loss, so its gradient is already whole on
  every rank (a reduce-scatter would scale it by the group size).  It
  gathers the AdaLN modulation columns over ``model``, and a batch cut
  over ``data``.

A parameter left whole on every model rank inside a block (the QK-norm
weights, the adapter factor that is not cut) sees only this rank's heads
or columns, so its gradient is partial: :func:`leaf_role` names each
leaf's role, and :func:`reduce_grads` sums the partial ones over
``model``, then every gradient over ``data``.  :func:`tree_sum` adds
per-leaf numbers over the logical tree (a leaf cut over an axis counts
each part once, a whole leaf once), which is what the optimizers' global
norm and Prodigy's sums read.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from .sharding import _STACKS, gather, layout

Path = Tuple[str, ...]


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        dist.all_reduce(x, group=group)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.k = dim, x.shape[dim]
        ctx.start = dist.get_rank(group) * ctx.k
        return gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.k), None, None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (in place: ``x`` must be a fresh
    product); the gradient passes unchanged."""
    return _Reduce.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, whose gradient is summed over ``group``."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Copy.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's parts of ``x`` concatenated along ``dim`` in rank order;
    the gradient of this rank's part is its slice of the whole's."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return gather(x, group, dim)
    return _Gather.apply(x, group, dim % x.dim())


# --------------------------------------------------- gradient reductions

CUT, PARTIAL, WHOLE = "cut", "partial", "whole"


def leaf_role(path: Path) -> str:
    """How a leaf of a FLUX/SD3 tree (or an adapter tree of it) at
    ``path`` lies over ``model`` under ``parallel/sharding.py``'s cuts:
    CUT (each rank holds a part), PARTIAL (whole on every rank, but inside
    a block, so each rank's gradient is its heads' or columns' part) or
    WHOLE (outside the blocks, or a row product's bias, added after the
    sum: its gradient is whole on every rank)."""
    if not path or path[0] not in _STACKS:
        return WHOLE
    name, node = path[-1], path[:-1]
    kind = layout(node)
    if name in ("a", "b"):   # an adapter factor
        if (kind == "col" and name == "b") or (
                kind in ("row", "split_row") and name == "a"):
            return CUT
        return PARTIAL
    if kind == "col" and name in ("kernel", "bias"):
        return CUT
    if kind in ("row", "split_row") and name in ("kernel", "kernel_attn",
                                                  "kernel_mlp"):
        return CUT
    if name == "bias":
        return WHOLE
    return PARTIAL


def named_leaves(tree, prefix: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    """(path, leaf) of a tree of dicts, in the order of ``_leaves``."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in named_leaves(v, prefix + (k,))]
    return [(prefix, tree)]


def reduce_grads(grads: Sequence[torch.Tensor], roles: Sequence[str],
                 model=None, data=None) -> None:
    """The gradients of the logical tree from this rank's, in place: the
    PARTIAL ones summed over ``model``, then every one summed over
    ``data`` (each data rank's gradient is its slice's part of the
    logical loss's).  One collective a leaf, in one order on every
    rank."""
    for g, role in zip(grads, roles):
        if model is not None and role == PARTIAL:
            dist.all_reduce(g, group=model)
        if data is not None:
            dist.all_reduce(g, group=data)


def tree_sum(values: Iterable[torch.Tensor], axes: Sequence[Tuple]) -> torch.Tensor:
    """The sum over the logical tree of per-leaf scalars ``values``:
    ``axes[i]`` lists the process groups leaf ``i`` is cut over, whose
    parts are summed; a leaf whole on the ranks counts once."""
    by_axes: Dict[Tuple, torch.Tensor] = {}
    for v, ax in zip(values, axes):
        key = tuple(ax)
        by_axes[key] = by_axes[key] + v if key in by_axes else v
    total = None
    for key, s in by_axes.items():
        s = s.clone()
        for group in key:
            dist.all_reduce(s, group=group)
        total = s if total is None else total + s
    return total
