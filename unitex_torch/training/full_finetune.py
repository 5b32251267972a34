"""Full-parameter FLUX fine-tuning with ZeRO-1 optimizer-state sharding
(port of unitex_tpu/training/full_finetune.py).

Across the ranks of a mesh (``parallel/mesh.py``), ZeRO stage 1 as the
JAX package lays it out:

* the f32 master parameters carry the tensor-parallel cuts
  (``parallel/sharding.shard_flux_params``) and are whole on every data
  rank;
* the optimizer's moments are additionally cut over ``data`` on each
  leaf's first free dimension that divides (:func:`zero_shardings`), so
  each data rank holds 1/data of them (:func:`shard_opt_state_zero`);
* a step's gradients are summed into the logical tree's over ``model``
  (``parallel/collectives``), reduce-scattered over ``data`` on that
  dimension, the update runs on this rank's part, and the parameters are
  all-gathered back over ``data``.

The arithmetic is ``training/flux_lora``'s optax AdamW (or Prodigy)
behind the global-norm clip, the norm over the whole logical tree.  With
``bf16_compute`` the f32 masters are cast to bf16 as they are used (a
block's inside its block) and the gradients come back f32.  A checkpoint
is the whole tree (:func:`gathered_params`), which any mesh, or one card,
resumes from.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..models.flux.config import FluxConfig
from ..parallel.collectives import CUT, leaf_role, named_leaves, reduce_grads
from ..parallel.sharding import gather, unshard_tree
from .flux_lora import (
    FluxLoraTrainConfig,
    _backward,
    _leaves,
    _map,
    flow_match_loss,
    make_optimizer,
)


@dataclasses.dataclass
class FullTrainState:
    """The step count, the f32 parameter tree (``requires_grad`` leaves,
    this rank's TP slices) and the optimizer state (its moments this data
    rank's parts under ZeRO); ``full_train_step`` updates it in place.
    ``zero``: each leaf's ZeRO dimension (None: not cut over data) and
    the data group, or None without ZeRO."""

    step: int
    params: Dict[str, Any]
    opt_state: Any
    zero: Optional[Tuple[List[Optional[int]], Any]] = None


def create_full_state(params: Dict[str, Any], tcfg: FluxLoraTrainConfig
                      ) -> Tuple[FullTrainState, Any]:
    """The state of full fine-tuning on one rank (or with the optimizer
    state whole on every rank); :func:`shard_opt_state_zero` for ZeRO."""
    tx = make_optimizer(tcfg)
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    return FullTrainState(step=0, params=params, opt_state=tx.init(params)), tx


def zero_shardings(tree: Dict[str, Any], data_size: int,
                   tp: bool = False) -> List[Optional[int]]:
    """Each leaf's ZeRO dimension: the first one that is not cut over
    ``model`` (with ``tp``, by ``collectives.leaf_role`` and the sharding
    layout) and whose size divides ``data_size``; None for a leaf with no
    such dimension (scalars, small vectors), which stays whole."""
    from ..parallel.sharding import layout

    dims = []
    for path, x in named_leaves(tree):
        taken = None
        if tp and leaf_role(path) == CUT:
            kind = layout(path[:-1])
            taken = x.dim() - (1 if kind == "col" else 2)
        dim = None
        for i in range(x.dim()):
            if i != taken and x.shape[i] % data_size == 0 \
                    and x.shape[i] >= data_size:
                dim = i
                break
        dims.append(dim)
    return dims


def _part(x: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    """This data rank's part of ``x`` along ``dim`` (a view), or ``x``."""
    if dim is None:
        return x
    n, i = dist.get_world_size(group), dist.get_rank(group)
    k = x.shape[dim] // n
    return x.narrow(dim, i * k, k)


def shard_opt_state_zero(params: Dict[str, Any], mesh, tx,
                         tp: Optional[bool] = None) -> Tuple[Any, Any]:
    """The optimizer state made directly in the ZeRO layout: each moment
    leaf this data rank's part of its parameter's slice, along
    :func:`zero_shardings`' dimension.  Returns (opt state, the
    ``FullTrainState.zero`` of it)."""
    group = mesh.group("data")
    if tp is None:
        tp = mesh.size("model") > 1
    dims = zero_shardings(params, mesh.size("data"), tp)
    leaves = [_part(x.detach(), d, group) for x, d in zip(_leaves(params), dims)]
    it = iter(leaves)
    parts = _map(lambda _: next(it), params)
    return tx.init(parts), (dims, group)


def full_finetune_loss(params: Dict[str, Any], cfg: FluxConfig,
                       tcfg: FluxLoraTrainConfig, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator],
                       compute_dtype: Optional[torch.dtype] = None,
                       draws: Optional[Dict[str, Any]] = None,
                       data_axis=None) -> torch.Tensor:
    """The flow-match loss over the whole parameter tree (``lora=None``);
    ``compute_dtype`` casts the f32 masters as they are used (mixed
    precision)."""
    return flow_match_loss(None, params, cfg, tcfg, batch, generator,
                           **(draws or {}), data_axis=data_axis,
                           compute_dtype=compute_dtype)


def _reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part along ``dim`` of the sum of ``g`` over ``group``."""
    n = dist.get_world_size(group)
    moved = g.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]),
                      dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def full_train_step(
    state: FullTrainState,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    cfg: FluxConfig,
    tcfg: FluxLoraTrainConfig,
    tx,
    bf16_compute: bool = False,
    draws: Optional[Dict[str, Any]] = None,
    data_axis=None,
) -> Tuple[FullTrainState, torch.Tensor]:
    """One optimizer step of the whole tree on one batch; returns (state,
    loss).  Across ranks, ``cfg.tp_axis`` and ``data_axis`` as in
    ``flux_lora.train_step`` (every rank gets the whole batch and the
    same draws); under ZeRO (``state.zero``) ``data_axis`` must be its
    data group."""
    dtype = torch.bfloat16 if bf16_compute else None
    p_leaves = _leaves(state.params)
    for p in p_leaves:
        p.grad = None
    loss = full_finetune_loss(state.params, cfg, tcfg, batch, generator,
                              dtype, draws, data_axis)
    _backward(loss)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad.float()
             for p in p_leaves]
    model = cfg.tp_axis
    paths = [path for path, _ in named_leaves(state.params)]
    roles = [leaf_role(path) if model is not None else None for path in paths]
    dims, zgroup = state.zero if state.zero is not None else (
        [None] * len(grads), None)
    if zgroup is not None and zgroup is not data_axis:
        raise ValueError("ZeRO's data group is not the batch's data_axis")
    # the logical gradients: partial ones over model, then over data (a
    # ZeRO leaf reduce-scattered to this rank's part)
    reduce_grads(grads, roles, model, None)
    axes = []
    for i, (g, role) in enumerate(zip(grads, roles)):
        ax = [model] if role == CUT else []
        if data_axis is not None:
            if dims[i] is not None and zgroup is not None:
                # the whole gradient is freed as its part is made
                grads[i] = _reduce_scatter(g, dims[i], zgroup)
                p_leaves[i].grad = g = None
                ax.append(zgroup)
            else:
                dist.all_reduce(g, group=data_axis)
        axes.append(tuple(ax))
    parts = [_part(p, d, zgroup) if zgroup is not None else p
             for p, d in zip(p_leaves, dims)]
    sharded = model is not None or data_axis is not None
    tx.step(parts, grads, state.opt_state, axes if sharded else None)
    if zgroup is not None:
        with torch.no_grad():
            for p, part, d in zip(p_leaves, parts, dims):
                if d is not None:
                    p.copy_(gather(part.contiguous(), zgroup, d))
    for p in p_leaves:
        p.grad = None
    state.step += 1
    return state, loss.detach()


def gathered_params(state: FullTrainState, mesh=None) -> Dict[str, Any]:
    """The whole parameter tree (detached), gathered over ``model`` from
    the ranks' slices (``mesh``: the tree is in the tensor-parallel layout,
    at any model size): the checkpoint, which any mesh or one card
    resumes from.  Every rank of the model group calls it."""
    params = _map(lambda x: x.detach(), state.params)
    if mesh is None:
        return params
    return unshard_tree(params, mesh.group("model"))
