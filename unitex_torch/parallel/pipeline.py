"""Pipeline parallelism: the GPipe microbatch schedule over the ``pipe``
ranks of a mesh (port of unitex_tpu/parallel/pipeline.py).

The block stacks' layer axis is cut over the ``pipe`` process group: each
stage holds L/P contiguous blocks (:func:`pad_stacked_blocks` pads L with
zero blocks, exact identities, and :func:`stage_slice` takes a stage's),
and the microbatches flow stage to stage over ``torch.distributed``
point-to-point transfers.  The schedule is the JAX package's: stage ``p``
runs microbatch ``m`` at step ``m + p``, ``M + P - 1`` steps in all
(:func:`gpipe_local`), or, for two chained stacks, phase a at step
``m + p`` and phase b at step ``OFF + m + p`` with ``OFF = max(M, P)``,
``OFF + M + P - 1`` steps, phase a's last stage handing each microbatch to
stage 0 over the ring's ``P-1 -> 0`` hop (:func:`gpipe_chain_local`).
A stage with no microbatch at a step computes nothing (the JAX package
computes a clamped dummy and masks it).

Every step ends with one exchange: each stage sends what it computed to
the next and receives what the previous one computed, the two posted
together (``batch_isend_irecv``), so every rank posts its transfers in one
order and a pair that sends both ways at one step (P = 2) cannot block.
The exchange is an autograd function whose backward runs the transposed
exchange: the gradient of what was received goes back to its sender, the
gradient of what was sent comes back from its receiver.  A token tensor
threads every exchange of a rank in order, forward and backward, so the
autograd engine runs the backward exchanges in exactly the reverse order
on every rank.  The last stage's outputs are broadcast to every stage (the
JAX package's psum of the masked buffer), so every rank computes the
loss; the broadcast's backward hands the gradient to the last stage
alone.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

Params = Any


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def pad_stacked_blocks(stacked: Params, multiple: int) -> Params:
    """A stacked [L, ...] block tree padded with zero blocks so L divides
    ``multiple`` (the pipe size).  A zero block is an exact identity for
    both FLUX block types: every AdaLN-Zero modulation, and so every
    residual gate, comes from a zero linear.  The padding goes at the end,
    so the real blocks keep their order."""
    L = _first_leaf(stacked).shape[0]
    pad = (-L) % multiple
    if pad == 0:
        return stacked
    return _map(lambda x: torch.cat(
        [x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0), stacked)


def stage_slice(stacked: Params, group) -> Params:
    """This stage's contiguous L/P layers of a padded stack (views)."""
    P, p = dist.get_world_size(group), dist.get_rank(group)
    L = _first_leaf(stacked).shape[0]
    if L % P:
        raise ValueError(f"stack depth {L} is not a multiple of pipe={P}: "
                         f"pad it first (pad_stacked_blocks)")
    k = L // P
    return _map(lambda x: x[p * k:(p + 1) * k], stacked)


# --------------------------------------------------------------- transfers

_READY = {}   # id -> group: holding the group keeps its id unique


def _warm(group, device) -> None:
    """One collective on ``group`` before its first point-to-point batch
    (NCCL's rule for ``batch_isend_irecv``)."""
    if _READY.get(id(group)) is not group:
        dist.all_reduce(torch.zeros(1, device=device), group=group)
        _READY[id(group)] = group


def _transfer(send: Optional[torch.Tensor], to: int, recv_like, frm: int,
              group) -> Optional[torch.Tensor]:
    """Send ``send`` to global rank ``to`` and receive a tensor like
    ``recv_like`` from ``frm``, posted together; either may be None."""
    ops, got = [], None
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to, group))
    if recv_like is not None:
        got = torch.empty_like(recv_like, memory_format=torch.contiguous_format)
        ops.append(dist.P2POp(dist.irecv, got, frm, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


class _Exchange(torch.autograd.Function):
    """One step's exchange: ``y`` (or None) to the next stage, a tensor
    like ``like`` (or None) from the previous one."""

    @staticmethod
    def forward(ctx, token, y, like, nxt, prv, group):
        ctx.nxt, ctx.prv, ctx.group = nxt, prv, group
        ctx.sent = y is not None
        ctx.got = like is not None
        if ctx.sent:
            ctx.y_meta = (y.shape, y.dtype, y.device)
        got = _transfer(y, nxt, like, prv, group)
        if got is None:
            got = token.new_zeros(0)
        return token.clone(), got

    @staticmethod
    def backward(ctx, g_token, g_got):
        like = None
        if ctx.sent:
            shape, dtype, device = ctx.y_meta
            like = torch.empty(shape, dtype=dtype, device=device)
        g_y = _transfer(g_got if ctx.got else None, ctx.prv, like, ctx.nxt,
                        ctx.group)
        return g_token, g_y, None, None, None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's outputs on every stage; the gradient goes to the
    last stage's outputs alone (each stage's is the whole gradient of the
    same loss, so summing them would count it P times)."""

    @staticmethod
    def forward(ctx, token, out, src, group):
        ctx.is_src = dist.get_rank() == src
        res = out.clone() if ctx.is_src else torch.empty_like(out)
        dist.broadcast(res, src=src, group=group)
        return res

    @staticmethod
    def backward(ctx, g):
        return torch.zeros((), device=g.device), (g if ctx.is_src else None), \
            None, None


def _run(stage_fns, params, micro_x, micro_aux, shared, group, chained):
    """The GPipe schedule of :func:`gpipe_local` (one phase) or
    :func:`gpipe_chain_local` (two); returns the outputs [M, ...] on every
    stage."""
    P, p = dist.get_world_size(group), dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(p + 1) % P], ranks[(p - 1) % P]
    M = micro_x.shape[0]
    last = len(stage_fns) - 1
    off = max(M, P)
    steps = off + M + P - 1 if chained else M + P - 1

    def work(t, q):
        """(phase, microbatch) of stage ``q`` at step ``t``, or None."""
        ph, m = 0, t - q
        if chained and t >= off + q:
            ph, m = 1, t - off - q
        return (ph, m) if 0 <= m < M else None

    def sends(t, q):
        w = work(t, q)
        return w is not None and not (q == P - 1 and w[0] == last)

    if P > 1:
        _warm(group, micro_x.device)
    grad = torch.is_grad_enabled()
    token = torch.zeros((), device=micro_x.device, requires_grad=grad)
    like = micro_x[0]
    state = None
    wrapped: List[Optional[torch.Tensor]] = [None] * M
    outputs: List[Optional[torch.Tensor]] = [None] * M
    for t in range(steps):
        w = work(t, p)
        y = None
        if w is not None:
            ph, m = w
            if p > 0:
                x = state
            else:
                x = micro_x[m] if ph == 0 else wrapped[m]
            aux = _map(lambda a: a[m], micro_aux)
            y = stage_fns[ph](params[ph], x, aux, shared)
            if p == P - 1 and ph == last:
                outputs[m] = y
        send = y if sends(t, p) else None
        q = (p - 1) % P
        recv = like if sends(t, q) else None
        if P == 1:
            got = send       # the wrap to itself (chained, one stage)
        elif send is None and recv is None:
            got = None
        elif grad:
            token, got = _Exchange.apply(token, send, recv, nxt, prv, group)
        else:
            got = _transfer(send, nxt, recv, prv, group)
        if recv is not None or P == 1:
            if p == 0 and got is not None:
                wrapped[work(t, q)[1]] = got   # phase a's output, wrapped
            else:
                state = got
    src = ranks[P - 1]
    if p == P - 1:
        out = torch.stack(outputs)
    else:
        out = torch.zeros_like(micro_x)
    if P == 1:
        return out
    if grad:
        return _Broadcast.apply(token, out, src, group)
    dist.broadcast(out, src=src, group=group)
    return out


def gpipe_local(stage_fn: Callable, local_params: Params,
                micro_x: torch.Tensor, micro_aux: Params, shared: Params,
                group) -> torch.Tensor:
    """The per-stage GPipe schedule over the pipe process group ``group``.

    ``micro_x`` [M, ...] microbatch activations (the same on every stage),
    ``micro_aux`` a tree of per-microbatch side inputs with leading axis M
    (e.g. the AdaLN time embedding), ``shared`` microbatch-invariant side
    inputs (e.g. the RoPE tables).  ``stage_fn(local_params, x, aux,
    shared) -> y`` applies this stage's blocks and keeps x's shape and
    dtype.  Returns the last stage's [M, ...] outputs on every stage."""
    return _run((stage_fn,), (local_params,), micro_x, micro_aux, shared,
                group, chained=False)


def gpipe_chain_local(stage_fn_a: Callable, stage_fn_b: Callable,
                      params_a: Params, params_b: Params,
                      micro_x: torch.Tensor, micro_aux: Params,
                      shared: Params, group) -> torch.Tensor:
    """Two back-to-back pipelines (phase a, then phase b) in one schedule:
    phase a's last stage hands each microbatch to phase b's first stage
    over the ring's ``P-1 -> 0`` hop, where it waits for its phase-b slot,
    and phase b starts as soon as microbatches drain from phase a
    (``max(M, P) + M + P - 1`` steps against ``2(M + P - 1)``)."""
    return _run((stage_fn_a, stage_fn_b), (params_a, params_b), micro_x,
                micro_aux, shared, group, chained=True)


def _data_cut(x, data_axis):
    """This data rank's slice of each microbatch (dim 1 of [M, B_m, ...])."""
    if data_axis is None:
        return x
    n, i = dist.get_world_size(data_axis), dist.get_rank(data_axis)
    if x.shape[1] % n:
        raise ValueError(f"microbatch {x.shape[1]} does not split over "
                         f"data={n}")
    k = x.shape[1] // n
    return x[:, i * k:(i + 1) * k]


def _data_join(x, data_axis):
    from .collectives import gather_from

    return x if data_axis is None else gather_from(x, data_axis, dim=1)


def pipeline_apply_chain(stage_fn_a: Callable, stacked_params_a: Params,
                         stage_fn_b: Callable, stacked_params_b: Params,
                         micro_x: torch.Tensor, micro_aux: Params,
                         shared: Params, pipe_axis,
                         data_axis=None) -> torch.Tensor:
    """:func:`pipeline_apply` for two chained stacks (phase a then b) in
    one schedule.  The stacks are this stage's layers
    (:func:`stage_slice`)."""
    out = gpipe_chain_local(
        stage_fn_a, stage_fn_b, stacked_params_a, stacked_params_b,
        _data_cut(micro_x, data_axis),
        _map(lambda a: _data_cut(a, data_axis), micro_aux), shared, pipe_axis)
    return _data_join(out, data_axis)


def pipeline_apply(stage_fn: Callable, stacked_params: Params,
                   micro_x: torch.Tensor, micro_aux: Params, shared: Params,
                   pipe_axis, data_axis=None) -> torch.Tensor:
    """Run ``micro_x`` [M, B_m, ...] through the stacked blocks, pipelined
    over the process group ``pipe_axis``; ``stacked_params`` is this
    stage's layers (:func:`stage_slice` of a padded stack).  With
    ``data_axis`` the microbatch dimension B_m is cut over that group too
    (DP x PP): each data row pipelines its slice, and the slices are
    gathered (the gradient of each is its slice of the whole's)."""
    out = gpipe_local(stage_fn, stacked_params, _data_cut(micro_x, data_axis),
                      _map(lambda a: _data_cut(a, data_axis), micro_aux),
                      shared, pipe_axis)
    return _data_join(out, data_axis)
