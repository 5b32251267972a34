"""Sequence-parallel exact attention over a process group (port of
unitex_tpu/ops/ring_attention.py).

Each rank holds a block of the token sequence: q/k/v ``[B, S/n, H, D]``.

* **Ulysses** (:func:`ulysses_attention_local`): one ``all_to_all_single``
  a tensor gathers the full sequence on ``H/n`` heads, full attention runs
  there through ``attn_fn`` (``models/flux/layers.sdpa``: kernel B1, or B3
  with ``qk8``), and a second exchange restores the token blocks.  The
  gathered sequence is rank-major (the JAX ``all_to_all(..., tiled=True)``
  with split axis 2 and concat axis 1).  H must divide the group size.
* **Ring** (:func:`ring_attention_local`): K/V rotate ``n - 1`` times to the
  next rank (``batch_isend_irecv``); each block product is kernel B1, which
  returns its rows' logsumexp, and the normalised partial outputs merge in
  f32 by their lse (:func:`ring_merge`, :func:`ring_finish`).  The JAX ring
  computes the same function with plain per-block statistics
  (``_block_attention``); here the card stays on the kernel.  On a CPU
  tensor B1's plain version runs.

:func:`ring_attention` and :func:`ulysses_attention` take whole tensors and
run the local forms on this rank's block, returning the whole output on
every rank.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.sharding import gather
from .attention import attention, flash_attention

State = Tuple[torch.Tensor, torch.Tensor]  # (out f32 [B,S,H,D], lse f32 [B,S,H])


def _size_rank(group) -> Tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


# ------------------------------------------------------------------ ring


def ring_block(q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block product (kernel B1): the normalised output [B, Sq, H, D]
    and its rows' lse [B, Sq, H] f32."""
    B, S, H, _ = q.shape
    out, lse = flash_attention(q, k, v)
    return out, lse.reshape(B, H, S).transpose(1, 2)


def ring_merge(state: Optional[State], out_i: torch.Tensor,
               lse_i: torch.Tensor) -> State:
    """Fold one block's normalised output and lse into the running state
    (``None`` before the first block): the outputs weighted by
    exp(lse - logaddexp(lse, lse_i)) in f32."""
    out_i = out_i.float()
    if state is None:
        return out_i, lse_i
    out, lse = state
    new = torch.logaddexp(lse, lse_i)
    out = (out * torch.exp(lse - new)[..., None]
           + out_i * torch.exp(lse_i - new)[..., None])
    return out, new


def ring_finish(state: State, dtype: torch.dtype) -> torch.Tensor:
    """The merged attention output in ``dtype``."""
    return state[0].to(dtype)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group) -> torch.Tensor:
    """Exact attention of this rank's queries over every rank's keys: q/k/v
    are this rank's sequence blocks [B, S/n, H, D]; K/V travel the ring
    (rank r sends to r + 1 and receives from r - 1), one B1 launch a
    block."""
    n, r = _size_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    state = ring_merge(None, *ring_block(q, k, v))
    kv = torch.stack([k, v]).contiguous()
    for _ in range(n - 1):
        recv = torch.empty_like(kv)
        ops = [dist.P2POp(dist.isend, kv, nxt, group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        kv = recv
        state = ring_merge(state, *ring_block(q, kv[0], kv[1]))
    return ring_finish(state, q.dtype)


# --------------------------------------------------------------- Ulysses


def _heads_to_sequence(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S/n, H, D] -> [B, S, H/n, D]: head block j goes to rank j, and
    the received sequence blocks are concatenated in rank order."""
    n = dist.get_world_size(group)
    B, s, H, D = x.shape
    send = x.reshape(B, s, n, H // n, D).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 0, 2, 3, 4).reshape(B, n * s, H // n, D)


def _sequence_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """The inverse: [B, S, H/n, D] -> [B, S/n, H, D]."""
    n = dist.get_world_size(group)
    B, S, h, D = x.shape
    send = x.reshape(B, n, S // n, h, D).permute(1, 0, 2, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * h, D)


def ulysses_attention_local(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
    attn_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Ulysses sequence parallelism on this rank's blocks q/k/v
    [B, S/n, H, D]: full-sequence attention on H/n heads between two
    ``all_to_all_single`` exchanges.  ``attn_fn`` (default
    ``ops/attention.attention``: B1) runs the local attention."""
    n = dist.get_world_size(group)
    H = q.shape[2]
    if H % n:
        raise ValueError(f"ulysses needs heads {H} divisible by the group "
                         f"size {n}")
    attn_fn = attn_fn or attention
    out = attn_fn(*(_heads_to_sequence(x, group) for x in (q, k, v)))
    return _sequence_to_heads(out, group)


def sequence_parallel_attention(q, k, v, group, mode: str = "auto",
                                attn_fn: Optional[Callable] = None):
    """The models' attention under sequence parallelism: ``mode``
    "ulysses", "ring", or "auto" (Ulysses when the local heads divide the
    group size, the ring otherwise)."""
    if mode == "auto":
        mode = "ulysses" if q.shape[2] % dist.get_world_size(group) == 0 else "ring"
    if mode == "ulysses":
        return ulysses_attention_local(q, k, v, group, attn_fn)
    if mode != "ring":
        raise ValueError(f"sp_mode must be ulysses, ring or auto, got {mode!r}")
    return ring_attention_local(q, k, v, group)


# ---------------------------------------------------------- whole tensors


def _local_call(fn, q, k, v, group):
    n, r = _size_rank(group)
    S = q.shape[1]
    if S % n:
        raise ValueError(f"S {S} does not split over {n} ranks")
    s = S // n
    out = fn(*(x[:, r * s:(r + 1) * s] for x in (q, k, v)), group)
    return gather(out, group, dim=1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group) -> torch.Tensor:
    """Exact attention with q/k/v [B, S, H, D] split over ``group``'s ranks
    along S (which must divide it): each rank runs
    :func:`ring_attention_local` on its block; every rank returns the
    whole output."""
    return _local_call(ring_attention_local, q, k, v, group)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group) -> torch.Tensor:
    """As :func:`ring_attention`, through :func:`ulysses_attention_local`
    (S and H must divide the group size)."""
    return _local_call(ulysses_attention_local, q, k, v, group)
