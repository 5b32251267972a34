"""Sequence-parallel FLUX forward (port of unitex_tpu/models/flux/sp.py).

Each rank of the ``seq`` axis takes its ``S_img/n`` image tokens and
``S_txt/n`` text tokens, with their position-id rows, and runs the
unchanged :func:`~.model.flux_forward` with the sequence group in its
config: every op but attention is token-local, and attention runs Ulysses
or the ring over the group (``ops/ring_attention.py``).  The text and
image blocks are concatenated locally, so the global order is
block-interleaved ``[txt_0‖img_0‖txt_1‖img_1…]``, a permutation of the
unsharded order; full attention is permutation-equivariant and each token
keeps its own RoPE id, so the result is exact.  The ranks' output blocks
are gathered, so :func:`flux_forward_sp` returns the whole ``[B, S_img,
C]`` on every rank and serves as ``denoise``'s ``forward_fn``.

With ``tp_axis`` it composes with tensor parallelism on a ``seq x model``
mesh: pass this rank's Megatron slices (``parallel/sharding.
shard_flux_params``) and the global config.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ...parallel.sharding import gather
from .config import FluxConfig
from .model import Params, flux_forward, tp_config


def flux_forward_sp(
    params: Params,
    cfg: FluxConfig,
    hidden_states: torch.Tensor,
    encoder_hidden_states: torch.Tensor,
    timestep: torch.Tensor,
    pooled_projections: torch.Tensor,
    img_ids: torch.Tensor,
    txt_ids: torch.Tensor,
    guidance: Optional[torch.Tensor] = None,
    lora: Optional[Dict[str, Any]] = None,
    kv_keep_idx: Optional[torch.Tensor] = None,
    *,
    seq_axis,
    sp_mode: Optional[str] = None,
    tp_axis=None,
) -> torch.Tensor:
    """:func:`flux_forward` with the token sequence cut over the process
    group ``seq_axis`` (``Mesh.group("seq")``); ``sp_mode`` overrides
    ``cfg.sp_mode``; ``tp_axis`` (``Mesh.group("model")``) adds tensor
    parallelism over this rank's slices.  S_img and S_txt must divide the
    group size.  ``kv_keep_idx`` indexes the whole sequence and is
    refused, as in the JAX package.  Returns [B, S_img, C_in] f32 on
    every rank."""
    if kv_keep_idx is not None:
        raise ValueError("kv_keep_idx indexes the whole sequence and is not "
                         "supported under sequence parallelism")
    n, r = dist.get_world_size(seq_axis), dist.get_rank(seq_axis)
    S_img, S_txt = hidden_states.shape[1], encoder_hidden_states.shape[1]
    if S_img % n or S_txt % n:
        raise ValueError(f"S_img {S_img} / S_txt {S_txt} must divide the "
                         f"sequence group's size {n}")
    if tp_axis is not None:
        cfg = tp_config(cfg, tp_axis)
    cfg = dataclasses.replace(cfg, seq_axis=seq_axis,
                              sp_mode=sp_mode or cfg.sp_mode)
    si, st = S_img // n, S_txt // n
    out = flux_forward(
        params, cfg, hidden_states[:, r * si:(r + 1) * si],
        encoder_hidden_states[:, r * st:(r + 1) * st], timestep,
        pooled_projections, img_ids[r * si:(r + 1) * si],
        txt_ids[r * st:(r + 1) * st], guidance, lora=lora)
    return gather(out, seq_axis, dim=1)
