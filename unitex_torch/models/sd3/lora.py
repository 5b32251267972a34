"""LoRA for the SD3 MMDiT and the VAE encoder, as TSD-SR uses them (port
of unitex_tpu/models/sd3/lora.py): rank-64 adapters, zero-effect at init
(a ~ N(0, 1/r), b = 0), in the JAX package's tree layout, merged by
``models/flux/lora.merge_lora``."""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ...utils.precision import resolve_device
from ..flux.lora import _ensure_set, _get, merge_lora

SD3_BLOCK_TARGETS = (
    ("attn", "to_q"), ("attn", "to_k"), ("attn", "to_v"), ("attn", "to_out"),
    ("attn", "add_q_proj"), ("attn", "add_k_proj"), ("attn", "add_v_proj"),
    ("attn", "to_add_out"),
    ("ff", "in"), ("ff", "out"),
    ("ff_context", "in"), ("ff_context", "out"),
)
SD3_FINAL_TARGETS = (
    ("attn", "to_q"), ("attn", "to_k"), ("attn", "to_v"), ("attn", "to_out"),
    ("attn", "add_q_proj"), ("attn", "add_k_proj"), ("attn", "add_v_proj"),
    ("ff", "in"), ("ff", "out"),
)


def _make(generator: torch.Generator, kernel: torch.Tensor, rank: int,
          device) -> Dict[str, torch.Tensor]:
    """{"a": [..., d_in, r] ~ N(0, 1/r), "b": [..., r, d_out] = 0}, f32,
    for a stacked [L, d_in, d_out] or a single [d_in, d_out] kernel."""
    *lead, d_in, d_out = kernel.shape
    a = torch.empty((*lead, d_in, rank), dtype=torch.float32, device=device)
    a.normal_(0.0, 1.0 / math.sqrt(rank), generator=generator)
    return {"a": a, "b": torch.zeros((*lead, rank, d_out), device=device)}


@torch.no_grad()
def init_sd3_lora(generator: torch.Generator, params: Dict[str, Any],
                  rank: int = 64, device="cuda") -> Dict[str, Any]:
    """Zero-effect adapters on the joint blocks' projections and MLPs
    (``blocks``, stacked) and on the final block's (no context output)."""
    dev = resolve_device(device)
    lora: Dict[str, Any] = {"blocks": {}, "final_block": {}}
    for path in SD3_BLOCK_TARGETS:
        _ensure_set(lora["blocks"], path, _make(
            generator, _get(params["blocks"], path)["kernel"], rank, dev))
    for path in SD3_FINAL_TARGETS:
        _ensure_set(lora["final_block"], path, _make(
            generator, _get(params["final_block"], path)["kernel"], rank, dev))
    return lora


@torch.no_grad()
def init_vae_encoder_lora(generator: torch.Generator,
                          vae_params: Dict[str, Any], rank: int = 64,
                          device="cuda") -> Dict[str, Any]:
    """Adapters on the VAE encoder's mid-block attention projections (the
    1x1-conv-equivalent linears, the low-rank targets of a conv encoder)."""
    dev = resolve_device(device)
    attn = vae_params["encoder"]["mid"]["attn"]
    return {"encoder": {"mid": {"attn": {
        name: _make(generator, attn[name]["kernel"], rank, dev)
        for name in ("q", "k", "v", "o")}}}}


__all__ = [
    "init_sd3_lora",
    "init_vae_encoder_lora",
    "merge_lora",
    "SD3_BLOCK_TARGETS",
    "SD3_FINAL_TARGETS",
]
