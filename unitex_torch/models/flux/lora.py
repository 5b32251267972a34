"""LoRA adapters for the FLUX transformer (port of
unitex_tpu/models/flux/lora.py).

Layer-stacked: block kernels are [L, d_in, d_out], so a LoRA leaf is
{"a": [L, d_in, r], "b": [L, r, d_out]} and ``merge_lora`` folds
``scale · a @ b`` into the targeted kernels.  Multiple adapters compose by
summed merge (the set_adapters weights semantics).

Deferred: ``attach_lora`` (the runtime-attached form for int8 serving)
and the PEFT safetensors I/O.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

import math

import torch

from ...utils.precision import resolve_device

DUAL_TARGETS = (
    ("attn", "to_q"), ("attn", "to_k"), ("attn", "to_v"), ("attn", "to_out"),
    ("attn", "add_q_proj"), ("attn", "add_k_proj"), ("attn", "add_v_proj"),
    ("attn", "to_add_out"),
    ("ff", "in"), ("ff", "out"),
    ("ff_context", "in"), ("ff_context", "out"),
)
SINGLE_TARGETS = (
    ("attn", "to_q"), ("attn", "to_k"), ("attn", "to_v"),
    ("proj_mlp",), ("proj_out",),
)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _ensure_set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


@torch.no_grad()
def init_lora_params(
    generator: torch.Generator,
    params: Dict[str, Any],
    rank: int = 16,
    include_single: bool = True,
    device="cuda",
) -> Dict[str, Any]:
    """Zero-effect LoRA tree (a ~ N(0, 1/r), b = 0 — the PEFT default), f32
    on ``device``; only the kernel shapes of ``params`` are read."""
    dev = resolve_device(device)

    def make(kernel):
        L, d_in, d_out = kernel.shape
        a = torch.empty((L, d_in, rank), dtype=torch.float32, device=dev)
        a.normal_(0.0, 1.0 / math.sqrt(rank), generator=generator)
        return {"a": a, "b": torch.zeros((L, rank, d_out), device=dev)}

    lora: Dict[str, Any] = {"dual_blocks": {}, "single_blocks": {}}
    for path in DUAL_TARGETS:
        _ensure_set(lora["dual_blocks"], path,
                    make(_get(params["dual_blocks"], path)["kernel"]))
    if include_single:
        for path in SINGLE_TARGETS:
            _ensure_set(lora["single_blocks"], path,
                        make(_get(params["single_blocks"], path)["kernel"]))
    return lora


@torch.no_grad()
def merge_lora(
    params: Dict[str, Any],
    loras: Iterable[Tuple[Dict[str, Any], float]],
) -> Dict[str, Any]:
    """Return params with each (lora, weight) folded into the kernels.

    The result shares every untargeted leaf with ``params``; each targeted
    kernel is a fresh tensor (the base tree is never written), filled one
    layer at a time so the f32 ``a @ b`` temporary is one layer's, not the
    stacked [L, d_in, d_out] product.  Drop the result after the pass to
    free the merged copies."""

    def merged_kernel(kernel, d, scale):
        out = torch.empty_like(kernel)
        for i in range(kernel.shape[0]):
            out[i] = kernel[i] + scale * torch.matmul(
                d["a"][i], d["b"][i]).to(kernel.dtype)
        return out

    def walk(base, delta, scale):
        out = {}
        for k, v in base.items():
            if isinstance(v, dict) and k in delta:
                d = delta[k]
                if "a" in d and "b" in d:
                    out[k] = dict(v)
                    out[k]["kernel"] = merged_kernel(v["kernel"], d, scale)
                else:
                    out[k] = walk(v, d, scale)
            else:
                out[k] = v
        return out

    merged = params
    for lora, weight in loras:
        if lora is None or weight == 0.0:
            continue
        merged = walk(merged, lora, weight)
    return merged
