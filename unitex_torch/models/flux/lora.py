"""LoRA adapters for the FLUX transformer (port of
unitex_tpu/models/flux/lora.py).

Layer-stacked: block kernels are [L, d_in, d_out], so a LoRA leaf is
{"a": [L, d_in, r], "b": [L, r, d_out]} and ``merge_lora`` folds
``scale · a @ b`` into the targeted kernels.  Multiple adapters compose by
summed merge (the set_adapters weights semantics).  ``merge_lora_layer``
is the differentiable merge of one layer that training uses.
``attach_lora`` is the unmerged form that int8 serving uses: the adapters
ride beside the (quantized) kernels as ``lora_a``/``lora_b`` and
``layers.linear`` adds their delta at call time.

Deferred: the PEFT safetensors I/O.
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
    on ``device``; only the kernel shapes of ``params`` are read, from a
    float or an int8 (``kernel_int8``/``kernel_int8_wo``) serving tree."""
    dev = resolve_device(device)

    def make(kernel):
        L, d_in, d_out = kernel.shape
        a = torch.empty((L, d_in, rank), dtype=torch.float32, device=dev)
        a.normal_(0.0, 1.0 / math.sqrt(rank), generator=generator)
        return {"a": a, "b": torch.zeros((L, rank, d_out), device=dev)}

    def kernel_of(node):
        for k in ("kernel", "kernel_int8", "kernel_int8_wo"):
            if k in node:
                return node[k]
        raise KeyError(f"no kernel leaf among {sorted(node)}")

    lora: Dict[str, Any] = {"dual_blocks": {}, "single_blocks": {}}
    for path in DUAL_TARGETS:
        _ensure_set(lora["dual_blocks"], path,
                    make(kernel_of(_get(params["dual_blocks"], path))))
    if include_single:
        for path in SINGLE_TARGETS:
            _ensure_set(lora["single_blocks"], path,
                        make(kernel_of(_get(params["single_blocks"], path))))
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
            out[i] = _merged(kernel[i], d["a"][i], d["b"][i], scale)
        return out

    merged = params
    for lora, weight in loras:
        if lora is None or weight == 0.0:
            continue
        merged = _walk(merged, lora, weight, merged_kernel)
    return merged


def attach_lora(
    params: Dict[str, Any],
    loras: Iterable[Tuple[Dict[str, Any], float]],
) -> Dict[str, Any]:
    """Runtime-applied (unmerged) LoRA: each targeted linear gains
    ``lora_a``/``lora_b`` and ``layers.linear`` adds ``(x @ a) @ b``, so
    int8 base kernels stay as they are.  Adapters of weight 0 are dropped;
    the live ones are concatenated along the rank with their weight folded
    into ``a`` (the summed merge of :func:`merge_lora`), after the delta a
    node already carries (re-attaching composes).  Untargeted leaves are
    shared with ``params``."""
    live = [(l, w) for l, w in loras if l is not None and w != 0.0]
    if not live:
        return params

    def walk(base, deltas):
        out = {}
        for k, v in base.items():
            pairs = [(d[k], w) for d, w in deltas if k in d]
            if not isinstance(v, dict) or not pairs:
                out[k] = v
            elif all("a" in d and "b" in d for d, _ in pairs):
                new_a = [d["a"] * w for d, w in pairs]
                new_b = [d["b"] for d, _ in pairs]
                if "lora_a" in v:
                    new_a.insert(0, v["lora_a"])
                    new_b.insert(0, v["lora_b"])
                out[k] = {**v, "lora_a": torch.cat(new_a, dim=-1),
                          "lora_b": torch.cat(new_b, dim=-2)}
            else:
                out[k] = walk(v, pairs)
        return out

    return walk(params, live)


def merge_lora_layer(
    params: Dict[str, Any], lora: Dict[str, Any], scale: float = 1.0,
) -> Dict[str, Any]:
    """One layer's params (kernels [d_in, d_out]) with its LoRA leaves
    ({"a": [d_in, r], "b": [r, d_out]}) folded in, under autograd: the
    gradients of the merged kernels reach ``a`` and ``b`` through the cast
    to the kernel's dtype.  The cast order is ``merge_lora``'s."""
    return _walk(params, lora, scale,
                 lambda kernel, d, s: _merged(kernel, d["a"], d["b"], s))


def _merged(kernel, a, b, scale):
    return kernel + scale * torch.matmul(a, b).to(kernel.dtype)


def _walk(base, delta, scale, merged_kernel):
    """``base`` with ``merged_kernel(kernel, {"a", "b"}, scale)`` in place
    of each kernel that ``delta`` targets; other leaves are shared."""
    out = {}
    for k, v in base.items():
        if isinstance(v, dict) and k in delta:
            d = delta[k]
            if "a" in d and "b" in d:
                out[k] = dict(v)
                out[k]["kernel"] = merged_kernel(v["kernel"], d, scale)
            else:
                out[k] = _walk(v, d, scale, merged_kernel)
        else:
            out[k] = v
    return out
