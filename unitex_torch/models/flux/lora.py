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
``save_lora_safetensors`` / ``load_lora_safetensors`` write and read the
PEFT/diffusers safetensors file that serving loads; the file of either
package reads in the other to the same tree.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

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
    """Return params with each (lora, weight) folded into the kernels,
    stacked [L, d_in, d_out] or single [d_in, d_out].

    The result shares every untargeted leaf with ``params``; each targeted
    kernel is a fresh tensor (the base tree is never written), a stacked
    one filled one layer at a time so the f32 ``a @ b`` temporary is one layer's, not the
    stacked [L, d_in, d_out] product.  Drop the result after the pass to
    free the merged copies."""

    def merged_kernel(kernel, d, scale):
        if kernel.dim() == 2:  # an unstacked linear (SD3's final block)
            return _merged(kernel, d["a"], d["b"], scale)
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
    of each kernel that ``delta`` targets (a linear node's ``kernel``; of a
    tensor-parallel ``proj_out``, pre-split into ``kernel_attn`` /
    ``kernel_mlp``, each part with its rows of ``a``); other leaves are
    shared."""
    out = {}
    for k, v in base.items():
        d = delta.get(k)
        if not isinstance(d, dict):
            out[k] = v
        elif "a" in d and "b" in d and "kernel_attn" in v:
            n = v["kernel_attn"].shape[-2]
            out[k] = {**v, "kernel_attn": merged_kernel(
                v["kernel_attn"], {"a": d["a"][..., :n, :], "b": d["b"]}, scale),
                "kernel_mlp": merged_kernel(
                v["kernel_mlp"], {"a": d["a"][..., n:, :], "b": d["b"]}, scale)}
        elif "a" in d and "b" in d:
            out[k] = ({**v, "kernel": merged_kernel(v["kernel"], d, scale)}
                      if isinstance(v, dict) else merged_kernel(v, d, scale))
        else:
            out[k] = _walk(v, d, scale, merged_kernel)
    return out


# ----------------------------------------------------- PEFT safetensors IO

# tree path -> diffusers module name inside a block
_HF_DUAL = {
    ("attn", "to_q"): "attn.to_q",
    ("attn", "to_k"): "attn.to_k",
    ("attn", "to_v"): "attn.to_v",
    ("attn", "to_out"): "attn.to_out.0",
    ("attn", "add_q_proj"): "attn.add_q_proj",
    ("attn", "add_k_proj"): "attn.add_k_proj",
    ("attn", "add_v_proj"): "attn.add_v_proj",
    ("attn", "to_add_out"): "attn.to_add_out",
    ("ff", "in"): "ff.net.0.proj",
    ("ff", "out"): "ff.net.2",
    ("ff_context", "in"): "ff_context.net.0.proj",
    ("ff_context", "out"): "ff_context.net.2",
}
_HF_SINGLE = {
    ("attn", "to_q"): "attn.to_q",
    ("attn", "to_k"): "attn.to_k",
    ("attn", "to_v"): "attn.to_v",
    ("proj_mlp",): "proj_mlp",
    ("proj_out",): "proj_out",
}
_BLOCKS = (("dual_blocks", "transformer_blocks", _HF_DUAL),
           ("single_blocks", "single_transformer_blocks", _HF_SINGLE))
_PEFT_PREFIX = "base_model.model."


def save_lora_safetensors(path: str, lora: Dict[str, Any]) -> None:
    """Write the stacked LoRA tree as a PEFT/diffusers-keyed safetensors
    file (``transformer.<block>.<i>.<module>.lora_{A,B}.weight``) in
    torch's layout: lora_A [r, d_in], lora_B [d_out, r]."""
    from safetensors.torch import save_file

    tensors: Dict[str, torch.Tensor] = {}
    for tree_key, hf_block, hf_map in _BLOCKS:
        tree = lora.get(tree_key, {})
        for path_t, hf in hf_map.items():
            node = tree
            for k in path_t:
                node = node.get(k) if isinstance(node, dict) else None
            if not node or "a" not in node:
                continue
            a = node["a"].detach().cpu()  # [L, d_in, r]
            b = node["b"].detach().cpu()  # [L, r, d_out]
            for i in range(a.shape[0]):
                prefix = f"transformer.{hf_block}.{i}.{hf}"
                tensors[f"{prefix}.lora_A.weight"] = a[i].t().contiguous()
                tensors[f"{prefix}.lora_B.weight"] = b[i].t().contiguous()
    save_file(tensors, path)


def load_lora_safetensors(
    path: str, n_dual: int = 19, n_single: int = 38, device="cuda",
) -> Dict[str, Any]:
    """Read a PEFT/diffusers LoRA safetensors file (keys under
    ``transformer.`` or PEFT's ``base_model.model.``) into the stacked
    tree, f32 on ``device``: lora_A [r, d_in] and lora_B [d_out, r]
    transposed and stacked over the layers; a layer missing from the file
    gets zeros (no effect), a target missing from every layer is left
    out."""
    from safetensors import safe_open

    dev = resolve_device(device)
    with safe_open(path, framework="pt") as f:
        names = {_strip_peft(k): k for k in f.keys()}

        def get(name) -> Optional[torch.Tensor]:
            return f.get_tensor(names[name]) if name in names else None

        out: Dict[str, Any] = {}
        for (tree_key, hf_block, hf_map), n_layers in zip(_BLOCKS,
                                                          (n_dual, n_single)):
            block: Dict[str, Any] = {}
            for path_t, hf in hf_map.items():
                prefix = f"transformer.{hf_block}.{{}}.{hf}.lora_{{}}.weight"
                a = [get(prefix.format(i, "A")) for i in range(n_layers)]
                b = [get(prefix.format(i, "B")) for i in range(n_layers)]
                a0 = next((x for x in a if x is not None), None)
                if a0 is None:
                    continue
                b0 = next(x for x in b if x is not None)
                r, d_in = a0.shape
                a_st = torch.zeros((n_layers, d_in, r), device=dev)
                b_st = torch.zeros((n_layers, r, b0.shape[0]), device=dev)
                for i in range(n_layers):
                    if a[i] is not None:
                        a_st[i].copy_(a[i].to(dev).t())
                    if b[i] is not None:
                        b_st[i].copy_(b[i].to(dev).t())
                _ensure_set(block, path_t, {"a": a_st, "b": b_st})
            out[tree_key] = block
    return out


def _strip_peft(key: str) -> str:
    if key.startswith(_PEFT_PREFIX):
        return "transformer." + key[len(_PEFT_PREFIX):]
    return key
