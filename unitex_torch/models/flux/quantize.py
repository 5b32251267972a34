"""FLUX int8 serving transform (port of unitex_tpu/models/flux/quantize.py).

``quantize_flux_params`` turns a FLUX tree into the int8 serving form
through ``ops/quant.quantize_linears``: the v/out/MLP projections inside
the blocks become W8A8; q/k projections, norms, AdaLN modulations and
embedders stay bf16, or with ``weight_only_rest=True`` (the "max_memory"
mode) the block kernels among them become weight-only int8.

``fuse_flux_projections`` concatenates the q/k/v kernels of each stream
of a dual block, and q/k/v + MLP-in of a single block, into one wide
projection (numerically the same products; off by default, as in the JAX
package).  ``flux_forward`` dispatches on the leaf names, so one forward
serves the bf16, int8 and fused trees.

``quantize_hook`` is the same transform for one linear node as it is
made (the loaders' and the random init's ``hook``), composed with a
tensor-parallel cut (``parallel/sharding.shard_hook``): each whole node
is quantized, then cut, so a row kernel's per-channel scale is over the
whole d_in, as the JAX package quantizes the whole tree before it
shards it, and a rank holds its slices and one whole node at a time.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ...ops.quant import _in_blocks, quantize_linears, quantize_node


def _fuse(*linears: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Concatenate [.., d_in, d_out_i] linears along the output axis."""
    out = {"kernel": torch.cat([l["kernel"] for l in linears], dim=-1)}
    if all("bias" in l for l in linears):
        out["bias"] = torch.cat([l["bias"] for l in linears], dim=-1)
    return out


def fuse_flux_projections(params: Dict[str, Any]) -> Dict[str, Any]:
    """A new tree with qkv (dual, per stream) and qkv + MLP-in (single)
    kernels fused; other leaves are shared.  Works on stacked [L, ...]
    block leaves."""
    params = dict(params)

    dual = dict(params["dual_blocks"])
    attn = dict(dual["attn"])
    attn["qkv_fused"] = _fuse(attn.pop("to_q"), attn.pop("to_k"),
                              attn.pop("to_v"))
    attn["add_qkv_fused"] = _fuse(attn.pop("add_q_proj"),
                                  attn.pop("add_k_proj"),
                                  attn.pop("add_v_proj"))
    dual["attn"] = attn
    params["dual_blocks"] = dual

    single = dict(params["single_blocks"])
    sattn = dict(single["attn"])
    single["qkvm_fused"] = _fuse(sattn.pop("to_q"), sattn.pop("to_k"),
                                 sattn.pop("to_v"), single.pop("proj_mlp"))
    single["attn"] = sattn
    params["single_blocks"] = single
    return params


def quantize_flux_params(
    params: Dict[str, Any], fuse: bool = False, weight_only_rest: bool = False,
    consume: bool = False,
) -> Dict[str, Any]:
    """FLUX params (LoRA merged or not) -> int8 serving params.

    ``fuse``: fuse the projections first (:func:`fuse_flux_projections`).
    ``weight_only_rest``: the "max_memory" mode, weight-only int8 for the
    block kernels that W8A8 skips.  ``consume``: drop each float kernel
    from ``params`` as it is quantized (``quantize_linears``), so the bf16
    and the int8 tree are never both whole."""
    if fuse:
        params = fuse_flux_projections(params)
    return quantize_linears(
        params,
        weight_only_predicate=_in_blocks if weight_only_rest else None,
        consume=consume,
    )


def quantize_hook(int8_serving, then: Optional[Callable] = None):
    """``hook(path, node)`` for a tree's linear nodes as they are made:
    the node quantized as :func:`quantize_flux_params` quantizes it
    (``int8_serving``: True for W8A8, "max_memory" for W8A8 plus
    weight-only int8; False leaves it float), its float kernel dropped,
    then passed to ``then`` (a tensor-parallel cut) when given.  None
    when there is nothing to do."""
    if not int8_serving:
        return then
    wo = _in_blocks if int8_serving == "max_memory" else None

    def hook(path, node):
        node = quantize_node(path, node, weight_only_predicate=wo,
                             consume=True)
        return node if then is None else then(path, node)

    return hook
