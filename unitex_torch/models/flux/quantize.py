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
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ...ops.quant import _in_blocks, quantize_linears


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
