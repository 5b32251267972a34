"""diffusers ``SD3Transformer2DModel`` state dict -> the port's SD3 tree
(port of unitex_tpu/models/sd3/loader.py), in the idiom of
``models/flux/loader.py``: each leaf allocated once on the device in its
final dtype and filled layer by layer from the memory-mapped shards.  The
SD3 VAE loads through ``models/flux/loader.load_vae`` with
``VAEConfig.sd3()``.  With ``int8_serving`` the blocks' linear nodes are
quantized (``ops/quant.quantize_linears``' W8A8) as they are filled, and
with a ``mesh`` then cut to this rank's tensor-parallel slices."""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional

import torch

from ...parallel.sharding import shard_hook
from ...utils.precision import resolve_device
from ..flux.loader import _lin, _materialize, iter_safetensors
from .config import SD3Config


def _block_names(sd: Mapping, prefix: str, probe: str, with_ctx: bool):
    """One joint block's name tree; ``prefix`` may hold "{i}" (a stacked
    block), ``probe`` is the prefix of a block the state dict has."""

    def lin(name):
        return _lin(sd, f"{prefix}.{name}", probe=f"{probe}.{name}")

    attn = {
        "to_q": lin("attn.to_q"), "to_k": lin("attn.to_k"),
        "to_v": lin("attn.to_v"), "add_q_proj": lin("attn.add_q_proj"),
        "add_k_proj": lin("attn.add_k_proj"),
        "add_v_proj": lin("attn.add_v_proj"), "to_out": lin("attn.to_out.0"),
    }
    p = {
        "norm1": {"lin": lin("norm1.linear")},
        "norm1_context": {"lin": lin("norm1_context.linear")},
        "attn": attn,
        "ff": {"in": lin("ff.net.0.proj"), "out": lin("ff.net.2")},
    }
    if with_ctx:
        attn["to_add_out"] = lin("attn.to_add_out")
        p["ff_context"] = {"in": lin("ff_context.net.0.proj"),
                           "out": lin("ff_context.net.2")}
    return p


def _copy_to(src: torch.Tensor, device, dtype) -> torch.Tensor:
    out = torch.empty(src.shape, dtype=dtype or src.dtype, device=device)
    return out.copy_(src.to(device))


def sd3_params_from_state_dict(
    sd: Mapping, cfg: SD3Config, device="cuda",
    dtype: Optional[torch.dtype] = None, mesh=None, int8_serving=False,
) -> Dict[str, Any]:
    """Map a diffusers ``SD3Transformer2DModel`` state dict (tensors or
    numpy arrays by name) into the ``init_sd3_params`` tree on ``device``,
    cast to ``dtype`` (default: as stored); with ``int8_serving``, its
    block projections in W8A8; with ``mesh``, this rank's
    tensor-parallel slices of it, each node quantized whole first.  The ``PatchEmbed`` conv
    [d, C, ps, ps] becomes a linear over (C, ph, pw)-flattened patches and
    the [1, pmax², d] position table a [pmax, pmax, d] one."""
    from ..flux.quantize import quantize_hook

    dev = resolve_device(device)
    hook = quantize_hook(bool(int8_serving),
                         None if mesh is None else shard_hook(mesh))

    def embedder(prefix):
        return {"in": _lin(sd, f"{prefix}.linear_1"),
                "out": _lin(sd, f"{prefix}.linear_2")}

    params = _materialize({
        "context_embedder": _lin(sd, "context_embedder"),
        "time_embed": embedder("time_text_embed.timestep_embedder"),
        "pooled_embed": embedder("time_text_embed.text_embedder"),
        "norm_out": {"lin": _lin(sd, "norm_out.linear")},
        "proj_out": _lin(sd, "proj_out"),
    }, sd, dev, dtype)
    conv_w = torch.as_tensor(sd["pos_embed.proj.weight"])
    pmax = cfg.pos_embed_max_size
    params["pos_embed"] = {
        "proj": {
            "kernel": _copy_to(conv_w.reshape(conv_w.shape[0], -1).t(), dev,
                               dtype),
            "bias": _copy_to(torch.as_tensor(sd["pos_embed.proj.bias"]), dev,
                             dtype),
        },
        "pos": _copy_to(torch.as_tensor(sd["pos_embed.pos_embed"])
                        .reshape(pmax, pmax, -1), dev, dtype),
    }
    last = cfg.num_layers - 1
    b = "transformer_blocks"
    params["blocks"] = _materialize(
        _block_names(sd, f"{b}.{{i}}", f"{b}.0", True), sd, dev, dtype, last,
        hook, ("blocks",))
    params["final_block"] = _materialize(
        _block_names(sd, f"{b}.{last}", f"{b}.{last}", False), sd, dev, dtype,
        None, hook, ("final_block",))
    return params


def load_sd3_transformer(
    path: str, cfg: SD3Config, device="cuda",
    dtype: Optional[torch.dtype] = None, mesh=None, int8_serving=False,
) -> Dict[str, Any]:
    """The SD3 transformer tree of a diffusers model directory (or one
    ``.safetensors`` file), streamed onto ``device`` (with
    ``int8_serving``: W8A8 as it is read; with ``mesh``: this rank's
    slices)."""
    with iter_safetensors(path) as sd:
        return sd3_params_from_state_dict(sd, cfg, device, dtype, mesh,
                                          int8_serving)
