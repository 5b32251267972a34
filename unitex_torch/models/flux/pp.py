"""Pipeline-parallel FLUX forward: the MMDiT block stacks staged over the
``pipe`` ranks of a mesh (port of unitex_tpu/models/flux/pp.py).

The numerics of :func:`~.model.flux_forward`, with the 19 dual and 38
single blocks cut into contiguous stages (each padded with zero blocks to
a multiple of the pipe size: at P = 4, 19 -> 20 and 38 -> 40) and the
microbatches flowing through one chained GPipe schedule
(``parallel/pipeline.pipeline_apply_chain``): the dual -> single handoff
rides the ring's ``P-1 -> 0`` hop.  A padded block is skipped (its
``_valid`` flag is 0), under tensor parallelism too: every rank of a
stage's model group skips it alike.  The embedders and the final layer
run on every stage, as in the JAX package; the last stage's blocks'
output is broadcast to every stage.

Each rank holds its stage's layers only: :func:`prepare_flux_params_pp`
(and :func:`prepare_lora_pp` for an adapter) pad, tag and cut the stacks
once, and :func:`strip_lora_padding` recovers the portable adapter from
the stages' gathered layers (:func:`gather_stages`).  With ``tp_axis``
the stages also run Megatron tensor parallelism on the slices of
:func:`prepare_flux_params_tp_pp` (the 3-axis data x model x pipe
layout); with ``data_axis`` each microbatch is cut over the data ranks.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ...parallel.pipeline import pad_stacked_blocks, pipeline_apply_chain, stage_slice
from ...parallel.sharding import cut, gather, shard_node, shard_tree
from .config import FluxConfig
from .layers import Params, layer_norm, linear, mlp_embedder, rope_freqs, sinusoidal_embedding
from .model import (
    _ada_ln_zero,
    _block_params,
    _dual_block,
    _single_block,
    cast_tree,
    tp_config,
)

_STAGED = ("dual_blocks", "single_blocks")


def _with_valid(stacked: Params) -> Params:
    if "_valid" in stacked:
        return stacked
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return {**stacked, "_valid": torch.ones((_depth(stacked),),
                                            device=leaf.device)}


def _staged(stacked: Params, pipe_axis) -> Params:
    """This stage's layers of a stack, padded and tagged unless prepared
    (:func:`prepare_flux_params_pp`)."""
    if "_valid" in stacked:
        return stacked
    return stage_slice(pad_stacked_blocks(_with_valid(stacked),
                                          dist.get_world_size(pipe_axis)),
                       pipe_axis)


def flux_forward_pp(
    params: Params,
    cfg: FluxConfig,
    hidden_states: torch.Tensor,
    encoder_hidden_states: torch.Tensor,
    timestep: torch.Tensor,
    pooled_projections: torch.Tensor,
    img_ids: torch.Tensor,
    txt_ids: torch.Tensor,
    guidance: Optional[torch.Tensor] = None,
    kv_keep_idx: Optional[torch.Tensor] = None,
    *,
    n_micro: int,
    pipe_axis,
    data_axis=None,
    tp_axis=None,
    lora: Optional[Dict[str, Any]] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Pipeline-parallel :func:`~.model.flux_forward` over the process
    group ``pipe_axis`` (``Mesh.group("pipe")``).  The batch B must divide
    ``n_micro`` (and, with ``data_axis``, the microbatch B/n_micro that
    group's size).  ``params``: the whole tree (its stacks are padded and
    cut here) or this stage's from :func:`prepare_flux_params_pp`;
    ``lora`` likewise (:func:`prepare_lora_pp`), merged into each block
    inside it.  ``tp_axis``: tensor parallelism within each stage, on
    params from :func:`prepare_flux_params_tp_pp`.  Every rank calls it
    with the same arguments and gets [B, S_img, C_in] f32."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    top = {k: v for k, v in params.items() if k not in _STAGED}
    top = cast_tree(top, compute_dtype)
    hidden = linear(top["x_embedder"], hidden_states.to(dtype))
    context = linear(top["context_embedder"], encoder_hidden_states.to(dtype))
    temb = mlp_embedder(top["time_embed"],
                        sinusoidal_embedding(timestep).to(dtype))
    if cfg.guidance_embeds and guidance is not None:
        temb = temb + mlp_embedder(top["guidance_embed"],
                                   sinusoidal_embedding(guidance).to(dtype))
    temb = temb + mlp_embedder(top["pooled_embed"], pooled_projections.to(dtype))

    ids = torch.cat([txt_ids, img_ids], dim=0)
    cos, sin = rope_freqs(ids, cfg.axes_dims_rope, cfg.rope_theta)
    shared = (cos, sin, kv_keep_idx)

    B = hidden.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    S_txt = context.shape[1]

    def micro(x):
        return x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))

    pack = micro(torch.cat([context, hidden], dim=1))
    temb_m = micro(temb)
    cfg_blk = tp_config(cfg, tp_axis) if tp_axis is not None else cfg
    if tp_axis is not None and not (
            "_valid" in params["dual_blocks"]
            and "kernel_attn" in params["single_blocks"]["proj_out"]):
        raise ValueError("tp_axis needs params from prepare_flux_params_tp_pp")

    stacks = {s: _staged(params[s], pipe_axis) for s in _STAGED}
    valid = {s: stacks[s]["_valid"].tolist() for s in _STAGED}
    adapters = None
    if lora is not None:
        # an adapter as deep as this stage's stack is prepared already
        adapters = {s: lora[s] if _depth(lora[s]) == len(valid[s])
                    else stage_slice(pad_stacked_blocks(
                        lora[s], dist.get_world_size(pipe_axis)), pipe_axis)
                    for s in _STAGED if s in lora}

    def run(fn, *args):
        if cfg.remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def dual_stage(blocks, x, temb_mb, sh):
        cos, sin, keep = sh
        c, h = x[:, :S_txt], x[:, S_txt:]

        def one(i, hh, cc):
            p = _block_params(blocks, adapters, "dual_blocks", i, compute_dtype)
            return _dual_block(p, cfg_blk, hh, cc, temb_mb, cos, sin, keep)

        for i, ok in enumerate(valid["dual_blocks"]):
            if ok > 0.5:
                h, c = run(one, i, h, c)
        return torch.cat([c, h], dim=1)

    def single_stage(blocks, x, temb_mb, sh):
        cos, sin, keep = sh

        def one(i, xx):
            p = _block_params(blocks, adapters, "single_blocks", i,
                              compute_dtype)
            return _single_block(p, cfg_blk, xx, temb_mb, cos, sin, keep)

        for i, ok in enumerate(valid["single_blocks"]):
            if ok > 0.5:
                x = run(one, i, x)
        return x

    def strip(stack):
        return {k: v for k, v in stack.items() if k != "_valid"}

    pack = pipeline_apply_chain(
        dual_stage, {"dual_blocks": strip(stacks["dual_blocks"])},
        single_stage, {"single_blocks": strip(stacks["single_blocks"])},
        pack, temb_m, shared, pipe_axis, data_axis)

    x = pack.reshape((B,) + tuple(pack.shape[2:]))[:, S_txt:]
    sc, sh_ = _ada_ln_zero(top["norm_out"], temb, 2)
    x = layer_norm(x) * (1 + sc) + sh_
    return linear(top["proj_out"], x).float()


def _depth(stack) -> int:
    while isinstance(stack, dict):
        stack = next(iter(stack.values()))
    return stack.shape[0]


_TP_COL = {"to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
           "proj_mlp"}
_TP_ROW = {"to_out", "to_add_out"}


def _tp_pp_leaf_spec(path) -> Optional[int]:
    """The dimension a stacked-block leaf is cut along over the model ranks
    under the TP x PP layout (its layer axis 0 is cut over the pipe
    stages), or None: column kernels and biases by their output dim,
    row kernels and the pre-split ``proj_out`` parts by their input dim;
    norms, the AdaLN modulations, the row biases and ``_valid`` whole (the
    JAX package's ``PartitionSpec``s)."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    gp = path[-3] if len(path) > 2 else ""
    col = parent in _TP_COL or (parent == "in" and gp in ("ff", "ff_context"))
    row = parent in _TP_ROW or (parent == "out" and gp in ("ff", "ff_context"))
    if name in ("kernel_attn", "kernel_mlp") and parent == "proj_out":
        return 1
    if col and name == "kernel":
        return 2
    if col and name == "bias":
        return 1
    if row and name == "kernel":
        return 1
    return None


def _cut_leaves(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _cut_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def prepare_flux_params_tp_pp(params: Params, cfg: FluxConfig, mesh,
                              tp_axis: str = "model",
                              pipe_axis: str = "pipe") -> Params:
    """This rank's part of the 3-axis (data x model x pipe) layout: the
    stacks padded and tagged as :func:`prepare_flux_params_pp` does, the
    single blocks' ``proj_out`` pre-split into its attn and mlp row blocks
    (its input rows interleave the two streams), this stage's layers, each
    leaf cut over the model ranks by :func:`_tp_pp_leaf_spec`; the rest
    whole."""
    n, m = mesh.size(tp_axis), mesh.index(tp_axis)
    if cfg.num_attention_heads % n or cfg.mlp_dim % n:
        raise ValueError(f"{cfg.num_attention_heads} heads / mlp "
                         f"{cfg.mlp_dim} do not split over model={n}")
    group = mesh.group(pipe_axis)
    out = {k: v for k, v in params.items() if k not in _STAGED}
    for name in _STAGED:
        sub = pad_stacked_blocks(_with_valid(params[name]), mesh.size(pipe_axis))
        if name == "single_blocks":
            po = sub["proj_out"]
            if "kernel" not in po:
                raise ValueError("int8 or fused trees are not staged under "
                                 "TP x PP")
            d = cfg.hidden_size
            sub = {**sub, "proj_out": {
                "kernel_attn": po["kernel"][:, :d],
                "kernel_mlp": po["kernel"][:, d:],
                **({"bias": po["bias"]} if "bias" in po else {})}}
        sub = stage_slice(sub, group)

        def leaf(path, x, name=name):
            dim = _tp_pp_leaf_spec((name,) + path)
            return x if dim is None else cut(x, dim, m, n)

        out[name] = _cut_leaves(sub, leaf)
    return out


def prepare_lora_pp(lora: Params, mesh, pipe_axis: str = "pipe",
                    tp_axis: Optional[str] = None) -> Params:
    """The adapter's twin of :func:`prepare_flux_params_pp` for pipelined
    training: its block stacks padded to the pipe multiple and cut to this
    stage's layers (copies, which train in place).  The padded layers are
    zero and get a zero gradient (their base blocks are skipped), so they
    stay zero under AdamW and Prodigy; :func:`strip_lora_padding` recovers
    the portable adapter.  With ``tp_axis`` the layers are also cut over
    the model ranks as ``parallel/sharding.shard_node`` cuts an adapter."""
    group = mesh.group(pipe_axis)
    out = {}
    for name, sub in lora.items():
        if name in _STAGED:
            sub = stage_slice(pad_stacked_blocks(sub, mesh.size(pipe_axis)),
                              group)
            if tp_axis is not None:
                part, n = mesh.index(tp_axis), mesh.size(tp_axis)
                sub = shard_tree(sub, lambda path, node: shard_node(
                    path, node, part, n), (name,))
        out[name] = _clone(sub)
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def gather_stages(tree: Params, mesh, pipe_axis: str = "pipe") -> Params:
    """The padded whole stacks from every stage's layers (on every rank of
    the pipe group); the other leaves as they are."""
    group = mesh.group(pipe_axis)
    out = dict(tree)
    for name in _STAGED:
        if name in out:
            out[name] = _cut_leaves(out[name], lambda path, x: gather(
                x.detach().contiguous(), group, 0))
    return out


def strip_lora_padding(lora: Params, cfg: FluxConfig) -> Params:
    """The pipe padding sliced off a padded adapter tree: the portable
    adapter with the model's true block depths."""
    out = dict(lora)
    if "dual_blocks" in out:
        out["dual_blocks"] = _cut_leaves(out["dual_blocks"],
                                         lambda _, x: x[:cfg.num_layers])
    if "single_blocks" in out:
        out["single_blocks"] = _cut_leaves(
            out["single_blocks"], lambda _, x: x[:cfg.num_single_layers])
    return out


def prepare_flux_params_pp(params: Params, mesh,
                           pipe_axis: str = "pipe") -> Params:
    """This stage's part of a tree for the pipelined forward: the block
    stacks padded to a multiple of the pipe size, their ``_valid`` flags
    tagged (0 on the padding), cut to this stage's contiguous layers
    (views: free the whole tree to keep only them); the embedders,
    ``norm_out`` and ``proj_out`` whole on every stage.
    :func:`flux_forward_pp` takes the prepared stacks as they are."""
    group = mesh.group(pipe_axis)
    out = {k: v for k, v in params.items() if k not in _STAGED}
    for name in _STAGED:
        out[name] = stage_slice(pad_stacked_blocks(
            _with_valid(params[name]), mesh.size(pipe_axis)), group)
    return out
