"""FLUX MMDiT transformer in PyTorch (port of unitex_tpu/models/flux/model.py).

19 dual-stream + 38 single-stream blocks, AdaLN-Zero conditioning from
timestep + guidance + pooled embeddings, 3-axis RoPE, QK RMS-norm,
GELU-tanh MLPs.  Block parameters stay stacked [L, ...] as in the JAX
package; the forward walks them with a Python loop (the JAX ``lax.scan``),
taking views of each layer's slice.  Attention goes through ``sdpa``:
kernel B1 on the card, with kernels B2a/B2b as its backward, or with
``cfg.attn_qk8`` the int8-QK serving kernel B3.  The forward dispatches on
the leaf names, so it serves the bf16, int8 and fused trees of
``quantize.py`` alike.

Tensor and sequence parallelism: with ``cfg.tp_axis`` a process group,
the blocks take this rank's Megatron slices (``parallel/sharding.
shard_flux_params``, the config from :func:`tp_config` with the local head
count), gather the AdaLN modulations and sum after each row-parallel
product (``layers.row_linear``, the pre-split ``proj_out`` of the single
blocks).  The collectives are ``parallel/collectives``' autograd
functions, with ``copy_to`` before the column products that read a
replicated activation, so the TP forward trains.  An int8 serving tree
cut the same way runs its W8A8 row products through
``ops/quant.int8_row_matmul`` (the whole row's activation scale, int32
partials summed over the group: the one-device product).
With ``cfg.seq_axis`` a process group, the tokens given are this rank's
block of the sequence and attention runs Ulysses or the ring over the
group (``ops/ring_attention.py``; ``models/flux/sp.flux_forward_sp`` cuts
and gathers the sequence).

The forward runs under autograd (serving callers wrap it in
``torch.no_grad``).  ``cfg.remat`` runs each block under
``torch.utils.checkpoint`` (the JAX ``jax.checkpoint``), and a LoRA tree
passed as ``lora`` is merged into each layer inside its block, so at most
one layer's merged kernels are alive.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...ops.quant import int8_row_matmul
from ...ops.ring_attention import sequence_parallel_attention
from ...parallel.collectives import copy_to, gather_from, reduce_from
from ...utils.params import Spec, init_from_spec, linear_spec
from ...utils.precision import resolve_device
from .config import FluxConfig
from .lora import merge_lora_layer
from .layers import (
    Params,
    apply_rope,
    gelu_tanh,
    layer_norm,
    linear,
    mlp_embedder,
    rms_norm,
    rope_freqs,
    row_linear,
    sdpa,
    sinusoidal_embedding,
)


# ------------------------------------------------------------------ init


def _attn_spec(dim, heads, head_dim, with_context, L):
    inner = heads * head_dim
    p = {
        "to_q": linear_spec(dim, inner, lead=(L,)),
        "to_k": linear_spec(dim, inner, lead=(L,)),
        "to_v": linear_spec(dim, inner, lead=(L,)),
        "norm_q": ("ones", (L, head_dim)),
        "norm_k": ("ones", (L, head_dim)),
    }
    if with_context:
        p.update({
            "add_q_proj": linear_spec(dim, inner, lead=(L,)),
            "add_k_proj": linear_spec(dim, inner, lead=(L,)),
            "add_v_proj": linear_spec(dim, inner, lead=(L,)),
            "norm_added_q": ("ones", (L, head_dim)),
            "norm_added_k": ("ones", (L, head_dim)),
            "to_out": linear_spec(inner, dim, lead=(L,)),
            "to_add_out": linear_spec(inner, dim, lead=(L,)),
        })
    return p


def flux_param_spec(cfg: FluxConfig) -> Spec:
    """The leaf names, shapes and init distributions of the JAX package's
    ``init_flux_params`` (blocks stacked [L, ...])."""
    d = cfg.hidden_size
    H, hd = cfg.num_attention_heads, cfg.attention_head_dim
    L, Ls = cfg.num_layers, cfg.num_single_layers

    def mlp_emb(d_in):
        return {"in": linear_spec(d_in, d), "out": linear_spec(d, d)}

    spec = {
        "x_embedder": linear_spec(cfg.in_channels, d),
        "context_embedder": linear_spec(cfg.joint_attention_dim, d),
        "time_embed": mlp_emb(256),
        "pooled_embed": mlp_emb(cfg.pooled_projection_dim),
        "norm_out": {"lin": linear_spec(d, 2 * d)},
        "proj_out": linear_spec(d, cfg.in_channels),
        "dual_blocks": {
            "norm1": {"lin": linear_spec(d, 6 * d, lead=(L,))},
            "norm1_context": {"lin": linear_spec(d, 6 * d, lead=(L,))},
            "attn": _attn_spec(d, H, hd, True, L),
            "ff": {"in": linear_spec(d, cfg.mlp_dim, lead=(L,)),
                   "out": linear_spec(cfg.mlp_dim, d, lead=(L,))},
            "ff_context": {"in": linear_spec(d, cfg.mlp_dim, lead=(L,)),
                           "out": linear_spec(cfg.mlp_dim, d, lead=(L,))},
        },
        "single_blocks": {
            "norm": {"lin": linear_spec(d, 3 * d, lead=(Ls,))},
            "attn": _attn_spec(d, H, hd, False, Ls),
            "proj_mlp": linear_spec(d, cfg.mlp_dim, lead=(Ls,)),
            "proj_out": linear_spec(d + cfg.mlp_dim, d, lead=(Ls,)),
        },
    }
    if cfg.guidance_embeds:
        spec["guidance_embed"] = mlp_emb(256)
    return spec


def init_flux_params(
    generator: torch.Generator, cfg: FluxConfig, device="cuda",
    dtype: Optional[torch.dtype] = None, hook=None,
) -> Params:
    """Random FLUX tree made on ``device`` in ``dtype`` (default: the
    config's compute dtype) — the same leaf names and shapes as the JAX
    package's ``init_flux_params``; the numbers differ (another PRNG).
    ``hook(path, node)`` replaces each linear node as it is made
    (``parallel/sharding.shard_hook``: this rank's slices of the tree
    every rank draws alike)."""
    if dtype is None:
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return init_from_spec(flux_param_spec(cfg), generator,
                          resolve_device(device), dtype, hook=hook)


def flux_param_shapes(cfg: FluxConfig) -> Params:
    """The FLUX tree's leaves as tensors on the ``meta`` device: the whole
    shapes, no storage (what ``lora.init_lora_params`` reads)."""
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        return torch.empty(spec[1], device="meta")

    return make(flux_param_spec(cfg))


def tp_config(cfg, group):
    """A FLUX or SD3 config for the blocks' Megatron slices over
    ``group``: its ``tp_axis``, and the local head count (as in the JAX
    package, whose tensor-parallel blocks see ``num_attention_heads`` per
    shard)."""
    n = dist.get_world_size(group)
    if cfg.num_attention_heads % n or cfg.mlp_dim % n:
        raise ValueError(f"{cfg.num_attention_heads} heads / mlp "
                         f"{cfg.mlp_dim} do not split over {n} ranks")
    return dataclasses.replace(
        cfg, tp_axis=group, num_attention_heads=cfg.num_attention_heads // n)


def layer(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked [L, ...] block tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: layer(v, i) for k, v in stacked.items()}
    return stacked[i]


# --------------------------------------------------------------- forward


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, heads, -1)


def _attention(cfg: FluxConfig, q, k, v):
    """Attention on [B, S, H, D]: over ``cfg.seq_axis``'s ranks (Ulysses or
    the ring, ``cfg.sp_mode``) when the sequence is cut, else ``sdpa``."""
    def local(a, b, c):
        return sdpa(a, b, c, qk8=cfg.attn_qk8)

    if cfg.seq_axis is not None:
        return sequence_parallel_attention(q, k, v, cfg.seq_axis, cfg.sp_mode,
                                           attn_fn=local)
    return local(q, k, v)


def _joint_attention(p, cfg, hidden, context, cos, sin, kv_keep_idx=None):
    """Dual-stream joint attention: text tokens first in the sequence.
    ``kv_keep_idx`` [S_kept] subselects the joint K/V sequence (queries
    stay full): the training-time token dropping of the reference's
    RandomDropFluxAttnProcessor2_0."""
    H = cfg.num_attention_heads
    if "qkv_fused" in p:
        # fused serving form (quantize.py): one wide projection per stream
        q, k, v = (_heads(x, H) for x in torch.chunk(
            linear(p["qkv_fused"], hidden), 3, dim=-1))
        cq, ck, cv = (_heads(x, H) for x in torch.chunk(
            linear(p["add_qkv_fused"], context), 3, dim=-1))
    else:
        q = _heads(linear(p["to_q"], hidden), H)
        k = _heads(linear(p["to_k"], hidden), H)
        v = _heads(linear(p["to_v"], hidden), H)
        cq = _heads(linear(p["add_q_proj"], context), H)
        ck = _heads(linear(p["add_k_proj"], context), H)
        cv = _heads(linear(p["add_v_proj"], context), H)
    q = rms_norm(q, p["norm_q"])
    k = rms_norm(k, p["norm_k"])
    cq = rms_norm(cq, p["norm_added_q"])
    ck = rms_norm(ck, p["norm_added_k"])
    q = apply_rope(torch.cat([cq, q], dim=1), cos, sin)
    k = apply_rope(torch.cat([ck, k], dim=1), cos, sin)
    v = torch.cat([cv, v], dim=1)
    if kv_keep_idx is not None:
        k, v = k[:, kv_keep_idx], v[:, kv_keep_idx]
    out = _attention(cfg, q, k, v)
    out = out.reshape(out.shape[0], out.shape[1], -1)
    S_txt = context.shape[1]
    ctx_out, img_out = out[:, :S_txt], out[:, S_txt:]
    return (row_linear(p["to_out"], img_out, cfg.tp_axis),
            row_linear(p["to_add_out"], ctx_out, cfg.tp_axis))


def _single_attention(p, cfg, x, cos, sin, qkv=None, kv_keep_idx=None):
    """``qkv``: the q/k/v projections, when the fused serving projection
    has already computed them."""
    H = cfg.num_attention_heads
    if qkv is None:
        qkv = (linear(p["to_q"], x), linear(p["to_k"], x), linear(p["to_v"], x))
    qf, kf, vf = qkv
    q = rms_norm(_heads(qf, H), p["norm_q"])
    k = rms_norm(_heads(kf, H), p["norm_k"])
    v = _heads(vf, H)
    k = apply_rope(k, cos, sin)
    if kv_keep_idx is not None:
        k, v = k[:, kv_keep_idx], v[:, kv_keep_idx]
    out = _attention(cfg, apply_rope(q, cos, sin), k, v)
    return out.reshape(out.shape[0], out.shape[1], -1)


def _ada_ln_zero(p, temb, n=6, group=None):
    """The block's ``n`` modulations [B, 1, d] each.  Under tensor
    parallelism ``lin`` holds this rank's columns, and the [B, n·d/ranks]
    slices are gathered; a ``lin`` left whole (the TP x PP layout,
    ``pp._tp_pp_leaf_spec``) is computed whole on every rank."""
    x = F.silu(temb)
    kernel = next(p["lin"][k] for k in ("kernel", "kernel_int8_wo",
                                        "kernel_int8") if k in p["lin"])
    cut = group is not None and kernel.shape[-1] < n * temb.shape[-1]
    if cut:
        x = copy_to(x, group)
    mods = linear(p["lin"], x)
    if cut:
        mods = gather_from(mods, group, dim=-1)
    return torch.chunk(mods[:, None, :], n, dim=-1)


def _col_input(x, cfg):
    """A replicated activation entering column-parallel products: its
    gradient is summed over the TP ranks."""
    return x if cfg.tp_axis is None else copy_to(x, cfg.tp_axis)


def _dual_block(p, cfg, hidden, context, temb, cos, sin, kv_keep_idx=None):
    tp = cfg.tp_axis
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = _ada_ln_zero(p["norm1"], temb, 6, tp)
    csh_a, csc_a, cg_a, csh_m, csc_m, cg_m = _ada_ln_zero(
        p["norm1_context"], temb, 6, tp)
    h_norm = _col_input(layer_norm(hidden) * (1 + sc_a) + sh_a, cfg)
    c_norm = _col_input(layer_norm(context) * (1 + csc_a) + csh_a, cfg)
    h_attn, c_attn = _joint_attention(p["attn"], cfg, h_norm, c_norm, cos, sin,
                                      kv_keep_idx)
    hidden = hidden + g_a * h_attn
    context = context + cg_a * c_attn
    h_mlp = _col_input(layer_norm(hidden) * (1 + sc_m) + sh_m, cfg)
    hidden = hidden + g_m * row_linear(
        p["ff"]["out"], gelu_tanh(linear(p["ff"]["in"], h_mlp)), tp)
    c_mlp = _col_input(layer_norm(context) * (1 + csc_m) + csh_m, cfg)
    context = context + cg_m * row_linear(
        p["ff_context"]["out"], gelu_tanh(linear(p["ff_context"]["in"], c_mlp)),
        tp)
    return hidden, context


def _single_block(p, cfg, x, temb, cos, sin, kv_keep_idx=None):
    sh, sc, gate = _ada_ln_zero(p["norm"], temb, 3, cfg.tp_axis)
    x_norm = _col_input(layer_norm(x) * (1 + sc) + sh, cfg)
    if "qkvm_fused" in p:
        d = cfg.hidden_size
        fused = linear(p["qkvm_fused"], x_norm)
        qkv = (fused[..., :d], fused[..., d:2 * d], fused[..., 2 * d:3 * d])
        attn_out = _single_attention(p["attn"], cfg, x_norm, cos, sin, qkv,
                                     kv_keep_idx)
        mlp_out = gelu_tanh(fused[..., 3 * d:])
    else:
        attn_out = _single_attention(p["attn"], cfg, x_norm, cos, sin,
                                     kv_keep_idx=kv_keep_idx)
        mlp_out = gelu_tanh(linear(p["proj_mlp"], x_norm))
    po = p["proj_out"]
    if "kernel_attn" in po or "kernel_int8_attn" in po:
        return x + gate * _split_proj_out(po, attn_out, mlp_out, cfg.tp_axis)
    merged = torch.cat([attn_out, mlp_out], dim=-1)
    return x + gate * linear(po, merged)


def _split_proj_out(po, attn_out, mlp_out, group):
    """The single block's ``proj_out`` under tensor parallelism: its input
    rows interleave [attn ‖ mlp], so it comes pre-split
    (parallel/sharding.py), each part holding this rank's rows.  The
    partial products sum over the ranks and the bias is added once.  W8A8
    parts take one activation scale, the amax over both local parts then
    MAX over the group, and sum their int32 products locally, then over
    the group: the one-device ``linear(po, cat([attn_out, mlp_out]))``.
    An attached LoRA's ``lora_a`` holds this rank's attn rows, then its
    mlp rows."""
    dtype = attn_out.dtype
    lora = None
    if "lora_a" in po:
        a, n = po["lora_a"].to(dtype), attn_out.shape[-1]
        lora = (attn_out @ a[..., :n, :] + mlp_out @ a[..., n:, :]) \
            @ po["lora_b"].to(dtype)
    if "kernel_int8_attn" in po:
        y = int8_row_matmul([attn_out, mlp_out], [po["kernel_int8_attn"],
                                                  po["kernel_int8_mlp"]],
                            po["scale"], group)
        if lora is not None:
            y = y + reduce_from(lora, group)
    else:
        y = attn_out @ po["kernel_attn"].to(dtype) \
            + mlp_out @ po["kernel_mlp"].to(dtype)
        if lora is not None:
            y = y + lora
        y = reduce_from(y, group)
    if "bias" in po:
        y = y + po["bias"].to(dtype)
    return y


def cast_tree(tree, dtype: Optional[torch.dtype]):
    """``tree`` with its f32 leaves cast to ``dtype`` (under autograd: the
    gradients reach the f32 leaves); ``dtype=None`` is ``tree``."""
    if dtype is None:
        return tree
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


def _block_params(params: Params, lora: Optional[Dict[str, Any]], stack: str,
                  i: int, compute_dtype: Optional[torch.dtype] = None) -> Params:
    """Layer ``i`` of a block stack, with its LoRA merged when given, its f32
    leaves cast to ``compute_dtype`` when given."""
    p = cast_tree(layer(params[stack], i), compute_dtype)
    if lora is not None and stack in lora:
        p = merge_lora_layer(p, layer(lora[stack], i))
    return p


def flux_forward(
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
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Velocity prediction for the packed token sequence.

    hidden_states [B, S_img, C_in], encoder_hidden_states [B, S_txt, D_t5],
    timestep [B] (already divided by 1000), pooled [B, D_clip],
    img_ids [S_img, 3], txt_ids [S_txt, 3], guidance [B] (raw cfg scale).
    ``lora``: an adapter tree merged with weight 1 into each block's
    kernels inside the block (the JAX trainer's ``merge_lora`` of the whole
    tree before the forward, one layer at a time; under tensor
    parallelism a tree cut by ``shard_flux_params``, whose merge yields this
    rank's slices).  ``kv_keep_idx`` [S_kept] (indices into the joint
    [txt ‖ img] sequence) keeps those keys and values in every attention.
    ``compute_dtype``: the f32 leaves are cast to it as they are used (the
    blocks' inside each block, so one layer's copy is alive at a time):
    the bf16 compute over f32 masters of full fine-tuning.
    Returns [B, S_img, C_in] f32."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    top = {k: v for k, v in params.items()
           if k not in ("dual_blocks", "single_blocks")}
    params = {**cast_tree(top, compute_dtype),
              "dual_blocks": params["dual_blocks"],
              "single_blocks": params["single_blocks"]}
    hidden = linear(params["x_embedder"], hidden_states.to(dtype))
    context = linear(params["context_embedder"], encoder_hidden_states.to(dtype))

    temb = mlp_embedder(params["time_embed"],
                        sinusoidal_embedding(timestep).to(dtype))
    if cfg.guidance_embeds and guidance is not None:
        temb = temb + mlp_embedder(
            params["guidance_embed"], sinusoidal_embedding(guidance).to(dtype))
    temb = temb + mlp_embedder(params["pooled_embed"],
                               pooled_projections.to(dtype))

    ids = torch.cat([txt_ids, img_ids], dim=0)
    cos, sin = rope_freqs(ids, cfg.axes_dims_rope, cfg.rope_theta)

    def dual(i, h, c):
        return _dual_block(_block_params(params, lora, "dual_blocks", i,
                                         compute_dtype), cfg,
                           h, c, temb, cos, sin, kv_keep_idx)

    def single(i, x):
        return _single_block(_block_params(params, lora, "single_blocks", i,
                                           compute_dtype),
                             cfg, x, temb, cos, sin, kv_keep_idx)

    def run(fn, *args):
        if cfg.remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    for i in range(cfg.num_layers):
        hidden, context = run(dual, i, hidden, context)
    x = torch.cat([context, hidden], dim=1)
    for i in range(cfg.num_single_layers):
        x = run(single, i, x)
    x = x[:, context.shape[1]:]

    # AdaLayerNormContinuous chunks (scale, shift) in that order
    sc, sh = _ada_ln_zero(params["norm_out"], temb, 2)
    x = layer_norm(x) * (1 + sc) + sh
    return linear(params["proj_out"], x).float()
