"""FLUX MMDiT transformer in PyTorch (port of unitex_tpu/models/flux/model.py).

19 dual-stream + 38 single-stream blocks, AdaLN-Zero conditioning from
timestep + guidance + pooled embeddings, 3-axis RoPE, QK RMS-norm,
GELU-tanh MLPs.  Block parameters stay stacked [L, ...] as in the JAX
package; the forward walks them with a Python loop (the JAX ``lax.scan``),
taking views of each layer's slice.  Attention goes through ``sdpa``:
kernel B1 on the card, with kernels B2a/B2b as its backward.

The forward runs under autograd (serving callers wrap it in
``torch.no_grad``).  ``cfg.remat`` runs each block under
``torch.utils.checkpoint`` (the JAX ``jax.checkpoint``), and a LoRA tree
passed as ``lora`` is merged into each layer inside its block, so at most
one layer's merged kernels are alive.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """Random FLUX tree made on ``device`` in ``dtype`` (default: the
    config's compute dtype) — the same leaf names and shapes as the JAX
    package's ``init_flux_params``; the numbers differ (another PRNG)."""
    if dtype is None:
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return init_from_spec(flux_param_spec(cfg), generator,
                          resolve_device(device), dtype)


def layer(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked [L, ...] block tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: layer(v, i) for k, v in stacked.items()}
    return stacked[i]


# --------------------------------------------------------------- forward


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, heads, -1)


def _joint_attention(p, cfg, hidden, context, cos, sin):
    """Dual-stream joint attention: text tokens first in the sequence."""
    H = cfg.num_attention_heads
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
    out = sdpa(q, k, v)
    out = out.reshape(out.shape[0], out.shape[1], -1)
    S_txt = context.shape[1]
    ctx_out, img_out = out[:, :S_txt], out[:, S_txt:]
    return linear(p["to_out"], img_out), linear(p["to_add_out"], ctx_out)


def _single_attention(p, cfg, x, cos, sin):
    H = cfg.num_attention_heads
    q = rms_norm(_heads(linear(p["to_q"], x), H), p["norm_q"])
    k = rms_norm(_heads(linear(p["to_k"], x), H), p["norm_k"])
    v = _heads(linear(p["to_v"], x), H)
    out = sdpa(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)
    return out.reshape(out.shape[0], out.shape[1], -1)


def _ada_ln_zero(p, temb, n=6):
    mods = linear(p["lin"], F.silu(temb))
    return torch.chunk(mods[:, None, :], n, dim=-1)


def _dual_block(p, cfg, hidden, context, temb, cos, sin):
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = _ada_ln_zero(p["norm1"], temb, 6)
    csh_a, csc_a, cg_a, csh_m, csc_m, cg_m = _ada_ln_zero(
        p["norm1_context"], temb, 6)
    h_norm = layer_norm(hidden) * (1 + sc_a) + sh_a
    c_norm = layer_norm(context) * (1 + csc_a) + csh_a
    h_attn, c_attn = _joint_attention(p["attn"], cfg, h_norm, c_norm, cos, sin)
    hidden = hidden + g_a * h_attn
    context = context + cg_a * c_attn
    h_mlp = layer_norm(hidden) * (1 + sc_m) + sh_m
    hidden = hidden + g_m * linear(
        p["ff"]["out"], gelu_tanh(linear(p["ff"]["in"], h_mlp)))
    c_mlp = layer_norm(context) * (1 + csc_m) + csh_m
    context = context + cg_m * linear(
        p["ff_context"]["out"], gelu_tanh(linear(p["ff_context"]["in"], c_mlp)))
    return hidden, context


def _single_block(p, cfg, x, temb, cos, sin):
    sh, sc, gate = _ada_ln_zero(p["norm"], temb, 3)
    x_norm = layer_norm(x) * (1 + sc) + sh
    attn_out = _single_attention(p["attn"], cfg, x_norm, cos, sin)
    mlp_out = gelu_tanh(linear(p["proj_mlp"], x_norm))
    merged = torch.cat([attn_out, mlp_out], dim=-1)
    return x + gate * linear(p["proj_out"], merged)


def _block_params(params: Params, lora: Optional[Dict[str, Any]], stack: str,
                  i: int) -> Params:
    """Layer ``i`` of a block stack, with its LoRA merged when given."""
    p = layer(params[stack], i)
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
) -> torch.Tensor:
    """Velocity prediction for the packed token sequence.

    hidden_states [B, S_img, C_in], encoder_hidden_states [B, S_txt, D_t5],
    timestep [B] (already divided by 1000), pooled [B, D_clip],
    img_ids [S_img, 3], txt_ids [S_txt, 3], guidance [B] (raw cfg scale).
    ``lora``: an adapter tree merged with weight 1 into each block's
    kernels inside the block (the JAX trainer's ``merge_lora`` of the whole
    tree before the forward, one layer at a time).  Returns
    [B, S_img, C_in] f32."""
    if cfg.attn_qk8 or cfg.seq_axis or cfg.tp_axis:
        raise NotImplementedError(
            "int8-QK attention and sequence/tensor parallelism are not ported")
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
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
        return _dual_block(_block_params(params, lora, "dual_blocks", i), cfg,
                           h, c, temb, cos, sin)

    def single(i, x):
        return _single_block(_block_params(params, lora, "single_blocks", i),
                             cfg, x, temb, cos, sin)

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
