"""SD3 MMDiT transformer (SD3Transformer2DModel) in PyTorch (port of
unitex_tpu/models/sd3/model.py), the diffusion backbone of the TSD-SR
super-resolution stage.

Differences from FLUX: learned cropped 2D position embeddings instead of
RoPE, a conv patchify (a linear over channel-major patches), joint
(dual-stream) blocks throughout with the LAST block context-pre-only (no
context output, its context AdaLN in AdaLayerNormContinuous's (scale,
shift) order), no guidance embedding, timesteps embedded at scale 1.0.
Blocks stay stacked [L-1, ...] as in the JAX package, the final block
apart; the forward walks the stack with a Python loop (the JAX
``lax.scan``).  Attention goes through FLUX's ``sdpa``: kernel B1 at
D = 64 on the card, its plain version on the CPU.

Serving across ranks, as FLUX (``models/flux/model.py``): with
``cfg.tp_axis`` the blocks hold this rank's Megatron slices
(``parallel/sharding.shard_sd3_params``, the config from
``models/flux/model.tp_config``), gather the AdaLN modulations and sum
after the row-parallel products, with FLUX's autograd collectives
(``parallel/collectives``: ``copy_to`` before the column products);
:func:`sd3_forward_sp` cuts the token sequence over ``seq_axis``
(Ulysses or the ring).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ...ops.ring_attention import sequence_parallel_attention
from ...parallel.collectives import copy_to, gather_from
from ...parallel.sharding import gather

from ...utils.params import Spec, init_from_spec, linear_spec
from ...utils.precision import resolve_device
from ..flux.layers import (
    Params,
    gelu_tanh,
    layer_norm,
    linear,
    mlp_embedder,
    row_linear,
    sdpa,
    sinusoidal_embedding,
)
from ..flux.lora import merge_lora_layer
from ..flux.model import layer
from .config import SD3Config


# ------------------------------------------------------------------ init


def _block_spec(cfg: SD3Config, context_pre_only: bool, lead=()) -> Spec:
    d = cfg.hidden_size

    def lin(d_in, d_out):
        return linear_spec(d_in, d_out, lead=lead)

    attn = {name: lin(d, d) for name in (
        "to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
        "to_out")}
    p = {
        "norm1": {"lin": lin(d, 6 * d)},
        "attn": attn,
        "ff": {"in": lin(d, cfg.mlp_dim), "out": lin(cfg.mlp_dim, d)},
    }
    if context_pre_only:
        # AdaLayerNormContinuous on the context stream (2 modulations)
        p["norm1_context"] = {"lin": lin(d, 2 * d)}
    else:
        attn["to_add_out"] = lin(d, d)
        p["norm1_context"] = {"lin": lin(d, 6 * d)}
        p["ff_context"] = {"in": lin(d, cfg.mlp_dim),
                           "out": lin(cfg.mlp_dim, d)}
    return p


def sd3_param_spec(cfg: SD3Config) -> Spec:
    """The leaf names, shapes and init distributions of the JAX package's
    ``init_sd3_params``: 23 joint blocks stacked [L-1, ...] under
    ``blocks`` and the context-pre-only ``final_block``."""
    d = cfg.hidden_size
    ps = cfg.patch_size
    pmax = cfg.pos_embed_max_size

    def mlp_emb(d_in):
        return {"in": linear_spec(d_in, d), "out": linear_spec(d, d)}

    return {
        "pos_embed": {
            "proj": linear_spec(cfg.in_channels * ps * ps, d),
            "pos": ("normal", (pmax, pmax, d), 0.02),
        },
        "context_embedder": linear_spec(cfg.joint_attention_dim, d),
        "time_embed": mlp_emb(256),
        "pooled_embed": mlp_emb(cfg.pooled_projection_dim),
        "norm_out": {"lin": linear_spec(d, 2 * d)},
        "proj_out": linear_spec(d, ps * ps * cfg.out_channels),
        "blocks": _block_spec(cfg, False, lead=(cfg.num_layers - 1,)),
        "final_block": _block_spec(cfg, True),
    }


def init_sd3_params(
    generator: torch.Generator, cfg: SD3Config, device="cuda",
    dtype: Optional[torch.dtype] = None, hook=None,
) -> Params:
    """Random SD3 tree made on ``device`` in ``dtype`` (default: the
    config's compute dtype): the JAX package's leaf names and shapes; the
    numbers differ (another PRNG).  ``hook`` as in FLUX's
    ``init_flux_params``."""
    if dtype is None:
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return init_from_spec(sd3_param_spec(cfg), generator,
                          resolve_device(device), dtype, hook=hook)


# --------------------------------------------------------------- forward


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, h, -1)


def _joint_attention(p, cfg: SD3Config, hidden, context, context_out: bool):
    """Joint attention over [context; image] tokens, context first."""
    H = cfg.num_attention_heads
    q = _heads(linear(p["to_q"], hidden), H)
    k = _heads(linear(p["to_k"], hidden), H)
    v = _heads(linear(p["to_v"], hidden), H)
    cq = _heads(linear(p["add_q_proj"], context), H)
    ck = _heads(linear(p["add_k_proj"], context), H)
    cv = _heads(linear(p["add_v_proj"], context), H)
    q, k, v = (torch.cat(pair, dim=1) for pair in ((cq, q), (ck, k), (cv, v)))
    if cfg.seq_axis is not None:
        out = sequence_parallel_attention(q, k, v, cfg.seq_axis, cfg.sp_mode,
                                          attn_fn=sdpa)
    else:
        out = sdpa(q, k, v)
    out = out.reshape(out.shape[0], out.shape[1], -1)
    S_txt = context.shape[1]
    ctx_out, img_out = out[:, :S_txt], out[:, S_txt:]
    img_out = row_linear(p["to_out"], img_out, cfg.tp_axis)
    if context_out:
        return img_out, row_linear(p["to_add_out"], ctx_out, cfg.tp_axis)
    return img_out, None


def _mods(p, temb, n, group=None):
    """``n`` modulations [B, 1, d]; under tensor parallelism ``lin`` holds
    this rank's columns and the slices are gathered."""
    x = F.silu(temb)
    if group is None:
        return torch.chunk(linear(p["lin"], x)[:, None, :], n, dim=-1)
    mods = gather_from(linear(p["lin"], copy_to(x, group)), group, dim=-1)
    return torch.chunk(mods[:, None, :], n, dim=-1)


def _col_input(x, group):
    return x if group is None else copy_to(x, group)


def _joint_block(p, cfg: SD3Config, hidden, context, temb,
                 context_pre_only: bool):
    tp = cfg.tp_axis
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = _mods(p["norm1"], temb, 6, tp)
    h_norm = _col_input(layer_norm(hidden) * (1 + sc_a) + sh_a, tp)
    if context_pre_only:
        # AdaLayerNormContinuous chunks (scale, shift)
        csc, csh = _mods(p["norm1_context"], temb, 2, tp)
        c_norm = _col_input(layer_norm(context) * (1 + csc) + csh, tp)
    else:
        csh_a, csc_a, cg_a, csh_m, csc_m, cg_m = _mods(
            p["norm1_context"], temb, 6, tp)
        c_norm = _col_input(layer_norm(context) * (1 + csc_a) + csh_a, tp)
    h_attn, c_attn = _joint_attention(p["attn"], cfg, h_norm, c_norm,
                                      context_out=not context_pre_only)
    hidden = hidden + g_a * h_attn
    h_mlp = _col_input(layer_norm(hidden) * (1 + sc_m) + sh_m, tp)
    hidden = hidden + g_m * row_linear(
        p["ff"]["out"], gelu_tanh(linear(p["ff"]["in"], h_mlp)), tp)
    if context_pre_only:
        return hidden, None
    context = context + cg_a * c_attn
    c_mlp = _col_input(layer_norm(context) * (1 + csc_m) + csh_m, tp)
    context = context + cg_m * row_linear(
        p["ff_context"]["out"], gelu_tanh(linear(p["ff_context"]["in"], c_mlp)),
        tp)
    return hidden, context


def patchify(latents: torch.Tensor, ps: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/ps*W/ps, C*ps*ps]: the conv patchify as a
    linear over flattened patches, channel-major as torch's conv weight."""
    B, H, W, C = latents.shape
    x = latents.reshape(B, H // ps, ps, W // ps, ps, C)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, (H // ps) * (W // ps), C * ps * ps)


def unpatchify(tokens: torch.Tensor, H: int, W: int, ps: int) -> torch.Tensor:
    B, S, Cp = tokens.shape
    C = Cp // (ps * ps)
    x = tokens.reshape(B, H // ps, W // ps, C, ps, ps)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H, W, C)


def sd3_forward(
    params: Params,
    cfg: SD3Config,
    latents: torch.Tensor,
    encoder_hidden_states: torch.Tensor,
    timestep: torch.Tensor,
    pooled_projections: torch.Tensor,
    lora: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """latents [B, H, W, C] (VAE latent space), encoder_hidden_states
    [B, S_txt, joint_attention_dim], timestep [B] in [0, 1000], pooled
    [B, pooled_projection_dim].  ``lora``: an adapter tree (``blocks``
    stacked, ``final_block``; ``models/sd3/lora.init_sd3_lora``) merged
    with weight 1 into each block's kernels inside the block, under
    autograd, so its gradients reach the adapters (the JAX TSD-SR
    trainer's ``merge_lora`` of the whole tree before the forward, one
    layer at a time).  Returns the velocity [B, H, W, C] f32."""
    hidden, context, temb = _prologue(params, cfg, latents,
                                      encoder_hidden_states, timestep,
                                      pooled_projections)
    out = _token_stage(params, cfg, hidden, context, temb, lora)
    H, W = latents.shape[1:3]
    return unpatchify(out.float(), H, W, cfg.patch_size)


def _prologue(params, cfg: SD3Config, latents, encoder_hidden_states,
              timestep, pooled_projections):
    """Patchify, the cropped position table, the context and time
    embeddings: (hidden, context, temb)."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    B, H, W, C = latents.shape
    ps = cfg.patch_size
    hp, wp = H // ps, W // ps

    hidden = linear(params["pos_embed"]["proj"],
                    patchify(latents.to(dtype), ps))
    # cropped learned position embedding (diffusers PatchEmbed, cropped)
    pmax = cfg.pos_embed_max_size
    assert hp <= pmax and wp <= pmax, (
        f"latent patch grid {hp}x{wp} exceeds pos_embed_max_size {pmax}; "
        "shrink the latent tile (a negative crop start would silently "
        "wrap the slice)")
    top = (pmax - hp) // 2
    left = (pmax - wp) // 2
    pos = params["pos_embed"]["pos"][top:top + hp, left:left + wp]
    hidden = hidden + pos.reshape(1, hp * wp, -1).to(dtype)

    context = linear(params["context_embedder"],
                     encoder_hidden_states.to(dtype))
    temb = mlp_embedder(
        params["time_embed"],
        sinusoidal_embedding(timestep.float(), 256, scale=1.0).to(dtype))
    temb = temb + mlp_embedder(params["pooled_embed"],
                               pooled_projections.to(dtype))
    return hidden, context, temb


def _token_stage(params, cfg: SD3Config, hidden, context, temb, lora=None):
    """The token-wise middle: the joint blocks, the context-pre-only final
    block, norm_out and proj_out.  Every op but attention is token-local,
    so :func:`sd3_forward_sp` runs it on a block of the sequence."""
    for i in range(cfg.num_layers - 1):
        p = layer(params["blocks"], i)
        if lora is not None:
            p = merge_lora_layer(p, layer(lora["blocks"], i))
        hidden, context = _joint_block(p, cfg, hidden, context, temb,
                                       context_pre_only=False)
    p = params["final_block"]
    if lora is not None:
        p = merge_lora_layer(p, lora["final_block"])
    hidden, _ = _joint_block(p, cfg, hidden, context, temb,
                             context_pre_only=True)
    sc, sh = _mods(params["norm_out"], temb, 2)
    hidden = layer_norm(hidden) * (1 + sc) + sh
    return linear(params["proj_out"], hidden)


def sd3_forward_sp(
    params: Params,
    cfg: SD3Config,
    latents: torch.Tensor,
    encoder_hidden_states: torch.Tensor,
    timestep: torch.Tensor,
    pooled_projections: torch.Tensor,
    seq_axis,
    sp_mode: Optional[str] = None,
) -> torch.Tensor:
    """:func:`sd3_forward` with the token sequence cut over the process
    group ``seq_axis`` (Ulysses or the ring by ``sp_mode``, default
    ``cfg.sp_mode``).  The patchify prologue and the unpatchify epilogue
    run whole on every rank; each rank runs the block stack on its blocks
    of the image and context tokens, and the output tokens are gathered.
    Both token counts must divide the group size.  Under tensor
    parallelism pass the config of :func:`tp_config` and this rank's
    slices."""
    n, r = dist.get_world_size(seq_axis), dist.get_rank(seq_axis)
    hidden, context, temb = _prologue(params, cfg, latents,
                                      encoder_hidden_states, timestep,
                                      pooled_projections)
    S_img, S_txt = hidden.shape[1], context.shape[1]
    if S_img % n or S_txt % n:
        raise ValueError(f"S_img {S_img} / S_txt {S_txt} must divide the "
                         f"sequence group's size {n}")
    si, st = S_img // n, S_txt // n
    cfg_sp = dataclasses.replace(cfg, seq_axis=seq_axis,
                                 sp_mode=sp_mode or cfg.sp_mode)
    out = _token_stage(params, cfg_sp, hidden[:, r * si:(r + 1) * si],
                       context[:, r * st:(r + 1) * st], temb)
    H, W = latents.shape[1:3]
    return unpatchify(gather(out, seq_axis, dim=1).float(), H, W,
                      cfg.patch_size)
