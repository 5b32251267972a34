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
D = 64 on the card, its plain version on the CPU.  The sequence-parallel
``sd3_forward_sp`` is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ...utils.params import Spec, init_from_spec, linear_spec
from ...utils.precision import resolve_device
from ..flux.layers import (
    Params,
    gelu_tanh,
    layer_norm,
    linear,
    mlp_embedder,
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
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """Random SD3 tree made on ``device`` in ``dtype`` (default: the
    config's compute dtype): the JAX package's leaf names and shapes; the
    numbers differ (another PRNG)."""
    if dtype is None:
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return init_from_spec(sd3_param_spec(cfg), generator,
                          resolve_device(device), dtype)


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
    out = sdpa(torch.cat([cq, q], dim=1), torch.cat([ck, k], dim=1),
               torch.cat([cv, v], dim=1))
    out = out.reshape(out.shape[0], out.shape[1], -1)
    S_txt = context.shape[1]
    ctx_out, img_out = out[:, :S_txt], out[:, S_txt:]
    img_out = linear(p["to_out"], img_out)
    if context_out:
        return img_out, linear(p["to_add_out"], ctx_out)
    return img_out, None


def _mods(p, temb, n):
    return torch.chunk(linear(p["lin"], F.silu(temb))[:, None, :], n, dim=-1)


def _joint_block(p, cfg: SD3Config, hidden, context, temb,
                 context_pre_only: bool):
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = _mods(p["norm1"], temb, 6)
    h_norm = layer_norm(hidden) * (1 + sc_a) + sh_a
    if context_pre_only:
        # AdaLayerNormContinuous chunks (scale, shift)
        csc, csh = _mods(p["norm1_context"], temb, 2)
        c_norm = layer_norm(context) * (1 + csc) + csh
    else:
        csh_a, csc_a, cg_a, csh_m, csc_m, cg_m = _mods(
            p["norm1_context"], temb, 6)
        c_norm = layer_norm(context) * (1 + csc_a) + csh_a
    h_attn, c_attn = _joint_attention(p["attn"], cfg, h_norm, c_norm,
                                      context_out=not context_pre_only)
    hidden = hidden + g_a * h_attn
    h_mlp = layer_norm(hidden) * (1 + sc_m) + sh_m
    hidden = hidden + g_m * linear(
        p["ff"]["out"], gelu_tanh(linear(p["ff"]["in"], h_mlp)))
    if context_pre_only:
        return hidden, None
    context = context + cg_a * c_attn
    c_mlp = layer_norm(context) * (1 + csc_m) + csh_m
    context = context + cg_m * linear(
        p["ff_context"]["out"], gelu_tanh(linear(p["ff_context"]["in"], c_mlp)))
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
    out = linear(params["proj_out"], hidden)
    return unpatchify(out.float(), H, W, ps)
