"""Functional building blocks of the FLUX MMDiT (port of
unitex_tpu/models/flux/layers.py).

Parameters are nested dicts of tensors with linear kernels [d_in, d_out],
as in the JAX package.  Numerics follow it: LayerNorm/RMSNorm statistics
in f32, GELU-tanh, interleaved-pair 3-axis RoPE computed in f32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...ops.quant import int8_matmul, int8_weight_only_matmul

Params = Dict[str, torch.Tensor]


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ kernel (+ bias), dispatched on the leaf names as in the JAX
    package: ``kernel_int8`` (W8A8), ``kernel_int8_wo`` (weight-only int8)
    or ``kernel``; a runtime-attached LoRA (``lora_a``/``lora_b``,
    ``lora.attach_lora``) adds its exact low-rank delta in x.dtype."""
    if "kernel_int8" in p:
        y = int8_matmul(x, p["kernel_int8"], p["scale"])
    elif "kernel_int8_wo" in p:
        y = int8_weight_only_matmul(x, p["kernel_int8_wo"], p["scale"])
    else:
        y = x @ p["kernel"].to(x.dtype)
    if "lora_a" in p:
        y = y + (x @ p["lora_a"].to(x.dtype)) @ p["lora_b"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine, statistics in f32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def sinusoidal_embedding(
    t: torch.Tensor, dim: int = 256, max_period: float = 10000.0,
    scale: float = 1000.0,
) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` with flip_sin_to_cos=True,
    downscale_freq_shift=0: emb = [cos | sin] of t*scale across dim/2 freqs."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * scale * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def mlp_embedder(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(p["out"], F.silu(linear(p["in"], x)))


def rope_freqs(
    ids: torch.Tensor, axes_dims: Tuple[int, ...], theta: float = 10000.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-axis rotary embeddings: ids [S, A] -> (cos, sin) [S, D/2]."""
    cos_parts, sin_parts = [], []
    for a, d in enumerate(axes_dims):
        pos = ids[..., a].float()
        freqs = 1.0 / (theta ** (
            torch.arange(0, d, 2, dtype=torch.float32, device=ids.device) / d))
        angles = pos[..., None] * freqs
        cos_parts.append(torch.cos(angles))
        sin_parts.append(torch.sin(angles))
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs: x [B, S, H, D], cos/sin [S, D/2]."""
    xf = x.float()
    pairs = xf.reshape(*xf.shape[:-1], -1, 2)
    x_re, x_im = pairs[..., 0], pairs[..., 1]
    c = cos[:, None, :]
    s = sin[:, None, :]
    out = torch.stack([x_re * c - x_im * s, x_re * s + x_im * c], dim=-1)
    return out.reshape(xf.shape).to(x.dtype)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None, qk8: bool = False):
    """Attention over [B, S, H, D] (ops/attention.attention): kernel B1, or
    with ``qk8`` the int8-QK kernel B3, on a CUDA tensor; their plain
    versions on a CPU tensor.  With a boolean ``mask`` (broadcastable to
    [B, H, S_q, S_k], True attends) a plain masked attention, as the JAX
    package's ``jax.nn.dot_product_attention``: logits in f32, masked ones
    set to -0.7 x the f32 maximum, the softmax in f32, its probabilities
    in v's dtype; no kernel is launched."""
    if mask is not None:
        logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
        logits = logits * (1.0 / math.sqrt(q.shape[-1]))
        logits = torch.where(mask, logits, torch.full_like(
            logits, -0.7 * torch.finfo(torch.float32).max))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.einsum("bhts,bshd->bthd", probs, v)

    from ...ops.attention import attention

    return attention(q, k, v, qk8=qk8)
