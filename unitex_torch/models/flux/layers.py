"""Functional building blocks of the FLUX MMDiT (port of
unitex_tpu/models/flux/layers.py).

Parameters are nested dicts of tensors with linear kernels [d_in, d_out],
as in the JAX package.  Numerics follow it: LayerNorm/RMSNorm statistics
in f32, GELU-tanh, interleaved-pair 3-axis RoPE computed in f32.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ kernel (+ bias).  Only the plain-kernel branch is ported: int8
    kernels and runtime-attached LoRA raise ``NotImplementedError``."""
    if "kernel" not in p or "lora_a" in p:
        raise NotImplementedError(
            f"linear form not ported (leaves {sorted(p)}): int8 serving and "
            "attached LoRA are deferred")
    y = x @ p["kernel"].to(x.dtype)
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


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Attention over [B, S, H, D]: the flash-attention kernel B1 on a CUDA
    tensor, its plain version on a CPU tensor (ops/attention.py)."""
    from ...ops.attention import attention

    return attention(q, k, v)
