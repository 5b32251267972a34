"""FastTexture: diffusion-based texture-space enhancement (port of
unitex_tpu/texture/fast_texture.py).

Both helpers run the in-repo FLUX transformer through
:func:`~unitex_torch.models.flux.pipeline.run_flux_inpaint`: one repairs
the invalid texels of a baked texture, the other upscales a texture and
re-synthesizes its detail with a low-strength img2img pass.

Textures are [H, W, 3] float in [0, 1]; masks are [H, W] bool/float with
True/1 = the texel needs (re)generation.  ``noise`` [HL, WL, C] replaces
the latent draw from ``generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.flux.config import FluxConfig
from ..models.flux.pipeline import run_flux_inpaint
from ..models.flux.vae import VAEConfig
from ..utils.precision import resolve_device
from ..utils.resize import resize_bicubic


def inpaint_texture(
    transformer_params,
    flux_cfg: FluxConfig,
    vae_params,
    vae_cfg: VAEConfig,
    generator: Optional[torch.Generator],
    texture: torch.Tensor,
    invalid_mask: torch.Tensor,
    strength: float = 1.0,
    num_inference_steps: int = 28,
    guidance_scale: float = 3.5,
    prompt_embeds: Optional[torch.Tensor] = None,
    pooled_embeds: Optional[torch.Tensor] = None,
    noise=None,
    device="cuda",
) -> torch.Tensor:
    """Regenerate the invalid texels of a baked texture; the valid texels
    come back exactly as they went in."""
    dev = resolve_device(device)
    texture = torch.as_tensor(texture, dtype=torch.float32).to(dev)
    mask = torch.as_tensor(invalid_mask).to(dev).float()
    out = run_flux_inpaint(
        transformer_params, flux_cfg, vae_params, vae_cfg, generator,
        texture, mask=mask, strength=strength,
        num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
        prompt_embeds=prompt_embeds, pooled_embeds=pooled_embeds,
        noise=noise, device=dev,
    )
    # the latent pin is token-granular: keep the valid texels exactly
    keep = mask.reshape(texture.shape[0], texture.shape[1], 1)
    return out * keep + texture * (1.0 - keep)


def upscale_texture(
    transformer_params,
    flux_cfg: FluxConfig,
    vae_params,
    vae_cfg: VAEConfig,
    generator: Optional[torch.Generator],
    texture: torch.Tensor,
    scale: int = 2,
    strength: float = 0.3,
    num_inference_steps: int = 28,
    guidance_scale: float = 3.5,
    prompt_embeds: Optional[torch.Tensor] = None,
    pooled_embeds: Optional[torch.Tensor] = None,
    noise=None,
    device="cuda",
) -> torch.Tensor:
    """Upscale a texture ``scale`` times: ``jax.image.resize``'s bicubic
    (Keys a = -0.5, out-of-image taps dropped), clipped to [0, 1], then a
    low-strength img2img pass.  [H, W, 3] in, [sH, sW, 3] out."""
    dev = resolve_device(device)
    texture = torch.as_tensor(texture, dtype=torch.float32).to(dev)
    H, W = texture.shape[:2]
    up = torch.clamp(resize_bicubic(texture, H * scale, W * scale), 0.0, 1.0)
    return run_flux_inpaint(
        transformer_params, flux_cfg, vae_params, vae_cfg, generator,
        up, mask=None, strength=strength,
        num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
        prompt_embeds=prompt_embeds, pooled_embeds=pooled_embeds,
        noise=noise, device=dev,
    )
