"""PBR FLUX pipeline: multi-image latent-token conditioned generation
(port of unitex_tpu/models/flux/pipeline.py).

Packs noise latents with a 2x2 pixel shuffle into 64-channel tokens,
VAE-encodes the control (geometry strip) and dual (reference) images into
extra token streams with offset RoPE position ids (control at y+HL/2; dual
at x+WL/2, y+HL/2), concatenates [noise ‖ control ‖ dual] into one
sequence, and runs the flow-match Euler loop, re-pinning the condition
tokens every step.  Inference uses null text conditioning (zero T5 and
CLIP-pooled embeddings).

Deferred: velocity reuse (``velocity_reuse`` > 0) raises
``NotImplementedError``; the inpaint / img2img entry point is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...utils.precision import resolve_device
from .config import FluxConfig
from .model import flux_forward
from .scheduler import FlowMatchEulerScheduler
from .vae import VAEConfig, vae_decode, vae_encode


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2*W/2, C*4] 2x2 pixel shuffle, channel-major
    (C, ph, pw) token layout."""
    B, H, W, C = latents.shape
    x = latents.reshape(B, H // 2, 2, W // 2, 2, C)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, (H // 2) * (W // 2), C * 4)


def unpack_latents(packed: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[B, H/2*W/2, C*4] -> [B, H, W, C]."""
    B, S, C4 = packed.shape
    C = C4 // 4
    x = packed.reshape(B, H // 2, W // 2, C, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H, W, C)


def latent_image_ids(
    h_tokens: int, w_tokens: int, offset_x: int = 0, offset_y: int = 0,
    offset_z: int = 0, device="cuda",
) -> torch.Tensor:
    """[h*w, 3] (z, y, x) position ids."""
    ys = torch.arange(offset_y, offset_y + h_tokens, dtype=torch.float32, device=device)
    xs = torch.arange(offset_x, offset_x + w_tokens, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    gz = torch.full_like(gy, float(offset_z))
    return torch.stack([gz, gy, gx], dim=-1).reshape(-1, 3)


@dataclasses.dataclass(frozen=True)
class FluxPipelineConfig:
    height: int = 512
    width: int = 3072
    num_inference_steps: int = 28
    guidance_scale: float = 3.5
    max_sequence_length: int = 512
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096
    base_shift: float = 0.5
    max_shift: float = 1.15
    velocity_reuse: int = 0


@torch.no_grad()
def denoise(
    transformer_params,
    flux_cfg: FluxConfig,
    noise: torch.Tensor,
    img_ids: torch.Tensor,
    txt_ids: torch.Tensor,
    prompt_embeds: torch.Tensor,
    pooled_embeds: torch.Tensor,
    scheduler: FlowMatchEulerScheduler,
    guidance_scale: float,
    condition_latents: Optional[torch.Tensor] = None,
    reuse_mask=None,
) -> torch.Tensor:
    """Flow-match Euler denoise loop over the packed sequence.
    noise [B, S_noise, C]; condition_latents [B, S_cond, C] appended and
    re-pinned every step.  Returns the denoised noise tokens."""
    if reuse_mask is not None:
        raise NotImplementedError("velocity reuse is not ported")
    B, S_noise, C = noise.shape
    guidance = (
        torch.full((B,), guidance_scale, dtype=torch.float32, device=noise.device)
        if flux_cfg.guidance_embeds else None
    )
    latents = noise
    for i in range(scheduler.num_steps):
        if condition_latents is not None:
            latents = torch.cat([latents[:, :S_noise], condition_latents], dim=1)
        timestep = (scheduler.timesteps[i] / 1000.0).expand(B)
        v = flux_forward(
            transformer_params, flux_cfg, latents, prompt_embeds, timestep,
            pooled_embeds, img_ids, txt_ids, guidance=guidance,
        )
        latents = scheduler.step(v, i, latents)
    return latents[:, :S_noise]


def _as_nhwc4(x, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                        dtype=torch.float32).to(device)
    return t[None] if t.dim() == 3 else t


@torch.no_grad()
def run_flux_pipeline(
    transformer_params,
    flux_cfg: FluxConfig,
    vae_params,
    vae_cfg: VAEConfig,
    generator: Optional[torch.Generator],
    pipe_cfg: FluxPipelineConfig,
    control_image: Optional[torch.Tensor] = None,
    dual_image: Optional[torch.Tensor] = None,
    prompt_embeds: Optional[torch.Tensor] = None,
    pooled_embeds: Optional[torch.Tensor] = None,
    noise=None,
    control_eps=None,
    dual_eps=None,
    device="cuda",
) -> torch.Tensor:
    """Full text-free conditioned generation on ``device``.

    control_image / dual_image: [H, W, 3] / [Hd, Wd, 3] in [0, 1].
    ``noise`` [HL, WL, C] or [1, HL, WL, C] overrides the initial latent
    noise (else drawn from ``generator``); ``control_eps`` / ``dual_eps``
    supply the VAE posterior draws of the condition encodes (without them
    the encode is the deterministic mode).  Returns [H, W, 3] in [0, 1]."""
    dev = resolve_device(device)
    if pipe_cfg.velocity_reuse:
        raise NotImplementedError("velocity reuse is not ported")
    H, W = pipe_cfg.height, pipe_cfg.width
    vs = vae_cfg.downscale
    HL, WL = 2 * (H // (vs * 2)), 2 * (W // (vs * 2))
    C_lat = vae_cfg.latent_channels
    B = 1
    if noise is not None:
        noise = _as_nhwc4(noise, dev)
        if tuple(noise.shape) != (B, HL, WL, C_lat):
            raise ValueError(f"noise shape {tuple(noise.shape)}")
    else:
        noise = torch.randn((B, HL, WL, C_lat), generator=generator,
                            dtype=torch.float32, device=dev)
    noise_tokens = pack_latents(noise)
    noise_ids = latent_image_ids(HL // 2, WL // 2, device=dev)

    def encode_cond(img, eps):
        return vae_encode(vae_params, vae_cfg, img,
                          sample_eps=None if eps is None else _as_nhwc4(eps, dev))

    cond_tokens, cond_ids = [], []
    if control_image is not None:
        lat = encode_cond(_as_nhwc4(control_image, dev) * 2.0 - 1.0, control_eps)
        cond_tokens.append(pack_latents(lat))
        cond_ids.append(latent_image_ids(
            lat.shape[1] // 2, lat.shape[2] // 2, offset_y=HL // 2, device=dev))
    if dual_image is not None:
        lat = encode_cond(_as_nhwc4(dual_image, dev) * 2.0 - 1.0, dual_eps)
        cond_tokens.append(pack_latents(lat))
        cond_ids.append(latent_image_ids(
            lat.shape[1] // 2, lat.shape[2] // 2,
            offset_x=WL // 2, offset_y=HL // 2, device=dev))
    condition_latents = torch.cat(cond_tokens, dim=1) if cond_tokens else None
    img_ids = torch.cat([noise_ids] + cond_ids, dim=0)

    if prompt_embeds is None:
        prompt_embeds = torch.zeros(
            (B, pipe_cfg.max_sequence_length, flux_cfg.joint_attention_dim),
            dtype=torch.float32, device=dev)
    if pooled_embeds is None:
        pooled_embeds = torch.zeros((B, flux_cfg.pooled_projection_dim),
                                    dtype=torch.float32, device=dev)
    txt_ids = torch.zeros((prompt_embeds.shape[1], 3), dtype=torch.float32,
                          device=dev)
    scheduler = FlowMatchEulerScheduler.create(
        pipe_cfg.num_inference_steps, noise_tokens.shape[1],
        pipe_cfg.base_image_seq_len, pipe_cfg.max_image_seq_len,
        pipe_cfg.base_shift, pipe_cfg.max_shift, device=dev,
    )
    out_tokens = denoise(
        transformer_params, flux_cfg, noise_tokens, img_ids, txt_ids,
        prompt_embeds, pooled_embeds, scheduler, pipe_cfg.guidance_scale,
        condition_latents,
    )
    latents = unpack_latents(out_tokens, HL, WL)
    image = vae_decode(vae_params, vae_cfg, latents)[0]
    return torch.clamp(image * 0.5 + 0.5, 0.0, 1.0)


def torch_reference_rng(
    seed,
    noise_hw,
    dual_hw=None,
    control_hw=None,
    latent_channels: int = 16,
    dtype: str = "bfloat16",
):
    """Replay the CUDA reference's torch CPU RNG stream for one FLUX pass:
    the initial noise, then the dual image's VAE posterior draw, then the
    control image's, from one ``torch.Generator`` (pass a generator to
    thread it across passes, or a seed).  Shapes are latent grids (HL, WL).
    Returns NHWC float32 numpy arrays: ``noise`` [1, HL, WL, C],
    ``dual_eps`` / ``control_eps`` (None where the shape was not given)."""
    td = getattr(torch, dtype)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))

    def draw(hw):
        HL, WL = hw
        x = torch.randn((1, latent_channels, HL, WL), generator=gen, dtype=td)
        return np.transpose(x.float().numpy(), (0, 2, 3, 1))

    out = {"noise": draw(noise_hw), "dual_eps": None, "control_eps": None}
    if dual_hw is not None:
        out["dual_eps"] = draw(dual_hw)
    if control_hw is not None:
        out["control_eps"] = draw(control_hw)
    return out
