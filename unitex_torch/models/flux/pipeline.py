"""PBR FLUX pipeline: multi-image latent-token conditioned generation
(port of unitex_tpu/models/flux/pipeline.py).

Packs noise latents with a 2x2 pixel shuffle into 64-channel tokens,
VAE-encodes the control (geometry strip) and dual (reference) images into
extra token streams with offset RoPE position ids (control at y+HL/2; dual
at x+WL/2, y+HL/2), concatenates [noise ‖ control ‖ dual] into one
sequence, and runs the flow-match Euler loop, re-pinning the condition
tokens every step.  Inference uses null text conditioning (zero T5 and
CLIP-pooled embeddings).  ``velocity_reuse`` > 0 serves that many steps by
extrapolating the velocity instead of calling the transformer
(:func:`make_reuse_mask`).

:func:`run_flux_inpaint` is FLUX img2img and inpainting (diffusers'
FluxInpaintPipeline semantics): the image is encoded, noised to the
schedule's ``t_start`` and denoised over the trailing steps, the kept
region re-pinned after every step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

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
    t_start: int = 0,
    known_tokens: Optional[torch.Tensor] = None,
    inpaint_mask: Optional[torch.Tensor] = None,
    fixed_noise: Optional[torch.Tensor] = None,
    reuse_mask: Optional[np.ndarray] = None,
    forward_fn=None,
) -> torch.Tensor:
    """Flow-match Euler denoise loop over the packed sequence.
    noise [B, S_noise, C]; condition_latents [B, S_cond, C] appended and
    re-pinned every step.  Returns the denoised noise tokens.

    ``t_start`` > 0 runs only steps ``t_start … num_steps-1`` (img2img:
    the caller noises its input to sigma[t_start]).  ``known_tokens``
    [B, S_noise, C] with ``fixed_noise`` inpaints: after every Euler step
    the kept tokens are re-pinned to the clean tokens noised to the next
    sigma, where ``inpaint_mask`` [S_noise, 1] is False (True = generate),
    or everywhere without a mask.

    ``reuse_mask`` [num_steps] (host bool, :func:`make_reuse_mask`): on a
    masked step the transformer is not called; the velocity is
    extrapolated linearly in sigma from the last two steps' velocities,
    v = v₁ + (σᵢ − σᵢ₋₁)/(σᵢ₋₁ − σᵢ₋₂)·(v₁ − v₂), in the latents' dtype.
    The JAX package's ``lax.cond`` is a host ``if`` here, so a masked
    step launches nothing but that sum.  With ``t_start`` > 0 the first
    two executed steps are never masked (the extrapolation needs two
    velocities).

    ``forward_fn`` replaces :func:`~.model.flux_forward` by a velocity
    model with its call signature."""
    fwd = flux_forward if forward_fn is None else forward_fn
    B, S_noise, C = noise.shape
    guidance = (
        torch.full((B,), guidance_scale, dtype=torch.float32, device=noise.device)
        if flux_cfg.guidance_embeds else None
    )
    if reuse_mask is not None and t_start > 0:
        reuse_mask = np.array(reuse_mask, bool)
        reuse_mask[t_start:t_start + 2] = False
    sig = scheduler.sigmas
    latents = noise
    v1 = v2 = None  # the velocities of the last two steps
    for i in range(t_start, scheduler.num_steps):
        if condition_latents is not None:
            latents = torch.cat([latents[:, :S_noise], condition_latents], dim=1)
        if reuse_mask is not None and reuse_mask[i]:
            r = (sig[i] - sig[i - 1]) / (sig[i - 1] - sig[i - 2])
            v = (v1 + r * (v1 - v2)).to(latents.dtype)
        else:
            timestep = (scheduler.timesteps[i] / 1000.0).expand(B)
            v = fwd(
                transformer_params, flux_cfg, latents, prompt_embeds, timestep,
                pooled_embeds, img_ids, txt_ids, guidance=guidance,
            )
        latents = scheduler.step(v, i, latents)
        if known_tokens is not None:
            pinned = scheduler.scale_noise(known_tokens, i + 1, fixed_noise)
            gen = latents[:, :S_noise]
            repin = (torch.where(inpaint_mask, gen, pinned)
                     if inpaint_mask is not None else pinned)
            latents = torch.cat([repin, latents[:, S_noise:]], dim=1)
        v1, v2 = v, v1
    return latents[:, :S_noise]


def make_reuse_mask(
    num_steps: int, num_reuse: int, start_frac: float = 0.35
) -> Optional[np.ndarray]:
    """[num_steps] host bool mask with ``num_reuse`` skipped (velocity-
    reuse) steps spread evenly over [start_frac·T, T-1): never the first
    two steps (the extrapolation needs two velocities), never the last
    (it sets the final image), never two in a row.  None for no reuse."""
    if num_reuse <= 0:
        return None
    mask = np.zeros(num_steps, bool)
    lo = max(2, int(round(start_frac * num_steps)))
    candidates = list(range(lo, num_steps - 1))
    num_reuse = min(num_reuse, (len(candidates) + 1) // 2)
    # an even spread, each pushed on past a neighbour already taken
    idx = np.linspace(0, len(candidates) - 1, num_reuse)
    for j in np.round(idx).astype(int):
        k = candidates[j]
        while k < num_steps - 1 and (mask[k] or mask[k - 1] or mask[k + 1]):
            k += 1
        if k < num_steps - 1:
            mask[k] = True
    return mask


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
    the encode is the deterministic mode).  Returns [H, W, 3] in [0, 1].

    The three parts are :func:`flux_inputs`, :func:`flux_denoise` and
    :func:`flux_decode`; across ranks (``pipeline.py``) rank 0 makes the
    inputs and decodes, and every rank denoises."""
    inputs = flux_inputs(flux_cfg, vae_params, vae_cfg, generator, pipe_cfg,
                         control_image, dual_image, prompt_embeds,
                         pooled_embeds, noise, control_eps, dual_eps, device)
    tokens = flux_denoise(transformer_params, flux_cfg, inputs, pipe_cfg)
    return flux_decode(vae_params, vae_cfg, tokens, pipe_cfg)


@torch.no_grad()
def flux_inputs(
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
) -> Dict[str, torch.Tensor]:
    """The denoise loop's inputs (arguments as :func:`run_flux_pipeline`'s):
    the packed noise tokens, the VAE-encoded condition tokens (absent
    without condition images), the position ids and the (zero by default)
    prompt embeddings, by name."""
    dev = resolve_device(device)
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
    inputs = {"noise": noise_tokens, "img_ids": img_ids, "txt_ids": txt_ids,
              "prompt_embeds": prompt_embeds, "pooled_embeds": pooled_embeds}
    if condition_latents is not None:
        inputs["condition_latents"] = condition_latents
    return inputs


@torch.no_grad()
def flux_denoise(transformer_params, flux_cfg: FluxConfig,
                 inputs: Dict[str, torch.Tensor], pipe_cfg: FluxPipelineConfig,
                 forward_fn=None) -> torch.Tensor:
    """The flow-match Euler loop over :func:`flux_inputs`' tensors: the
    denoised noise tokens."""
    noise = inputs["noise"]
    scheduler = FlowMatchEulerScheduler.create(
        pipe_cfg.num_inference_steps, noise.shape[1],
        pipe_cfg.base_image_seq_len, pipe_cfg.max_image_seq_len,
        pipe_cfg.base_shift, pipe_cfg.max_shift, device=noise.device,
    )
    return denoise(
        transformer_params, flux_cfg, noise, inputs["img_ids"],
        inputs["txt_ids"], inputs["prompt_embeds"], inputs["pooled_embeds"],
        scheduler, pipe_cfg.guidance_scale, inputs.get("condition_latents"),
        reuse_mask=make_reuse_mask(pipe_cfg.num_inference_steps,
                                   pipe_cfg.velocity_reuse),
        forward_fn=forward_fn,
    )


@torch.no_grad()
def flux_decode(vae_params, vae_cfg: VAEConfig, tokens: torch.Tensor,
                pipe_cfg: FluxPipelineConfig) -> torch.Tensor:
    """Denoised tokens -> the [H, W, 3] image in [0, 1]."""
    vs = vae_cfg.downscale
    HL = 2 * (pipe_cfg.height // (vs * 2))
    WL = 2 * (pipe_cfg.width // (vs * 2))
    image = vae_decode(vae_params, vae_cfg, unpack_latents(tokens, HL, WL))[0]
    return torch.clamp(image * 0.5 + 0.5, 0.0, 1.0)


@torch.no_grad()
def run_flux_inpaint(
    transformer_params,
    flux_cfg: FluxConfig,
    vae_params,
    vae_cfg: VAEConfig,
    generator: Optional[torch.Generator],
    image: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    strength: float = 1.0,
    num_inference_steps: int = 28,
    guidance_scale: float = 3.5,
    max_sequence_length: int = 512,
    prompt_embeds: Optional[torch.Tensor] = None,
    pooled_embeds: Optional[torch.Tensor] = None,
    noise=None,
    device="cuda",
) -> torch.Tensor:
    """FLUX img2img / inpainting on ``device``: encode ``image`` [H, W, 3]
    in [0, 1], noise it to sigma[t_start] with t_start = steps −
    round(steps · strength), run the trailing Euler steps and re-pin the
    region where ``mask`` is 0 after every step.  ``mask`` [H, W] (or
    [H, W, 1]): 1 = regenerate, 0 = keep; a token is regenerated when any
    of its pixels is.  ``mask=None`` is plain img2img.  ``noise`` [HL, WL,
    C] or [1, HL, WL, C] overrides the draw from ``generator``.  Returns
    [H, W, 3] in [0, 1]."""
    dev = resolve_device(device)
    image = torch.as_tensor(image, dtype=torch.float32).to(dev)
    H, W = int(image.shape[0]), int(image.shape[1])
    vs = vae_cfg.downscale
    HL, WL = 2 * (H // (vs * 2)), 2 * (W // (vs * 2))
    B = 1
    x0_tokens = pack_latents(vae_encode(vae_params, vae_cfg,
                                        image[None] * 2.0 - 1.0))
    S = x0_tokens.shape[1]
    if noise is None:
        noise = torch.randn((B, HL, WL, vae_cfg.latent_channels),
                            generator=generator, dtype=torch.float32, device=dev)
    noise_tokens = pack_latents(_as_nhwc4(noise, dev))

    token_mask = None
    if mask is not None:
        m = torch.as_tensor(mask, dtype=torch.float32).to(dev).reshape(1, 1, H, W)
        # any regenerated pixel regenerates its token: a max-pool over each
        # token's 2·downscale square, in the tokens' row-major order
        m = F.max_pool2d(m, 2 * vs, stride=2 * vs)
        token_mask = m.reshape(-1, 1) > 0.5

    scheduler = FlowMatchEulerScheduler.create(num_inference_steps, S,
                                               device=dev)
    # Python's round (half to even), as in the JAX package
    t_start = min(num_inference_steps,
                  num_inference_steps - int(round(num_inference_steps * strength)))
    latents0 = scheduler.scale_noise(x0_tokens, t_start, noise_tokens)

    img_ids = latent_image_ids(HL // 2, WL // 2, device=dev)
    if prompt_embeds is None:
        prompt_embeds = torch.zeros(
            (B, max_sequence_length, flux_cfg.joint_attention_dim),
            dtype=torch.float32, device=dev)
    if pooled_embeds is None:
        pooled_embeds = torch.zeros((B, flux_cfg.pooled_projection_dim),
                                    dtype=torch.float32, device=dev)
    txt_ids = torch.zeros((prompt_embeds.shape[1], 3), dtype=torch.float32,
                          device=dev)
    out_tokens = denoise(
        transformer_params, flux_cfg, latents0, img_ids, txt_ids,
        prompt_embeds, pooled_embeds, scheduler, guidance_scale,
        t_start=t_start,
        known_tokens=x0_tokens if mask is not None else None,
        inpaint_mask=token_mask,
        fixed_noise=noise_tokens if mask is not None else None,
    )
    latents = unpack_latents(out_tokens, HL, WL)
    out = vae_decode(vae_params, vae_cfg, latents)[0]
    return torch.clamp(out * 0.5 + 0.5, 0.0, 1.0)


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
