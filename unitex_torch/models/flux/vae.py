"""FLUX/SD AutoencoderKL in PyTorch (port of unitex_tpu/models/flux/vae.py).

Standard SD encoder/decoder: conv stem, ``len(block_out_channels)`` levels
of ResnetBlock2D pairs with stride-2 downsampling, a mid block with
single-head self-attention (plain PyTorch, as the JAX package leaves it to
XLA), symmetric decoder with nearest-neighbour x2 upsampling.

Images and latents are NHWC at the public functions, and conv kernels
HWIO in the parameter tree, as in the JAX package; inside, the network
runs NCHW for cuDNN.  The VAE runs in the dtype of its inputs and
parameters (f32 on the texturing path), with exact f32 convolutions (no
TF32, see utils/precision.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...utils.params import Spec, init_from_spec
from ...utils.precision import exact_f32, resolve_device

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159

    @classmethod
    def flux(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def sd3(cls) -> "VAEConfig":
        return cls(scaling_factor=1.5305, shift_factor=0.0609)

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(
            latent_channels=4,
            block_out_channels=(8, 16),
            layers_per_block=1,
            norm_num_groups=4,
            scaling_factor=1.0,
            shift_factor=0.0,
        )

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


# ------------------------------------------------------------------ init


def _conv_spec(k, c_in, c_out):
    return {"kernel": ("uniform", (k, k, c_in, c_out), 1.0 / math.sqrt(k * k * c_in)),
            "bias": ("zeros", (c_out,))}


def _gn_spec(c):
    return {"scale": ("ones", (c,)), "bias": ("zeros", (c,))}


def _resnet_spec(c_in, c_out):
    p = {"norm1": _gn_spec(c_in), "conv1": _conv_spec(3, c_in, c_out),
         "norm2": _gn_spec(c_out), "conv2": _conv_spec(3, c_out, c_out)}
    if c_in != c_out:
        p["shortcut"] = _conv_spec(1, c_in, c_out)
    return p


def _attn_spec(c):
    def lin():
        return {"kernel": ("uniform", (c, c), 1.0 / math.sqrt(c)),
                "bias": ("zeros", (c,))}
    return {"norm": _gn_spec(c), "q": lin(), "k": lin(), "v": lin(), "o": lin()}


def vae_param_spec(cfg: VAEConfig) -> Spec:
    """Leaf names, shapes and init of the JAX package's ``init_vae_params``."""
    ch = cfg.block_out_channels
    n = len(ch)
    enc = {"conv_in": _conv_spec(3, cfg.in_channels, ch[0])}
    levels, c_prev = [], ch[0]
    for lvl in range(n):
        level = {"resnets": []}
        for _ in range(cfg.layers_per_block):
            level["resnets"].append(_resnet_spec(c_prev, ch[lvl]))
            c_prev = ch[lvl]
        if lvl < n - 1:
            level["downsample"] = _conv_spec(3, c_prev, c_prev)
        levels.append(level)
    enc["down"] = levels
    enc["mid"] = {"res1": _resnet_spec(c_prev, c_prev), "attn": _attn_spec(c_prev),
                  "res2": _resnet_spec(c_prev, c_prev)}
    enc["norm_out"] = _gn_spec(c_prev)
    enc["conv_out"] = _conv_spec(3, c_prev, 2 * cfg.latent_channels)

    dec = {"conv_in": _conv_spec(3, cfg.latent_channels, ch[-1])}
    dec["mid"] = {"res1": _resnet_spec(ch[-1], ch[-1]), "attn": _attn_spec(ch[-1]),
                  "res2": _resnet_spec(ch[-1], ch[-1])}
    levels, c_prev = [], ch[-1]
    for lvl in reversed(range(n)):
        level = {"resnets": []}
        for _ in range(cfg.layers_per_block + 1):
            level["resnets"].append(_resnet_spec(c_prev, ch[lvl]))
            c_prev = ch[lvl]
        if lvl > 0:
            level["upsample"] = _conv_spec(3, c_prev, c_prev)
        levels.append(level)
    dec["up"] = levels
    dec["norm_out"] = _gn_spec(c_prev)
    dec["conv_out"] = _conv_spec(3, c_prev, cfg.in_channels)
    return {"encoder": enc, "decoder": dec}


def init_vae_params(generator: torch.Generator, cfg: VAEConfig, device="cuda",
                    dtype: torch.dtype = torch.float32) -> Params:
    """Random VAE tree on ``device`` (same leaves as the JAX package's)."""
    return init_from_spec(vae_param_spec(cfg), generator,
                          resolve_device(device), dtype)


# ------------------------------------------------------------ primitives


def conv(p: Params, x: torch.Tensor, stride: int = 1, padding: int = -1) -> torch.Tensor:
    """NCHW conv with an HWIO kernel; ``padding=-1`` is SAME for odd k."""
    w = p["kernel"].to(x.dtype).permute(3, 2, 0, 1)
    if padding < 0:
        padding = w.shape[-1] // 2
    return F.conv2d(x, w, p["bias"].to(x.dtype), stride=stride, padding=padding)


def group_norm(x: torch.Tensor, p: Params, groups: int, eps: float = 1e-6) -> torch.Tensor:
    """Statistics in f32 with the two-pass variance E[(x-mean)^2] (the
    one-pass form is ill-conditioned when |mean| >> std), normalization
    applied in the input dtype, as in the JAX package."""
    N, C, H, W = x.shape
    xg = x.reshape(N, groups, C // groups, H, W)
    xf = xg.float()
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = torch.square(xf - mean).mean(dim=(2, 3, 4), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xg * rstd.to(x.dtype) + (-mean * rstd).to(x.dtype)).reshape(N, C, H, W)
    return y * p["scale"].to(x.dtype)[:, None, None] + p["bias"].to(x.dtype)[:, None, None]


def _resnet(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    h = conv(p["conv1"], F.silu(group_norm(x, p["norm1"], groups)))
    h = conv(p["conv2"], F.silu(group_norm(h, p["norm2"], groups)))
    if "shortcut" in p:
        x = conv(p["shortcut"], x)
    return x + h


def _attn(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    N, C, H, W = x.shape
    h = group_norm(x, p["norm"], groups).reshape(N, C, H * W).transpose(1, 2)

    def lin(q):
        return h @ q["kernel"].to(h.dtype) + q["bias"].to(h.dtype)

    q, k, v = lin(p["q"]), lin(p["k"]), lin(p["v"])
    attn = torch.softmax(
        (q @ k.transpose(-1, -2)).float() / math.sqrt(C), dim=-1).to(h.dtype)
    out = attn @ v
    out = out @ p["o"]["kernel"].to(h.dtype) + p["o"]["bias"].to(h.dtype)
    return x + out.transpose(1, 2).reshape(N, C, H, W)


# ------------------------------------------------------------- networks


@torch.no_grad()
@exact_f32()
def vae_encode(params: Params, cfg: VAEConfig, images: torch.Tensor,
               sample_eps: torch.Tensor | None = None) -> torch.Tensor:
    """images [N, H, W, 3] in [-1, 1] -> scaled latents [N, H/8, W/8, C].
    Deterministic (the posterior mode) unless ``sample_eps`` supplies the
    standard-normal draw (mean-shaped, NHWC)."""
    g = cfg.norm_num_groups
    enc = params["encoder"]
    x = conv(enc["conv_in"], images.permute(0, 3, 1, 2))
    for level in enc["down"]:
        for rp in level["resnets"]:
            x = _resnet(rp, x, g)
        if "downsample" in level:
            # diffusers pads (0,1,0,1) then convs stride 2 VALID
            x = F.pad(x, (0, 1, 0, 1))
            x = conv(level["downsample"], x, stride=2, padding=0)
    x = _resnet(enc["mid"]["res1"], x, g)
    x = _attn(enc["mid"]["attn"], x, g)
    x = _resnet(enc["mid"]["res2"], x, g)
    x = conv(enc["conv_out"], F.silu(group_norm(x, enc["norm_out"], g)))
    x = x.permute(0, 2, 3, 1)
    mean, logvar = torch.chunk(x, 2, dim=-1)
    if sample_eps is not None:
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        mean = mean + std * sample_eps.to(mean.dtype)
    return (mean - cfg.shift_factor) * cfg.scaling_factor


def _decode(params: Params, cfg: VAEConfig, latents: torch.Tensor,
            remat: bool = False) -> torch.Tensor:
    g = cfg.norm_num_groups
    dec = params["decoder"]

    def run(fn, *args):
        if remat:
            # the recompute runs in the backward, outside this call's
            # exact_f32: it takes its own
            return checkpoint(exact_f32()(fn), *args, use_reentrant=False)
        return fn(*args)

    def up(level, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return conv(level["upsample"], x)

    z = latents / cfg.scaling_factor + cfg.shift_factor
    x = conv(dec["conv_in"], z.permute(0, 3, 1, 2))
    x = run(_resnet, dec["mid"]["res1"], x, g)
    x = run(_attn, dec["mid"]["attn"], x, g)
    x = run(_resnet, dec["mid"]["res2"], x, g)
    for level in dec["up"]:
        for rp in level["resnets"]:
            x = run(_resnet, rp, x, g)
        if "upsample" in level:
            x = run(up, level, x)
    x = run(lambda x: conv(dec["conv_out"],
                           F.silu(group_norm(x, dec["norm_out"], g))), x)
    return x.permute(0, 2, 3, 1)


@torch.no_grad()
@exact_f32()
def vae_decode(params: Params, cfg: VAEConfig, latents: torch.Tensor) -> torch.Tensor:
    """Scaled latents [N, h, w, C] -> images [N, H, W, 3] in [-1, 1]
    (unclamped)."""
    return _decode(params, cfg, latents)


@exact_f32()
def vae_decode_with_grad(params: Params, cfg: VAEConfig,
                         latents: torch.Tensor) -> torch.Tensor:
    """:func:`vae_decode` under autograd (the FLUX trainer's
    preconditioning loss differentiates through the frozen decoder).
    Each resnet, the attention, each upsample and the output head are
    checkpointed: only their inputs are kept for the backward, which
    recomputes one of them at a time (the same arithmetic), instead of
    every intermediate of a decode at full resolution (1024 x 1536 in
    the FLUX trainer)."""
    return _decode(params, cfg, latents, remat=True)
