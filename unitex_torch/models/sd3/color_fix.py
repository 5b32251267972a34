"""Colour alignment of super-resolved outputs (port of
unitex_tpu/models/sd3/color_fix.py): AdaIN, and the wavelet
reconstruction that keeps the generated high frequencies and takes the
low frequencies of the bicubic-upscaled source.  Images are [H, W, C]
f32."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adain_color_fix(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Per-channel mean/std transfer: target gets the source's statistics
    (population std, as ``jnp.std``)."""
    t_mean = target.mean(dim=(0, 1), keepdim=True)
    t_std = target.std(dim=(0, 1), keepdim=True, unbiased=False) + 1e-5
    s_mean = source.mean(dim=(0, 1), keepdim=True)
    s_std = source.std(dim=(0, 1), keepdim=True, unbiased=False) + 1e-5
    return (target - t_mean) / t_std * s_std + s_mean


def _wavelet_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    """The 3x3 binomial kernel dilated by ``radius`` (à-trous wavelet):
    the nine shifted adds of the separable [.25, .5, .25]² stencil over a
    reflect-padded [C, H, W] image, in the JAX package's order."""
    x = image.permute(2, 0, 1)
    C, H, W = x.shape
    p = radius
    xp = F.pad(x[None], (p, p, p, p), mode="reflect")[0]
    w1 = (0.25, 0.5, 0.25)
    out = torch.zeros_like(x)
    for iy, wy in enumerate(w1):
        for ix, wx in enumerate(w1):
            oy, ox = iy * radius, ix * radius
            out = out + (wy * wx) * xp[:, oy:oy + H, ox:ox + W]
    return out.permute(1, 2, 0)


def wavelet_decomposition(image: torch.Tensor, levels: int = 5):
    """-> (high_freq, low_freq) à-trous decomposition."""
    high = torch.zeros_like(image)
    low = image
    for i in range(levels):
        blurred = _wavelet_blur(low, 2 ** i)
        high = high + (low - blurred)
        low = blurred
    return high, low


def wavelet_color_fix(target: torch.Tensor, source: torch.Tensor,
                      levels: int = 5) -> torch.Tensor:
    """target's high frequencies + source's low frequencies."""
    t_high, _ = wavelet_decomposition(target, levels)
    _, s_low = wavelet_decomposition(source, levels)
    return t_high + s_low
