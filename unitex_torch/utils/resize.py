"""``jax.image.resize`` in PyTorch, for the two methods the port needs.

JAX resizes through ``scale_and_translate``: along each axis a weight
matrix from a kernel evaluated at the distance between each output
sample's centre and each input pixel (the kernel widened by the
downscale factor when shrinking, so downsampling is antialiased), its
columns normalized to sum to 1, samples outside the input zeroed.  So
taps that fall outside the image are dropped and the rest renormalized,
where ``torch.nn.functional.interpolate`` clamps them to the edge (and
its bicubic uses a = -0.75, JAX's Keys kernel a = -0.5).  Here the same
weights are built in f32 numpy and applied as two f32 products.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .precision import exact_f32


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - x)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 (JAX's "bicubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=16)
def resize_weights(n_in: int, n_out: int, kernel) -> np.ndarray:
    """[n_in, n_out] f32 weights of ``jax.image.resize`` along one axis:
    the kernel widened by the downscale factor (antialiased when
    shrinking), columns normalized, samples outside the input zeroed.
    Kept for repeated sizes (read-only)."""
    # the scale and its inverse in double precision, then f32, as JAX
    # computes them from Python floats
    inv = 1.0 / (n_out / n_in)
    kscale = max(inv, 1.0)
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) * np.float32(inv) - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / np.float32(kscale)
    w = kernel(x).astype(np.float32)
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0.0).astype(np.float32)
    w.flags.writeable = False
    return w


@exact_f32()
def _resize(img: torch.Tensor, out_h: int, out_w: int, kernel) -> torch.Tensor:
    H, W = img.shape[:2]
    wh = torch.tensor(resize_weights(H, out_h, kernel), device=img.device)
    ww = torch.tensor(resize_weights(W, out_w, kernel), device=img.device)
    return torch.einsum("hwc,hy,wx->yxc", img.float(), wh, ww)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[H, W, C] -> [out_h, out_w, C] f32, ``jax.image.resize(...,
    "bilinear")`` (antialiased downsampling)."""
    return _resize(img, out_h, out_w, _triangle)


def resize_bicubic(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[H, W, C] -> [out_h, out_w, C] f32, ``jax.image.resize(...,
    "bicubic")``: Keys' kernel with a = -0.5, out-of-image taps dropped and
    the rest renormalized (not ``F.interpolate``'s clamped a = -0.75)."""
    return _resize(img, out_h, out_w, _keys_cubic)
