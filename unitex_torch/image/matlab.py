"""MATLAB-parity resize, torch-parity ``interpolate`` and the BT.601 YCbCr
conversions (port of unitex_tpu/image/matlab.py; basicsr's
matlab_functions.py and color_util.py).

Every resize is a separable weighted gather: the (weights, indices)
tables are computed once on the host per (in_len, out_len, mode), in
float64 and then float32 as the JAX package computes them, and applied to
the image on its device as an index gather and a contraction per axis.

Conventions: images are [..., H, W, C] float in [0, 1]; ``imresize``
matches MATLAB bicubic (a = −0.5, antialiased when downscaling, symmetric
edge padding); ``interpolate`` matches ``F.interpolate(align_corners=
False, antialias=False)`` for bilinear and bicubic (a = −0.75, border
replicate) and ``area`` (adaptive average pooling).  A numpy input gives
a numpy output, a tensor a tensor.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..utils.precision import exact_f32


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic kernel; a = −0.5 is MATLAB's, a = −0.75 torch's."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return np.where(
        ax <= 1,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax <= 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )


def _linear(x: np.ndarray) -> np.ndarray:
    return np.clip(1.0 - np.abs(x), 0.0, None)


@lru_cache(maxsize=256)
def _matlab_weights(in_len: int, out_len: int, scale: float,
                    antialiasing: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(weights [out, P] f32, 0-based indices [out, P] into the unpadded
    axis, possibly out of range: the caller mirrors them), MATLAB's
    bicubic contribution table."""
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width /= scale
    u = (np.arange(out_len, dtype=np.float64) + 0.5) / scale - 0.5
    left = np.floor(u - kernel_width / 2).astype(np.int64)
    p = int(math.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :]
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale, -0.5)
    else:
        weights = _cubic(dist, -0.5)
    weights = weights / weights.sum(axis=1, keepdims=True)
    # drop an all-zero first or last column (MATLAB's trim)
    zero_cols = (weights == 0).sum(axis=0)
    if not math.isclose(float(zero_cols[0]), 0, rel_tol=1e-6):
        indices, weights = indices[:, 1:], weights[:, 1:]
    if not math.isclose(float(zero_cols[-1]), 0, rel_tol=1e-6):
        indices, weights = indices[:, :-1], weights[:, :-1]
    return weights.astype(np.float32), indices


def _mirror(indices: np.ndarray, n: int) -> np.ndarray:
    """Indices into an axis of length n under symmetric (whole-sample
    mirror) padding, ``np.pad(mode="symmetric")``'s, period 2n."""
    m = np.mod(indices, 2 * n)
    return np.where(m >= n, 2 * n - 1 - m, m)


def _apply_axis(img: torch.Tensor, weights: np.ndarray, indices: np.ndarray,
                axis: int) -> torch.Tensor:
    """out[..., o, ...] = Σ_p weights[o, p] · img[..., indices[o, p], ...]
    along ``axis`` (indices in range)."""
    out_len, p = indices.shape
    idx = torch.as_tensor(indices.reshape(-1), device=img.device)
    g = torch.index_select(img, axis, idx)
    g = g.reshape(*img.shape[:axis], out_len, p, *img.shape[axis + 1:])
    w = torch.as_tensor(weights, device=img.device)
    n = img.dim()
    return torch.einsum(
        g, [*range(axis), n, n + 1, *range(axis + 1, n)], w, [n, n + 1],
        [*range(axis), n, *range(axis + 1, n)])


def _as_f32(img) -> torch.Tensor:
    if isinstance(img, np.ndarray):
        return torch.from_numpy(np.asarray(img, np.float32))
    return torch.as_tensor(img).float()


@exact_f32()
def imresize(img, scale: float, antialiasing: bool = True):
    """MATLAB-compatible bicubic resize of [..., H, W, C] in [0, 1]: the
    a = −0.5 kernel, antialiased downscale, symmetric padding, out =
    ceil(in · scale)."""
    arr = _as_f32(img)
    h, w = arr.shape[-3], arr.shape[-2]
    out_h, out_w = math.ceil(h * scale), math.ceil(w * scale)
    wh, ih = _matlab_weights(h, out_h, scale, antialiasing)
    ww, iw = _matlab_weights(w, out_w, scale, antialiasing)
    arr = _apply_axis(arr, wh, _mirror(ih, h), arr.dim() - 3)
    arr = _apply_axis(arr, ww, _mirror(iw, w), arr.dim() - 2)
    if isinstance(img, np.ndarray):
        return arr.numpy()
    return arr


@lru_cache(maxsize=512)
def _torch_weights(in_len: int, out_len: int,
                   mode: str) -> Tuple[np.ndarray, np.ndarray]:
    """(weights, clamped indices) of ``F.interpolate``: align_corners
    False, no antialias, border replicate through clamped indices;
    'area' is adaptive average pooling."""
    if mode == "area":
        p = int(math.ceil(in_len / out_len)) + 1
        starts = (np.arange(out_len) * in_len) // out_len
        ends = -(-(np.arange(1, out_len + 1) * in_len) // out_len)  # ceil
        indices = starts[:, None] + np.arange(p)[None, :]
        weights = ((indices < ends[:, None]).astype(np.float64)
                   / (ends - starts)[:, None])
        indices = np.minimum(indices, in_len - 1)
        return weights.astype(np.float32), indices
    scale = out_len / in_len
    u = (np.arange(out_len, dtype=np.float64) + 0.5) / scale - 0.5
    if mode == "bilinear":
        width, kern = 2.0, _linear
    elif mode == "bicubic":
        width, kern = 4.0, lambda x: _cubic(x, -0.75)
    else:
        raise ValueError(f"unknown interpolate mode {mode!r}")
    left = np.floor(u - width / 2).astype(np.int64) + 1
    p = int(width)
    indices = left[:, None] + np.arange(p)[None, :]
    weights = kern(u[:, None] - indices)
    s = weights.sum(axis=1, keepdims=True)
    weights = np.where(s > 0, weights / np.where(s == 0, 1, s), weights)
    indices = np.clip(indices, 0, in_len - 1)
    return weights.astype(np.float32), indices


@exact_f32()
def interpolate(img, size: Tuple[int, int],
                mode: str = "bilinear") -> torch.Tensor:
    """``F.interpolate`` parity on [..., H, W, C]: 'area', 'bilinear' or
    'bicubic' (align_corners False, no antialias)."""
    arr = _as_f32(img)
    h, w = arr.shape[-3], arr.shape[-2]
    wh, ih = _torch_weights(h, size[0], mode)
    ww, iw = _torch_weights(w, size[1], mode)
    arr = _apply_axis(arr, wh, ih, arr.dim() - 3)
    return _apply_axis(arr, ww, iw, arr.dim() - 2)


# ITU-R BT.601 "studio swing" matrices (MATLAB rgb2ycbcr)
_RGB2YCBCR = np.array([[65.481, -37.797, 112.0],
                       [128.553, -74.203, -93.786],
                       [24.966, 112.0, -18.214]], np.float32)
_YCBCR_OFFSET = np.array([16.0, 128.0, 128.0], np.float32)


@exact_f32()
def rgb2ycbcr(img, y_only: bool = False) -> torch.Tensor:
    """float [0, 1] RGB [..., 3] -> YCbCr in the uint8 range scaled to
    [0, 1] (MATLAB's output / 255, basicsr's float path)."""
    img = _as_f32(img)
    m = torch.as_tensor(_RGB2YCBCR, device=img.device)
    if y_only:
        out = (img @ m[:, 0] + 16.0)[..., None]
    else:
        out = img @ m + torch.as_tensor(_YCBCR_OFFSET, device=img.device)
    return out / 255.0


def bgr2ycbcr(img, y_only: bool = False) -> torch.Tensor:
    return rgb2ycbcr(torch.flip(_as_f32(img), dims=(-1,)), y_only=y_only)


@exact_f32()
def ycbcr2rgb(img) -> torch.Tensor:
    """Inverse of :func:`rgb2ycbcr`."""
    img = _as_f32(img) * 255.0
    inv = np.linalg.inv(_RGB2YCBCR).astype(np.float32)
    return ((img - torch.as_tensor(_YCBCR_OFFSET, device=img.device))
            @ torch.as_tensor(inv, device=img.device))


@exact_f32()
def rgb_to_grayscale(img) -> torch.Tensor:
    """ITU-R 601 luma, 0.299 R + 0.587 G + 0.114 B, as [..., 1]."""
    img = _as_f32(img)
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                     device=img.device)
    return (img @ w)[..., None]
