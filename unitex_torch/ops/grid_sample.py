"""Bilinear grid sampling (port of unitex_tpu/ops/grid_sample.py).

The JAX package's own convention, kept as it is rather than delegated to
``F.grid_sample``: channels-last image [H, W, C], an (x, y) grid in
[-1, 1] of any leading shape, ``pix = (g + 1) / 2 * S - 0.5``
(align_corners=False), zero padding, and four explicit taps blended as
``v00 (1-wx)(1-wy) + v01 wx (1-wy) + v10 (1-wx) wy + v11 wx wy``.  The
bake samples its views this way; the border padding and align_corners
variants have no caller in the port.
"""

from __future__ import annotations

import torch


def grid_sample(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """image [H, W, C], grid [..., 2] with (x, y) in [-1, 1] -> [..., C].
    x indexes W (columns), y indexes H (rows); taps outside are zero."""
    H, W = image.shape[:2]
    fx = (grid[..., 0] + 1.0) * 0.5 * W - 0.5
    fy = (grid[..., 1] + 1.0) * 0.5 * H - 0.5
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    wx = (fx - x0f)[..., None]
    wy = (fy - y0f)[..., None]
    x0 = x0f.long()
    y0 = y0f.long()

    def fetch(xi, yi):
        val = image[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
        inb = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))[..., None]
        return torch.where(inb, val, torch.zeros_like(val))

    v00 = fetch(x0, y0)
    v01 = fetch(x0 + 1, y0)
    v10 = fetch(x0, y0 + 1)
    v11 = fetch(x0 + 1, y0 + 1)
    return (
        v00 * (1 - wx) * (1 - wy)
        + v01 * wx * (1 - wy)
        + v10 * (1 - wx) * wy
        + v11 * wx * wy
    )
