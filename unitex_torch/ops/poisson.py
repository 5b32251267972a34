"""Poisson blending and diffusion inpainting as fixed-count Jacobi solves
(port of unitex_tpu/ops/poisson.py).

* :func:`poisson_blend` — solve ∇²f = ∇²src inside the mask with dst as
  the Dirichlet boundary (seamless cloning's NORMAL_CLONE semantics).
* :func:`diffusion_inpaint` — fill masked pixels by repeated neighbour
  averaging (the harmonic fill with the valid pixels as boundary).
* :func:`soft_blend` — feathered alpha compositing.

Images are channels-last [H, W, C], masks [H, W, 1] bool.  Neighbour sums
replicate the edge, as the JAX package's concatenations do.
"""

from __future__ import annotations

import torch


def _shifted(x: torch.Tensor):
    """The up, down, left and right neighbours of each pixel, the edge
    replicated."""
    up = torch.cat([x[:1], x[:-1]], dim=0)
    down = torch.cat([x[1:], x[-1:]], dim=0)
    left = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    right = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    return up, down, left, right


def _laplacian(x: torch.Tensor) -> torch.Tensor:
    """4-neighbour Laplacian with edge replication."""
    up, down, left, right = _shifted(x)
    return up + down + left + right - 4.0 * x


def _neighbor_sum(x: torch.Tensor) -> torch.Tensor:
    up, down, left, right = _shifted(x)
    return up + down + left + right


@torch.no_grad()
def poisson_blend(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                  n_iters: int = 200) -> torch.Tensor:
    """Seamlessly clone ``src`` into ``dst`` inside ``mask``: Jacobi passes
    of f = (Σ_nbr f + div) / 4, div = -∇²src, f held to dst outside."""
    div = -_laplacian(src)
    f = torch.where(mask, src, dst)
    for _ in range(n_iters):
        f = torch.where(mask, (_neighbor_sum(f) + div) * 0.25, dst)
    return f


def soft_blend(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
               feather: int = 5) -> torch.Tensor:
    """Blur the mask edge and lerp: the cheap alternative to the Poisson
    solve."""
    from .image_ops import gaussian_blur

    alpha = torch.clamp(gaussian_blur(mask.to(src.dtype), 2 * feather + 1),
                        0.0, 1.0)
    return src * alpha + dst * (1.0 - alpha)


@torch.no_grad()
def diffusion_inpaint(image: torch.Tensor, hole_mask: torch.Tensor,
                      n_iters: int = 200) -> torch.Tensor:
    """Fill ``hole_mask`` pixels (True = to fill) by Jacobi relaxation
    towards the harmonic function with the valid pixels as boundary; the
    hole starts at the valid region's mean."""
    valid = ~hole_mask
    n_valid = torch.clamp(valid.sum(), min=1)
    mean = torch.sum(image * valid, dim=(0, 1), keepdim=True) / n_valid
    f = torch.where(hole_mask, mean, image)
    for _ in range(n_iters):
        f = torch.where(hole_mask, _neighbor_sum(f) * 0.25, image)
    return f
