"""Point visibility by ray casting (port of unitex_tpu/ops/visibility.py).

``self_rt``: a point is inner if every one of its random rays hits the
mesh; ``cross_rt``: a point is inner if the mesh blocks it from every
given outer point; ``sphere_rt`` and ``sphere_rt_views``: the triangles
hit by rays shot inward from a bounding sphere.  Each is one call of
:func:`~.raytrace.ray_triangle_intersect`.  The random ray directions
are taken as standard-normal ``directions`` (else drawn from
``generator`` on the mesh's device).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .raytrace import ray_triangle_intersect


def _unit_draws(n: int, directions, generator, device) -> torch.Tensor:
    if directions is None:
        directions = torch.randn((n, 3), generator=generator, device=device)
    d = torch.as_tensor(directions, dtype=torch.float32).to(device)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)


def self_rt(
    points: torch.Tensor,
    vertices: torch.Tensor,
    faces: torch.Tensor,
    n_rays: int = 32,
    directions: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Inner-point mask [N]: all ``n_rays`` random rays from the point hit
    the mesh.  ``directions`` [N·n_rays, 3], point-major."""
    N = points.shape[0]
    rays_o = torch.repeat_interleave(points, n_rays, dim=0)
    rays_d = _unit_draws(N * n_rays, directions, generator, points.device)
    hits = ray_triangle_intersect(rays_o, rays_d, vertices, faces)
    return hits.hit.reshape(N, n_rays).all(dim=-1)


def cross_rt(
    points: torch.Tensor,
    outer_points: torch.Tensor,
    vertices: torch.Tensor,
    faces: torch.Tensor,
) -> torch.Tensor:
    """Inner-point mask [N]: the mesh blocks the segment from every outer
    point [M, 3] to the point; a point seen from any outer point is
    outer."""
    N, M = points.shape[0], outer_points.shape[0]
    tgt = points[:, None, :].expand(N, M, 3).reshape(-1, 3)
    src = outer_points[None, :, :].expand(N, M, 3).reshape(-1, 3)
    d = tgt - src
    dist = torch.linalg.norm(d, dim=-1)
    rays_d = d / torch.clamp(dist[:, None], min=1e-12)
    hits = ray_triangle_intersect(src, rays_d, vertices, faces)
    return (hits.hit & (hits.t < dist)).reshape(N, M).all(dim=-1)


def sphere_rt(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    n_rays: int = 1000,
    sample_offset: float = 0.0,
    directions: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Triangle ids [n_rays] hit by rays shot inward from a sphere of
    radius √3·(1 + offset) (-1 for a miss); ``directions`` [n_rays, 3]
    place the rays' origins."""
    radius = math.sqrt(3.0) * (1.0 + sample_offset)
    rays_d = _unit_draws(n_rays, directions, generator, vertices.device)
    hits = ray_triangle_intersect(radius * rays_d, -rays_d, vertices, faces)
    return torch.where(hits.hit, hits.tri, torch.full_like(hits.tri, -1))


def sphere_rt_views(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    n_cameras: int = 6,
    sample_offset: float = 0.0,
    directions: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Rays from the ±x/±y/±z sphere points toward the origin (4 or 6
    views; any other count draws its points from ``directions`` or
    ``generator``).  Returns [n] triangle ids, -1 for a miss."""
    radius = math.sqrt(3.0) * (1.0 + sample_offset)
    axes = [[-1.0, 0, 0], [0, -1.0, 0], [1.0, 0, 0], [0, 1.0, 0],
            [0, 0, -1.0], [0, 0, 1.0]]
    if n_cameras in (4, 6):
        dirs = torch.tensor(axes[:n_cameras], dtype=torch.float32,
                            device=vertices.device)
    else:
        dirs = -_unit_draws(n_cameras, directions, generator, vertices.device)
    hits = ray_triangle_intersect(-radius * dirs, dirs, vertices, faces)
    return torch.where(hits.hit, hits.tri, torch.full_like(hits.tri, -1))
