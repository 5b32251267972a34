"""Volume and neural-field sampling: 3D grids, triplanes and boxes, point
splats, coordinate (un)discretization and the Cauchy boundary queries
(port of unitex_tpu/render/volume.py).

Conventions as in the JAX package: volumes are channels-last [D, H, W, C]
indexed by (x, y, z) coordinates in [-1, 1] (torch ``grid_sample``'s 3D
convention), planes [H, W, C] sampled with ``ops/grid_sample`` at border
padding, the Cauchy integrals in complex64.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.grid_sample import grid_sample


def grid_sample_3d(volume: torch.Tensor, coords: torch.Tensor,
                   align_corners: bool = False) -> torch.Tensor:
    """Trilinear sampling: volume [D, H, W, C], coords [..., 3] in [-1, 1]
    as (x, y, z) indexing (W, H, D); taps outside the volume are zero."""
    D, H, W = volume.shape[:3]

    def to_pix(g, S):
        if align_corners:
            return (g + 1.0) * 0.5 * (S - 1)
        return (g + 1.0) * 0.5 * S - 0.5

    fx, fy, fz = (to_pix(coords[..., i], S) for i, S in enumerate((W, H, D)))
    x0f, y0f, z0f = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    wx, wy, wz = fx - x0f, fy - y0f, fz - z0f
    x0, y0, z0 = x0f.long(), y0f.long(), z0f.long()
    flat = volume.reshape(D * H * W, -1)

    def fetch(xi, yi, zi):
        idx = ((torch.clamp(zi, 0, D - 1) * H + torch.clamp(yi, 0, H - 1)) * W
               + torch.clamp(xi, 0, W - 1))
        val = flat.index_select(0, idx.reshape(-1)).reshape(*idx.shape, -1)
        inb = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & (zi >= 0)
               & (zi < D))[..., None]
        return torch.where(inb, val, torch.zeros_like(val))

    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((wx if dx else 1 - wx) * (wy if dy else 1 - wy)
                     * (wz if dz else 1 - wz))[..., None]
                out = out + w * fetch(x0 + dx, y0 + dy, z0 + dz)
    return out


def triplane_query(planes: torch.Tensor, coords: torch.Tensor,
                   mode: str = "sum") -> torch.Tensor:
    """Triplane field query: planes [3, H, W, C] (xy, xz, yz), coords
    [..., 3] in [-1, 1].  ``mode``: "sum" or "concat"."""
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    feats = [grid_sample(planes[i], torch.stack(g, dim=-1), padding_mode="border")
             for i, g in enumerate(((x, y), (x, z), (y, z)))]
    if mode == "sum":
        return feats[0] + feats[1] + feats[2]
    return torch.cat(feats, dim=-1)


def box_query(faces: torch.Tensor, coords: torch.Tensor,
              mode: str = "sum") -> torch.Tensor:
    """Six-plane "box" field query: faces [6, H, W, C] paired per axis
    (xy, xy, xz, xz, yz, yz), coords [..., 3] in [-1, 1].  ``mode``: "sum"
    or "concat"."""
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    pairs = ((x, y), (x, y), (x, z), (x, z), (y, z), (y, z))
    feats = [grid_sample(faces[i], torch.stack(g, dim=-1), padding_mode="border")
             for i, g in enumerate(pairs)]
    if mode == "sum":
        out = feats[0]
        for f in feats[1:]:
            out = out + f
        return out
    return torch.cat(feats, dim=-1)


def discretize_3d(coords_ndc: torch.Tensor, resolution: int,
                  align_corners: bool = False) -> torch.Tensor:
    """NDC [-1, 1]³ -> continuous voxel coordinates."""
    u = coords_ndc * 0.5 + 0.5
    if align_corners:
        return u * (resolution - 1) + 0.5
    return u * resolution


def undiscretize_3d(voxels: torch.Tensor, resolution: int,
                    align_corners: bool = False) -> torch.Tensor:
    if align_corners:
        u = voxels / (resolution - 1)
    else:
        u = (voxels + 0.5) / resolution
    return u * 2.0 - 1.0


def splat_points_to_grid(points: torch.Tensor, values: torch.Tensor,
                         resolution: int,
                         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Average-splat point values [N, C] into an [R, R, R, C] grid: a sum
    into R³ + 1 buckets by ``index_add_`` (masked points go to the last,
    dropped bucket), divided by each voxel's count.  On a CUDA tensor the
    sums' order varies from run to run (float atomics)."""
    R = resolution
    vox = torch.clamp(torch.floor((points * 0.5 + 0.5) * R), 0, R - 1).long()
    idx = (vox[:, 2] * R + vox[:, 1]) * R + vox[:, 0]
    if valid is not None:
        idx = torch.where(valid, idx, torch.full_like(idx, R ** 3))
    C = values.shape[-1]
    num = torch.zeros((R ** 3 + 1, C), dtype=values.dtype, device=values.device)
    den = torch.zeros((R ** 3 + 1, 1), dtype=values.dtype, device=values.device)
    num.index_add_(0, idx, values)
    den.index_add_(0, idx, torch.ones_like(values[:, :1]))
    grid = num[:-1] / torch.clamp(den[:-1], min=1.0)
    return grid.reshape(R, R, R, C)


def discretize_2d(coords_ndc: torch.Tensor, H: int, W: int, ndc: bool = True,
                  align_corners: bool = False) -> torch.Tensor:
    """[..., 2] (u, v) in NDC or [0, 1] -> integer pixel coords (int32):
    floor(u·W), or floor(u·(W - 1) + 0.5) with ``align_corners``."""
    uf, vf = coords_ndc[..., 0], coords_ndc[..., 1]
    if ndc:
        uf, vf = uf * 0.5 + 0.5, vf * 0.5 + 0.5
    if align_corners:
        ui, vi = torch.floor(uf * (W - 1) + 0.5), torch.floor(vf * (H - 1) + 0.5)
    else:
        ui, vi = torch.floor(uf * W), torch.floor(vf * H)
    return torch.stack([ui, vi], dim=-1).to(torch.int32)


def undiscretize_2d(pix: torch.Tensor, H: int, W: int, ndc: bool = True,
                    align_corners: bool = False) -> torch.Tensor:
    """Integer pixel coords -> continuous (u, v), the inverse of
    :func:`discretize_2d`."""
    ui, vi = pix[..., 0].float(), pix[..., 1].float()
    if align_corners:
        uf, vf = ui / (W - 1), vi / (H - 1)
    else:
        uf, vf = (ui + 0.5) / W, (vi + 0.5) / H
    if ndc:
        uf, vf = uf * 2.0 - 1.0, vf * 2.0 - 1.0
    return torch.stack([uf, vf], dim=-1)


def make_grid_2d(H: int, W: int, ndc: bool = True, device="cuda") -> torch.Tensor:
    """[H, W, 2] grid of pixel-centre (x, y) coordinates on ``device``."""
    ys, xs = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    return undiscretize_2d(torch.stack([xs, ys], dim=-1), H, W, ndc=ndc)


def make_grid_3d(D: int, H: int, W: int, ndc: bool = True,
                 device="cuda") -> torch.Tensor:
    """[D, H, W, 3] grid of voxel-centre (x, y, z) coordinates on ``device``."""
    zs, ys, xs = torch.meshgrid(torch.arange(D, device=device),
                                torch.arange(H, device=device),
                                torch.arange(W, device=device), indexing="ij")

    def un(i, S):
        u = (i.float() + 0.5) / S
        return u * 2.0 - 1.0 if ndc else u

    return torch.stack([un(xs, W), un(ys, H), un(zs, D)], dim=-1)


def scale_tensor(dat, inp_scale, tgt_scale):
    """Affine range remap [inp_scale -> tgt_scale]; scales default to (0, 1)."""
    if inp_scale is None:
        inp_scale = (0.0, 1.0)
    if tgt_scale is None:
        tgt_scale = (0.0, 1.0)
    dat = (dat - inp_scale[0]) / (inp_scale[1] - inp_scale[0])
    return dat * (tgt_scale[1] - tgt_scale[0]) + tgt_scale[0]


def contract_to_unisphere(x: torch.Tensor, bbox,
                          unbounded: bool = False) -> torch.Tensor:
    """Points into [0, 1]³ for field queries: bounded, a plain bbox
    normalization; unbounded, the mip-NeRF-360 contraction of the exterior
    (|x| > 1 squashed to radius < 2, the result scaled to [0, 1])."""
    x = scale_tensor(x, bbox, (0.0, 1.0))
    if not unbounded:
        return x
    x = x * 2.0 - 1.0
    mag = torch.linalg.norm(x, dim=-1, keepdim=True)
    safe = torch.clamp(mag, min=1e-12)
    contracted = (2.0 - 1.0 / safe) * (x / safe)
    x = torch.where(mag > 1.0, contracted, x)
    return x / 4.0 + 0.5


# ------------------------------------------------- Cauchy boundary queries


def create_circle(n: int, radius: float = 1.0, t_0: float = 0.0, device="cuda"):
    """The closed circle contour at ``n + 1`` parameter samples and its
    derivative: ``(t, d_t, gamma, d_gamma)``, gamma and d_gamma complex64,
    d_gamma with the uniform quadrature weight 1/n at every sample (both
    ends of the duplicated t = 0 / t = 1 point included)."""
    t = torch.linspace(0.0, 1.0, n + 1, dtype=torch.float32, device=device)
    d_t = torch.full((n + 1,), 1.0 / n, dtype=torch.float32, device=device)
    ang = 2.0 * math.pi * (t - t_0)
    gamma = radius * torch.complex(torch.cos(ang), torch.sin(ang))
    d_gamma = (radius * 2.0 * math.pi
               * torch.complex(-torch.sin(ang), torch.cos(ang))) * d_t
    return t, d_t, gamma.to(torch.complex64), d_gamma.to(torch.complex64)


def cauchy_integrate(z: torch.Tensor, gamma: torch.Tensor, d_gamma: torch.Tensor,
                     f_gamma: torch.Tensor) -> torch.Tensor:
    """Discrete Cauchy integral (1 / 2πi) Σ f(γ) γ' dt / (γ - z): boundary
    features extended to interior points.  z [...], gamma / d_gamma [N],
    f_gamma [..., N, C] -> [..., C] complex."""
    zc = z.to(torch.complex64)[..., None, None]
    c = f_gamma * (d_gamma[:, None] / (gamma[:, None] - zc))
    return c.sum(dim=-2) / (2j * math.pi)


def query_circle(positions: torch.Tensor, circles: torch.Tensor) -> torch.Tensor:
    """Circle boundary-field query: features on the unit circle (Wc
    samples a channel) extended to 2D points by the Cauchy integral.
    positions [B, N, 2] in the unit disk, circles [B, Cc, Wc] -> [B, N, Cc]."""
    Wc = circles.shape[-1]
    circles = torch.cat([circles, circles[..., :1]], dim=-1)
    _, _, gamma, d_gamma = create_circle(Wc, device=circles.device)
    z = torch.complex(positions[..., 0], positions[..., 1])
    f_gamma = circles.transpose(-1, -2)[:, None]        # [B, 1, Wc+1, Cc]
    return cauchy_integrate(z, gamma, d_gamma, f_gamma).real


def query_cylinder(positions: torch.Tensor, cylinders: torch.Tensor) -> torch.Tensor:
    """Cylinder boundary-field query: features on Dc rings of Wc samples,
    the circle query of each ring on (x, y), linearly interpolated along
    z in [-1, 1].  positions [B, N, 3], cylinders [B, Cc, Dc, Wc] ->
    [B, N, Cc]."""
    B, Cc, Dc, Wc = cylinders.shape
    rings = torch.cat([cylinders, cylinders[..., :1]], dim=-1)
    _, _, gamma, d_gamma = create_circle(Wc, device=cylinders.device)
    z2d = torch.complex(positions[..., 0], positions[..., 1])
    f_gamma = torch.movedim(rings, 1, -1)[:, None]      # [B, 1, Dc, Wc+1, Cc]
    per_ring = cauchy_integrate(z2d[..., None], gamma, d_gamma, f_gamma).real
    if Dc == 1:
        return per_ring[:, :, 0]
    zf = torch.clamp((positions[..., 2] + 1.0) / 2.0 * (Dc - 1), 0.0, Dc - 1)
    lo = torch.clamp(torch.floor(zf).long(), 0, Dc - 2)
    w = (zf - lo)[..., None]
    take = lo[..., None, None].expand(-1, -1, 1, Cc)
    a = torch.gather(per_ring, 2, take)[:, :, 0]
    b = torch.gather(per_ring, 2, take + 1)[:, :, 0]
    return a * (1.0 - w) + b * w
