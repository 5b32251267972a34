"""Environment maps for split-sum PBR shading (port of
unitex_tpu/texture/envmap.py).

Equirectangular [H, W, 3] radiance maps (+z up, longitude atan2(y, x)),
bilinear lookups with border padding; diffuse irradiance from the 9
spherical-harmonic coefficients of the cosine lobe; specular
prefiltering as gaussian blurs sized to the GGX lobe at increasing
roughness, interpolated between levels; Karis' analytic split-sum BRDF
approximation in place of a baked LUT.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..ops.grid_sample import grid_sample
from ..ops.image_ops import gaussian_blur

_SH_A = (3.141593, 2.094395, 2.094395, 2.094395,
         0.785398, 0.785398, 0.785398, 0.785398, 0.785398)


def direction_to_equirect(d: torch.Tensor) -> torch.Tensor:
    """Unit directions [..., 3] -> equirect grid coordinates [..., 2] in
    [-1, 1]; +z maps to the top row."""
    lon = torch.atan2(d[..., 1], d[..., 0])
    lat = torch.asin(torch.clamp(d[..., 2], -1.0, 1.0))
    return torch.stack([lon / math.pi, -lat / (math.pi / 2)], dim=-1)


def equirect_dirs(H: int, W: int, device="cuda") -> torch.Tensor:
    """Unit directions of an equirect map's texel centres [H, W, 3]."""
    v = (torch.arange(H, device=device) + 0.5) / H
    u = (torch.arange(W, device=device) + 0.5) / W
    lat = (0.5 - v) * math.pi
    lon = (u * 2.0 - 1.0) * math.pi
    gl, gn = torch.meshgrid(lat, lon, indexing="ij")
    return torch.stack([torch.cos(gl) * torch.cos(gn),
                        torch.cos(gl) * torch.sin(gn), torch.sin(gl)], dim=-1)


def sample_envmap(env: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return grid_sample(env, direction_to_equirect(d), padding_mode="border")


def _sh_basis(d: torch.Tensor) -> torch.Tensor:
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([
        torch.full_like(x, 0.282095),
        0.488603 * y, 0.488603 * z, 0.488603 * x,
        1.092548 * x * y, 1.092548 * y * z,
        0.315392 * (3 * z * z - 1),
        1.092548 * x * z,
        0.546274 * (x * x - y * y),
    ], dim=-1)


def sh_project_irradiance(env: torch.Tensor) -> torch.Tensor:
    """The 9 SH irradiance coefficients [9, 3] of an equirect radiance
    map, the cosine lobe's convolution weights applied."""
    H, W = env.shape[:2]
    basis = _sh_basis(equirect_dirs(H, W, env.device))
    v = (torch.arange(H, device=env.device) + 0.5) / H
    # each texel's solid angle: sin(colatitude) dθ dφ
    dw = torch.sin(v * math.pi)[:, None] * (math.pi / H) * (2 * math.pi / W)
    coeffs = torch.einsum("hwn,hwc->nc", basis * dw[..., None], env)
    return coeffs * coeffs.new_tensor(_SH_A)[:, None]


def sh_irradiance(coeffs: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Irradiance / π (the Lambertian diffuse light) at normals [..., 3]
    from [9, 3] coefficients."""
    return torch.clamp(_sh_basis(n) @ coeffs, min=0.0) / math.pi


def prefilter_specular_levels(env: torch.Tensor,
                              n_levels: int = 5) -> Tuple[torch.Tensor, ...]:
    """Blurred radiance maps at roughness i / (n_levels - 1): level i's
    gaussian kernel spans the GGX lobe, about roughness² · H / 2 texels
    (odd, at least 3, below H)."""
    H = env.shape[0]
    levels = [env]
    for i in range(1, n_levels):
        rough = i / (n_levels - 1)
        k = max(3, int(rough * rough * H * 0.5) | 1)
        levels.append(gaussian_blur(env, min(k, H // 2 * 2 - 1)))
    return tuple(levels)


def sample_prefiltered(levels: Tuple[torch.Tensor, ...], d: torch.Tensor,
                       roughness: torch.Tensor) -> torch.Tensor:
    """The prefiltered radiance along ``d``, linear in roughness between
    the two nearest levels."""
    n = len(levels)
    r = torch.clamp(roughness[..., 0] if roughness.dim() == d.dim()
                    else roughness, 0, 1)
    f = r * (n - 1)
    lo = torch.clamp(torch.floor(f).long(), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    w = (f - lo.to(f.dtype))[..., None]
    stack = torch.stack([sample_envmap(lv, d) for lv in levels], dim=0)

    def take(i):
        return torch.gather(stack, 0, i[None, ..., None].expand(
            1, *i.shape, stack.shape[-1]))[0]

    return take(lo) * (1 - w) + take(hi) * w


def karis_brdf_lut(n_dot_v, roughness) -> torch.Tensor:
    """Karis' analytic approximation of the split-sum BRDF integral ->
    [..., 2] (scale, bias)."""
    nv = torch.as_tensor(n_dot_v, dtype=torch.float32)
    r = torch.as_tensor(roughness, dtype=torch.float32)
    if nv.dim() and nv.shape[-1] == 1:
        nv = nv[..., 0]
    if r.dim() and r.shape[-1] == 1:
        r = r[..., 0]
    c0 = r.new_tensor([-1.0, -0.0275, -0.572, 0.022])
    c1 = r.new_tensor([1.0, 0.0425, 1.04, -0.04])
    rv = r[..., None] * c0 + c1
    a004 = (torch.minimum(rv[..., 0] * rv[..., 0], torch.exp2(-9.28 * nv))
            * rv[..., 0] + rv[..., 1])
    return torch.stack([a004 * -1.04 + rv[..., 2], a004 * 1.04 + rv[..., 3]],
                       dim=-1)


def shade_split_sum(kd: torch.Tensor, arm: torch.Tensor, nrm: torch.Tensor,
                    wo: torch.Tensor, env: torch.Tensor,
                    n_levels: int = 5) -> torch.Tensor:
    """Split-sum environment shading against an equirect map."""
    from .pbr import split_sum_shading

    coeffs = sh_project_irradiance(env)
    levels = prefilter_specular_levels(env, n_levels)
    return split_sum_shading(
        kd, arm, nrm, wo,
        diffuse_env_fn=lambda n: sh_irradiance(coeffs, n),
        specular_env_fn=lambda d, r: sample_prefiltered(levels, d, r),
        brdf_lut_fn=karis_brdf_lut,
    )
