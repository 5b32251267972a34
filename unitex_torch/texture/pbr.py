"""Physically-based shading terms in PyTorch (port of
unitex_tpu/texture/pbr.py): nvdiffrec's renderutils BSDF suite as plain
elementwise math.

Schlick Fresnel, the GGX normal distribution, Smith masking, Lambert and
Frostbite diffuse, the combined ``pbr_specular`` / ``pbr_bsdf``,
tangent-space shading normals, split-sum environment shading and the
tonemapped image loss.  Conventions follow nvdiffrec: vectors [..., 3] in
world space, ``nrm`` unit, ``wo`` the view direction (surface to eye),
``wi`` the light direction (surface to light), ``min_roughness`` clamps
the GGX alpha.
"""

from __future__ import annotations

import math

import torch

SPECULAR_EPSILON = 1e-4


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _safe_normalize(v, eps=1e-20):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def fresnel_schlick(f0, f90, cos_theta):
    """Schlick's approximation."""
    scale = torch.pow(torch.clamp(1.0 - cos_theta, SPECULAR_EPSILON, 1.0), 5.0)
    return f0 * (1.0 - scale) + f90 * scale


def ndf_ggx(alpha_sqr, cos_theta):
    """GGX (Trowbridge-Reitz) normal distribution."""
    c = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    d = (c * alpha_sqr - c) * c + 1.0
    return alpha_sqr / (d * d * math.pi)


def lambda_ggx(alpha_sqr, cos_theta):
    """Smith's lambda term."""
    c = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    cs = c * c
    tan_sqr = (1.0 - cs) / cs
    return 0.5 * (torch.sqrt(1.0 + alpha_sqr * tan_sqr) - 1.0)


def masking_smith(alpha_sqr, cos_theta_i, cos_theta_o):
    """Height-correlated Smith masking-shadowing."""
    li = lambda_ggx(alpha_sqr, cos_theta_i)
    lo = lambda_ggx(alpha_sqr, cos_theta_o)
    return 1.0 / (1.0 + li + lo)


def lambert(nrm, wi):
    """Lambert diffuse: max(n·wi, 0) / π."""
    return torch.clamp(_dot(nrm, wi), min=0.0) / math.pi


def frostbite_diffuse(nrm, wi, wo, linear_roughness):
    """Frostbite's normalized Disney diffuse."""
    wi_dot_n = _dot(wi, nrm)
    wo_dot_n = _dot(wo, nrm)
    h = _safe_normalize(wo + wi)
    wi_dot_h = _dot(wi, h)
    energy_bias = 0.5 * linear_roughness
    energy_factor = 1.0 - (0.51 / 1.51) * linear_roughness
    f90 = energy_bias + 2.0 * wi_dot_h * wi_dot_h * linear_roughness
    light_scatter = fresnel_schlick(1.0, f90, wi_dot_n)
    view_scatter = fresnel_schlick(1.0, f90, wo_dot_n)
    mask = (wi_dot_n > 0) & (wo_dot_n > 0)
    val = (light_scatter * view_scatter * energy_factor
           * torch.clamp(wi_dot_n, min=0.0) / math.pi)
    return torch.where(mask, val, torch.zeros_like(val))


def pbr_specular(col, nrm, wo, wi, alpha, min_roughness=0.08):
    """Cook-Torrance GGX specular."""
    _alpha = torch.clamp(alpha, min_roughness * min_roughness, 1.0)
    alpha_sqr = _alpha * _alpha
    h = _safe_normalize(wo + wi)
    wo_dot_n = _dot(wo, nrm)
    wi_dot_n = _dot(wi, nrm)
    wo_dot_h = _dot(wo, h)
    n_dot_h = _dot(nrm, h)
    d = ndf_ggx(alpha_sqr, n_dot_h)
    g = masking_smith(alpha_sqr, wo_dot_n, wi_dot_n)
    f = fresnel_schlick(col, 1.0, wo_dot_h)
    w = f * d * g * 0.25 / torch.clamp(wo_dot_n, min=SPECULAR_EPSILON)
    frontfacing = (wo_dot_n > SPECULAR_EPSILON) & (wi_dot_n > SPECULAR_EPSILON)
    return torch.where(frontfacing, w, torch.zeros_like(w))


def pbr_bsdf(kd, arm, pos, nrm, view_pos, light_pos, min_roughness=0.08,
             bsdf="lambert"):
    """The full BSDF under a point light: ``kd`` albedo, ``arm`` =
    (specular strength, roughness, metallic)."""
    wo = _safe_normalize(view_pos - pos)
    wi = _safe_normalize(light_pos - pos)
    spec_str = arm[..., 0:1]
    roughness = arm[..., 1:2]
    metallic = arm[..., 2:3]
    ks = (0.04 * (1.0 - metallic) + kd * metallic) * (1.0 - spec_str)
    kd_diff = kd * (1.0 - metallic)
    if bsdf == "lambert":
        diffuse = kd_diff * lambert(nrm, wi)
    else:
        diffuse = kd_diff * frostbite_diffuse(nrm, wi, wo, roughness)
    specular = pbr_specular(ks, nrm, wo, wi, roughness * roughness, min_roughness)
    return diffuse + specular


def prepare_shading_normal(
    pos, view_pos, perturbed_nrm, smooth_nrm, smooth_tng, geom_nrm,
    two_sided_shading=True, opengl=True,
):
    """Tangent-space normal mapping, then the two-sided flip toward the
    viewer."""
    smooth_nrm = _safe_normalize(smooth_nrm)
    smooth_tng = _safe_normalize(smooth_tng)
    smooth_bitng = _safe_normalize(torch.linalg.cross(smooth_tng, smooth_nrm,
                                                      dim=-1))
    sign = -1.0 if opengl else 1.0
    shading_nrm = (smooth_tng * perturbed_nrm[..., 0:1]
                   + sign * smooth_bitng * perturbed_nrm[..., 1:2]
                   + smooth_nrm * torch.clamp(perturbed_nrm[..., 2:3], min=0.0))
    shading_nrm = _safe_normalize(shading_nrm)
    if two_sided_shading:
        flip = _dot(geom_nrm, view_pos - pos) < 0
        shading_nrm = torch.where(flip, -shading_nrm, shading_nrm)
    return shading_nrm


def reflect(wo, nrm):
    return 2.0 * _dot(nrm, wo) * nrm - wo


def split_sum_shading(kd, arm, nrm, wo, diffuse_env_fn, specular_env_fn,
                      brdf_lut_fn):
    """Split-sum environment shading: the diffuse irradiance lookup plus
    the prefiltered specular scaled by the BRDF LUT.
    ``diffuse_env_fn(dir) -> [..., 3]``, ``specular_env_fn(dir,
    roughness) -> [..., 3]``, ``brdf_lut_fn(n·v, roughness) -> [..., 2]``
    (scale, bias)."""
    roughness = arm[..., 1:2]
    metallic = arm[..., 2:3]
    kd_diff = kd * (1.0 - metallic)
    ks = 0.04 * (1.0 - metallic) + kd * metallic
    n_dot_v = torch.clamp(_dot(nrm, wo), SPECULAR_EPSILON, 1.0)
    refl = reflect(wo, nrm)
    diffuse = kd_diff * diffuse_env_fn(nrm)
    lut = brdf_lut_fn(n_dot_v, roughness)
    spec_col = ks * lut[..., 0:1] + lut[..., 1:2]
    return diffuse + spec_col * specular_env_fn(refl, roughness)


def image_loss(img, target, loss: str = "l1", tonemapper: str = "log_srgb"):
    """nvdiffrec's tonemapped image loss (``l1`` or ``mse``)."""

    def tonemap(x):
        if tonemapper != "log_srgb":
            return x
        x = torch.log(torch.clamp(x, 0.0, 65535.0) + 1.0)
        return torch.where(
            x > 0.0031308,
            torch.pow(torch.clamp(x, min=0.0031308), 1.0 / 2.4) * 1.055 - 0.055,
            12.92 * x)

    a, b = tonemap(img), tonemap(target)
    err = torch.abs(a - b) if loss == "l1" else (a - b) ** 2
    return err.mean()
