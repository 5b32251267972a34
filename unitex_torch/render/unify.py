"""Unified RGB / PBR renders of a mesh file over a camera sweep (port of
unitex_tpu/render/unify.py).

Two sweeps:

* v1: an orbit at radius 2.8 with fixed intrinsics (fov 49.1°
  perspective, or ortho scale 0.85), :func:`generate_cameras_v1`;
* v2: a fixed front pose with an intrinsics sweep (fov 0–90°, or ortho
  scale 0–2), :func:`generate_cameras_v2`.

The PBR render shades the albedo and (occlusion, roughness, metallic)
maps with the BSDF terms of ``texture/pbr.py`` under a headlight at the
camera and returns ``rgb``, ``diffuse`` and ``specular`` frames, each
with its ``lambda_*`` scale.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from ..camera.generator import generate_intrinsics, generate_orbit_views_c2ws
from ..geometry.io.mesh_io import HostMesh, load_mesh
from ..geometry.mesh import Mesh
from ..texture.pbr import frostbite_diffuse, lambert, pbr_specular
from ..utils.image_io import to_uint8_device
from ..utils.precision import resolve_device
from .renderer import render_views


def generate_cameras_v1(n_frames: int = 8, perspective: bool = True,
                        device="cuda"):
    """Orbit sweep: [N, 4, 4] c2ws and [3, 3] intrinsics."""
    c2ws = generate_orbit_views_c2ws(n_frames + 1, radius=2.8, height=0.0,
                                     device=device)[:n_frames]
    if perspective:
        intr = generate_intrinsics(49.1, 49.1, fov=True, degree=True,
                                   device=device)
    else:
        intr = generate_intrinsics(0.85, 0.85, fov=False, device=device)
    return c2ws, intr


def generate_cameras_v2(n_frames: int = 8, perspective: bool = True,
                        device="cuda"):
    """Fixed front pose, intrinsics sweep: [N, 4, 4] c2ws and [N, 3, 3]."""
    c2w = generate_orbit_views_c2ws(1, radius=2.8, height=0.0, device=device)
    c2ws = c2w.expand(n_frames, 4, 4)
    if perspective:
        fovs = np.linspace(0.0, 90.0, n_frames + 1, endpoint=True)[1:]
        intr = torch.stack([generate_intrinsics(f, f, fov=True, degree=True,
                                                device=device) for f in fovs])
    else:
        scales = np.linspace(0.0, 2.0, n_frames + 1, endpoint=True)[1:]
        intr = torch.stack([generate_intrinsics(s, s, fov=False, device=device)
                            for s in scales])
    return c2ws, intr


def _cameras(cameras: str, n_frames: int, perspective: bool, device):
    make = generate_cameras_v1 if cameras == "v1" else generate_cameras_v2
    return make(n_frames, perspective, device=device)


def _device_mesh(hm: HostMesh, device) -> Mesh:
    def put(x, dtype):
        return None if x is None else torch.from_numpy(
            np.ascontiguousarray(x, dtype)).to(device)

    return Mesh(put(hm.vertices, np.float32), put(hm.faces, np.int64),
                uv=put(hm.uv if hm.faces_uv is not None else None, np.float32),
                faces_uv=put(hm.faces_uv if hm.uv is not None else None,
                             np.int64))


def _frames(x: torch.Tensor) -> np.ndarray:
    return to_uint8_device(torch.clamp(x, 0.0, 1.0)).cpu().numpy()


@torch.no_grad()
def unified_rgb_render(
    mesh: Union[str, HostMesh],
    n_frames: int = 8,
    size: int = 512,
    perspective: bool = True,
    cameras: str = "v1",
    background: float = 1.0,
    device="cuda",
) -> np.ndarray:
    """Textured frames (normal-shaded where the mesh has no texture)
    [N, size, size, 3] uint8, rendered on ``device``."""
    dev = resolve_device(device)
    hm = load_mesh(mesh) if isinstance(mesh, str) else mesh
    c2ws, intr = _cameras(cameras, n_frames, perspective, dev)
    textured = hm.texture is not None and hm.uv is not None
    tex = (torch.from_numpy(np.array(hm.texture[..., :3])).to(dev).float()
           / 255.0 if textured else None)
    out = render_views(
        _device_mesh(hm, dev), c2ws, intr, (size, size),
        perspective=perspective, map_attr=tex, render_uv=textured,
        render_map_attr=textured, render_world_normal=not textured,
    )
    rgb = out.map_attr if textured else out.world_normal * 0.5 + 0.5
    return _frames(rgb * out.alpha + background * (1.0 - out.alpha))


@torch.no_grad()
def unified_pbr_render(
    mesh: Union[str, HostMesh],
    n_frames: int = 8,
    size: int = 512,
    perspective: bool = True,
    cameras: str = "v1",
    background: float = 1.0,
    lambda_albedo=(1.0, 1.0, 1.0),
    lambda_metallic: float = 1.0,
    lambda_roughness: float = 1.0,
    lambda_diffuse: float = 1.0,
    lambda_specular: float = 1.0,
    bsdf: str = "lambert",
    device="cuda",
) -> Dict[str, np.ndarray]:
    """PBR-shaded frames under a headlight at the camera, rendered on
    ``device``: {'rgb', 'diffuse', 'specular'}, each uint8
    [N, size, size, 3].  Without a metallic-roughness map the roughness is
    0.5 and the metal 0 (glTF: g = roughness, b = metallic)."""
    dev = resolve_device(device)
    hm = load_mesh(mesh) if isinstance(mesh, str) else mesh
    if hm.uv is None or hm.texture is None:
        raise ValueError("a PBR render needs the mesh's UVs and albedo")
    c2ws, intr = _cameras(cameras, n_frames, perspective, dev)

    kd = torch.from_numpy(np.array(hm.texture[..., :3])).to(dev).float() / 255.0
    kd = kd * torch.tensor(lambda_albedo, dtype=torch.float32, device=dev)
    if hm.metallic_roughness is not None:
        mr = torch.from_numpy(np.array(hm.metallic_roughness)).to(dev).float() / 255.0
        arm = torch.stack([torch.ones_like(mr[..., 0]),
                           mr[..., 1] * lambda_roughness,
                           mr[..., 2] * lambda_metallic], dim=-1)
    else:
        arm = torch.tensor([1.0, 0.5 * lambda_roughness, 0.0],
                           device=dev).expand_as(kd)
    out = render_views(
        _device_mesh(hm, dev), c2ws, intr, (size, size),
        perspective=perspective, map_attr=torch.cat([kd, arm], dim=-1),
        render_uv=True, render_map_attr=True, render_world_normal=True,
        render_world_position=True,
    )
    kd_px = out.map_attr[..., :3]
    arm_px = out.map_attr[..., 3:6]
    # headlight: the light sits at the camera, wo == wi
    wo = c2ws[:, None, None, :3, 3] - out.world_position
    wo = wo / torch.clamp(torch.linalg.norm(wo, dim=-1, keepdim=True), min=1e-20)
    nrm = out.world_normal
    spec_str, roughness, metallic = arm_px[..., 0:1], arm_px[..., 1:2], arm_px[..., 2:3]
    ks = (0.04 * (1.0 - metallic) + kd_px * metallic) * (1.0 - spec_str)
    kd_diff = kd_px * (1.0 - metallic)
    if bsdf == "lambert":
        diff_only = kd_diff * lambert(nrm, wo)
    else:
        diff_only = kd_diff * frostbite_diffuse(nrm, wo, wo, roughness)
    spec_only = pbr_specular(ks, nrm, wo, wo, roughness * roughness)
    rgb = lambda_diffuse * diff_only + lambda_specular * spec_only
    rgb = rgb * out.alpha + background * (1.0 - out.alpha)
    return {"rgb": _frames(rgb), "diffuse": _frames(diff_only),
            "specular": _frames(spec_only)}
