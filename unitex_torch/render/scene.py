"""Multi-object scene rendering (port of unitex_tpu/render/scene.py).

Several meshes with per-object transforms and textures rendered into one
z-buffered image: the objects are flattened into one concatenated mesh
with a per-face object id, one rasterization serves them all, and each
object's texture lookup is masked by the id map.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..camera.conversion import transform_points_mat4
from ..geometry.mesh import Mesh
from ..ops.grid_sample import sample_texture
from .renderer import render_views


@dataclasses.dataclass
class SceneObject:
    mesh: Mesh
    texture: Optional[torch.Tensor] = None    # [H, W, 3]
    transform: Optional[torch.Tensor] = None  # [4, 4] object-to-world
    base_color: Tuple[float, float, float] = (0.7, 0.7, 0.7)


def flatten_scene(objects: Sequence[SceneObject]) -> Tuple[Mesh, torch.Tensor]:
    """One world-space mesh of all objects and the object id of each face
    [F].  The UV tables are concatenated with offset indices, so each
    object keeps its own chart space; an object without UVs gets one
    placeholder UV."""
    vs, fs, uvs, fuvs, fids = [], [], [], [], []
    v_off = t_off = 0
    for oid, obj in enumerate(objects):
        v = obj.mesh.vertices
        if obj.transform is not None:
            v = transform_points_mat4(v, obj.transform)[:, :3]
        faces = obj.mesh.faces.long()
        vs.append(v)
        fs.append(faces + v_off)
        fids.append(torch.full((faces.shape[0],), oid, dtype=torch.int64,
                               device=v.device))
        if obj.mesh.uv is not None:
            uvs.append(obj.mesh.uv)
            fuvs.append(obj.mesh.faces_uv.long() + t_off)
            t_off += obj.mesh.uv.shape[0]
        else:
            uvs.append(v.new_zeros((1, 2)))
            fuvs.append(torch.zeros_like(faces))
            t_off += 1
        v_off += v.shape[0]
    merged = Mesh(torch.cat(vs), torch.cat(fs), uv=torch.cat(uvs),
                  faces_uv=torch.cat(fuvs))
    return merged, torch.cat(fids)


@torch.no_grad()
def render_scene(
    objects: Sequence[SceneObject],
    c2ws: torch.Tensor,
    intrinsics: torch.Tensor,
    render_size: Tuple[int, int],
    perspective: bool = True,
    background: float = 1.0,
    face_chunk: int = 512,
):
    """-> dict with 'rgb' [M, H, W, 3], 'alpha', 'object_id' [M, H, W]
    (-1 on the background) and 'normal'."""
    merged, face_obj = flatten_scene(objects)
    out = render_views(merged, c2ws, intrinsics, render_size,
                       perspective=perspective, render_world_normal=True,
                       render_uv=True, face_chunk=face_chunk)
    tri = out.tri
    obj_id = torch.where(tri >= 0, face_obj[torch.clamp(tri, min=0).long()],
                         torch.full_like(tri, -1, dtype=torch.int64))
    uv = (out.uv + 1.0) * 0.5   # back to [0, 1], v up
    rgb = out.alpha.new_zeros((*out.alpha.shape[:3], 3))
    for oid, obj in enumerate(objects):
        sel = (obj_id == oid)[..., None]
        if obj.texture is not None:
            col = sample_texture(obj.texture, uv)
        else:
            col = torch.tensor(obj.base_color, dtype=rgb.dtype,
                               device=rgb.device).expand_as(rgb)
        rgb = torch.where(sel, col, rgb)
    rgb = rgb * out.alpha + background * (1.0 - out.alpha)
    return {"rgb": rgb, "alpha": out.alpha, "object_id": obj_id,
            "normal": out.world_normal}
