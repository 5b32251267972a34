"""Forward multi-view renderer (port of the parts of
unitex_tpu/render/renderer.py on the texturing path).

Views are rendered one after another (a Python loop over cameras, the
JAX package's ``lax.map``).  Output conventions match the JAX package:
normals/positions lerped to -1 background, alpha in [0, 1], no
antialiasing.  Only the buffers the geometry conditioning reads are
ported (mask, alpha, tri, bary, world normal, world position); the other
render flags, supersampling and row slabs raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..camera.conversion import get_mvp, transform_points_mat4
from ..geometry.mesh import Mesh, compute_vertex_normals
from ..ops.rasterize import interpolate, rasterize
from ..utils.precision import exact_f32


@dataclasses.dataclass(frozen=True)
class RenderOutputs:
    """Per-view buffers [M, H, W, C]; fields are None unless requested."""

    mask: torch.Tensor
    alpha: torch.Tensor
    tri: torch.Tensor
    bary: Optional[torch.Tensor] = None
    world_normal: Optional[torch.Tensor] = None
    world_position: Optional[torch.Tensor] = None


# render_views options of the JAX package that the port does not take,
# with the value that leaves them off; ``pixel_tile`` only bounds memory
# there and is accepted and ignored
_UNPORTED = {
    "v_attr": None, "map_attr": None, "render_camera_normal": False,
    "render_z_depth": False, "render_camera_position": False,
    "render_distance": False, "render_ray_direction": False,
    "render_cos_ray_normal": False, "render_v_attr": False,
    "render_uv": False, "render_map_attr": False, "supersample": 1,
    "row_chunk": None,
}


def _lerp_bg(value, alpha, bg):
    return value * alpha + bg * (1.0 - alpha)


@exact_f32()
def render_views(
    mesh: Mesh,
    c2ws: torch.Tensor,
    intrinsics: torch.Tensor,
    render_size: Tuple[int, int],
    perspective: bool = False,
    render_world_normal: bool = False,
    render_world_position: bool = False,
    face_chunk: int = 512,
    pixel_tile: int = 0,
    tile_batch: int = 64,
    **unported,
) -> RenderOutputs:
    """Render a mesh from M cameras.

    mesh: Mesh; c2ws [M, 4, 4]; intrinsics [3, 3] or [M, 3, 3]
    (normalized); render_size (H, W)."""
    unknown = sorted(set(unported) - set(_UNPORTED))
    if unknown:
        raise TypeError(f"render_views got unexpected options {unknown}")
    on = sorted(k for k, v in unported.items()
                if ((v is not None) if _UNPORTED[k] is None
                    else v != _UNPORTED[k]))
    if on:
        raise NotImplementedError(f"render_views options not ported: {on}")
    H, W = render_size
    M = c2ws.shape[0]
    if intrinsics.dim() == 2:
        intrinsics = intrinsics.expand(M, 3, 3)
    mvp = get_mvp(c2ws, intrinsics, perspective=perspective)
    v = mesh.vertices
    faces = mesh.faces.long()
    v_nrm = compute_vertex_normals(v, faces) if render_world_normal else None

    outs = []
    for i in range(M):
        clip = transform_points_mat4(v, mvp[i])
        rast = rasterize(clip, faces, (H, W), face_chunk=face_chunk,
                         tile_batch=tile_batch)
        mask = rast.mask[..., None]
        alpha = mask.float()
        out = {"mask": mask, "alpha": alpha, "tri": rast.tri, "bary": rast.bary}
        if render_world_normal:
            wn = interpolate(v_nrm, rast, faces)
            wn = wn / torch.clamp(torch.linalg.norm(wn, dim=-1, keepdim=True),
                                  min=1e-12)
            out["world_normal"] = _lerp_bg(wn, alpha, -1.0)
        if render_world_position:
            out["world_position"] = _lerp_bg(interpolate(v, rast, faces),
                                             alpha, -1.0)
        outs.append(out)
    return RenderOutputs(**{
        k: torch.stack([o[k] for o in outs]) for k in outs[0]
    })
