"""Forward multi-view renderer (port of the ``render_views`` of
unitex_tpu/render/renderer.py).

Views are rendered one after another (a Python loop over cameras, the
JAX package's ``lax.map``).  Output conventions match the JAX package:
normals/positions/directions lerped to -1 background, depths and distances
zero there, alpha in [0, 1], no antialiasing unless ``supersample`` > 1
(N×N samples a pixel, float buffers box-filtered back down, integer and
bool buffers taking the top-left sample).  ``row_chunk`` computes the
per-pixel tail in row slabs (a memory bound; the same buffers).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..camera.conversion import c2w_to_w2c, get_mvp, transform_points_mat4
from ..geometry.mesh import Mesh, compute_vertex_normals
from ..ops.grid_sample import grid_sample
from ..ops.rasterize import Rast, interpolate, rasterize
from ..utils.precision import exact_f32


@dataclasses.dataclass(frozen=True)
class RenderOutputs:
    """Per-view buffers [M, H, W, C]; fields are None unless requested."""

    mask: torch.Tensor
    alpha: torch.Tensor
    tri: torch.Tensor
    world_normal: Optional[torch.Tensor] = None
    camera_normal: Optional[torch.Tensor] = None
    world_position: Optional[torch.Tensor] = None
    z_depth: Optional[torch.Tensor] = None
    camera_position: Optional[torch.Tensor] = None
    distance: Optional[torch.Tensor] = None
    ray_direction: Optional[torch.Tensor] = None
    cos_ray_normal: Optional[torch.Tensor] = None
    v_attr: Optional[torch.Tensor] = None
    uv: Optional[torch.Tensor] = None
    map_attr: Optional[torch.Tensor] = None
    bary: Optional[torch.Tensor] = None


def _lerp_bg(value, alpha, bg):
    return value * alpha + bg * (1.0 - alpha)


def _unit(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)


def _downsample(x: Optional[torch.Tensor], s: int) -> Optional[torch.Tensor]:
    """[M, H·s, W·s, ...] -> [M, H, W, ...]: the s×s box mean of a float
    buffer, the top-left sample of any other."""
    if x is None:
        return None
    if not x.is_floating_point():
        return x[:, ::s, ::s]
    M, Hs, Ws = x.shape[:3]
    return x.reshape(M, Hs // s, s, Ws // s, s, *x.shape[3:]).mean(dim=(2, 4))


@exact_f32()
def render_views(
    mesh: Mesh,
    c2ws: torch.Tensor,
    intrinsics: torch.Tensor,
    render_size: Tuple[int, int],
    perspective: bool = False,
    v_attr: Optional[torch.Tensor] = None,
    map_attr: Optional[torch.Tensor] = None,
    render_world_normal: bool = False,
    render_camera_normal: bool = False,
    render_world_position: bool = False,
    render_z_depth: bool = False,
    render_camera_position: bool = False,
    render_distance: bool = False,
    render_ray_direction: bool = False,
    render_cos_ray_normal: bool = False,
    render_v_attr: bool = False,
    render_uv: bool = False,
    render_map_attr: bool = False,
    face_chunk: int = 512,
    pixel_tile: int = 0,
    supersample: int = 1,
    row_chunk: Optional[int] = None,
    tile_batch: int = 64,
) -> RenderOutputs:
    """Render a mesh from M cameras.

    mesh: Mesh; c2ws [M, 4, 4]; intrinsics [3, 3] or [M, 3, 3]
    (normalized); render_size (H, W).  ``v_attr`` [V, C] is a per-vertex
    attribute, interpolated when ``render_v_attr`` is set.  ``map_attr``
    [Ht, Wt, C] is a texture stored image-style (row 0 = v = 1), sampled
    at each pixel's interpolated UV with border padding when
    ``render_map_attr`` is set.  ``pixel_tile`` only bounds memory in the
    JAX package and is accepted and ignored."""
    del pixel_tile
    flags = dict(
        perspective=perspective, v_attr=v_attr, map_attr=map_attr,
        render_world_normal=render_world_normal,
        render_camera_normal=render_camera_normal,
        render_world_position=render_world_position,
        render_z_depth=render_z_depth,
        render_camera_position=render_camera_position,
        render_distance=render_distance,
        render_ray_direction=render_ray_direction,
        render_cos_ray_normal=render_cos_ray_normal,
        render_v_attr=render_v_attr, render_uv=render_uv,
        render_map_attr=render_map_attr, face_chunk=face_chunk,
        row_chunk=row_chunk, tile_batch=tile_batch)
    if supersample > 1:
        s = supersample
        hi = render_views(mesh, c2ws, intrinsics,
                          (render_size[0] * s, render_size[1] * s), **flags)
        return RenderOutputs(**{f.name: _downsample(getattr(hi, f.name), s)
                                for f in dataclasses.fields(hi)})
    H, W = render_size
    M = c2ws.shape[0]
    if intrinsics.dim() == 2:
        intrinsics = intrinsics.expand(M, 3, 3)
    mvp = get_mvp(c2ws, intrinsics, perspective=perspective)
    w2cs = c2w_to_w2c(c2ws)
    v = mesh.vertices
    faces = mesh.faces.long()
    v_nrm = None
    if render_world_normal or render_camera_normal or render_cos_ray_normal:
        v_nrm = compute_vertex_normals(v, faces)
    need_cam = (render_camera_position or render_distance
                or render_ray_direction or render_cos_ray_normal)

    def pixel_tail(rast, clip, c2w_i, w2c_i):
        mask = rast.mask[..., None]
        alpha = mask.float()
        out = {"mask": mask, "alpha": alpha, "tri": rast.tri, "bary": rast.bary}

        def interp(attr):
            return interpolate(attr, rast, faces)

        if render_world_normal:
            out["world_normal"] = _lerp_bg(_unit(interp(v_nrm)), alpha, -1.0)
        if render_camera_normal or render_cos_ray_normal:
            cn = _unit(interp(_unit(v_nrm @ c2w_i[:3, :3])))
            if render_camera_normal:
                out["camera_normal"] = _lerp_bg(cn, alpha, -1.0)
        if render_world_position:
            out["world_position"] = _lerp_bg(interp(v), alpha, -1.0)
        if render_z_depth:
            out["z_depth"] = interp(clip[:, 3:4] if perspective
                                    else clip[:, 2:3]) * alpha
        if need_cam:
            cp = interp(transform_points_mat4(v, w2c_i)[:, :3])
            if render_camera_position:
                out["camera_position"] = cp * alpha
            if render_distance:
                out["distance"] = torch.linalg.norm(cp, dim=-1, keepdim=True) * alpha
            rd = _unit(cp)
            if render_ray_direction:
                out["ray_direction"] = _lerp_bg(rd, alpha, -1.0)
            if render_cos_ray_normal:
                out["cos_ray_normal"] = _lerp_bg(
                    torch.sum(cn * rd, dim=-1, keepdim=True), alpha, -1.0)
        if render_v_attr and v_attr is not None:
            out["v_attr"] = interp(v_attr) * alpha
        if (render_uv or render_map_attr) and mesh.uv is not None:
            uv_ndc = mesh.uv * 2.0 - 1.0
            corners = uv_ndc[mesh.faces_uv.long()[torch.clamp(rast.tri, min=0)]]
            gb_uv = torch.einsum("...kc,...k->...c", corners, rast.bary3)
            gb_uv = torch.where(mask, gb_uv, torch.full_like(gb_uv, -1.0))
            if render_uv:
                out["uv"] = gb_uv
            if render_map_attr and map_attr is not None:
                # uv is v-up; image row 0 = v=1: flip y for grid_sample
                g = torch.stack([gb_uv[..., 0], -gb_uv[..., 1]], dim=-1)
                out["map_attr"] = grid_sample(map_attr, g,
                                              padding_mode="border") * alpha
        return out

    slabs = (row_chunk is not None and H > row_chunk and H % row_chunk == 0)
    outs = []
    for i in range(M):
        clip = transform_points_mat4(v, mvp[i])
        rast = rasterize(clip, faces, (H, W), face_chunk=face_chunk,
                         tile_batch=tile_batch)
        if not slabs:
            outs.append(pixel_tail(rast, clip, c2ws[i], w2cs[i]))
            continue
        parts = [pixel_tail(Rast(*(x[r:r + row_chunk] for x in
                                   (rast.bary, rast.z, rast.tri))),
                            clip, c2ws[i], w2cs[i])
                 for r in range(0, H, row_chunk)]
        outs.append({k: torch.cat([p[k] for p in parts]) for k in parts[0]})
    return RenderOutputs(**{
        k: torch.stack([o[k] for o in outs]) for k in outs[0]
    })
