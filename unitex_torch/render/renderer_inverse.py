"""Stage-2 texture baking: multi-view images -> UV atlas texture (port of
the reproject route of unitex_tpu/render/renderer_inverse.py).

* ``mv_render``   — rasterize the mesh per view: positions, face normals,
                    triangle ids, linear view depth.
* ``uv_render``   — rasterize the UV atlas: per-texel 3D position, face
                    normal, triangle id.
* ``_visibility_paste`` — per-view texel visibility by the z-buffer depth
                    test (project the texel, compare its linear depth with
                    the view's sampled depth), ray-normal angle test and
                    ring hole closing; then the fixed-priority paste and
                    its seam boundary.
* ``_finish_reproject_blur`` — k=1 nearest-visible-texel fill in 3D, seam
                    lens blur, pull-push dilation.
* ``bake_texture`` — the orchestrator, ``method="reproject"`` only.

Every f32 product here is exact (no TF32): the depth test resolves 5e-3.
Deferred (``NotImplementedError``): the kdtree and blending bake methods,
the low-memory (``low_hbm``) variant, the learned ``query_field`` fill,
relaxation, cosine paste, the triangle-id visibility modes and the
gradient filter.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..camera.conversion import c2w_to_w2c, get_mvp, transform_points_mat4
from ..geometry.mesh import Mesh, compute_face_normals
from ..ops.grid_sample import grid_sample
from ..ops.image_ops import (
    boundary_mask,
    dilate_mask,
    erode_mask,
    gaussian_blur,
    lens_blur,
    pull_push,
    ring_close_mask,
)
from ..ops.knn import knn
from ..ops.rasterize import interpolate, rasterize, rasterize_uv
from ..utils.precision import exact_f32

# per-view paste priority: frtbld -> fblrtd
VIEW_PRIORITY = (0, 3, 4, 1, 2, 5)


def _face_normal_image(face_normals, tri):
    """Gather per-pixel face normals by triangle id (0 where background)."""
    fn = face_normals[torch.clamp(tri, min=0)]
    return torch.where((tri >= 0)[..., None], fn, torch.zeros_like(fn))


@torch.no_grad()
@exact_f32()
def mv_render(
    mesh: Mesh,
    c2ws: torch.Tensor,
    intrinsics: torch.Tensor,
    render_size: Tuple[int, int],
    perspective: bool = False,
    face_chunk: int = 512,
    tile_batch: int = 64,
) -> Dict[str, torch.Tensor]:
    """Per-view geometry buffers of the processed mesh [M, H, W, ...]:
    triangle ids, coverage mask, world position, face normal, linear view
    depth (+inf off the mesh), and the views' mvp / w2c matrices."""
    H, W = render_size
    M = c2ws.shape[0]
    if intrinsics.dim() == 2:
        intrinsics = intrinsics.expand(M, 3, 3)
    mvp = get_mvp(c2ws, intrinsics, perspective=perspective)
    w2cs = c2w_to_w2c(c2ws)
    v = mesh.vertices
    faces = mesh.faces.long()
    face_normals = compute_face_normals(v, faces)

    views = []
    for i in range(M):
        clip = transform_points_mat4(v, mvp[i])
        rast = rasterize(clip, faces, (H, W), face_chunk=face_chunk,
                         tile_batch=tile_batch)
        mask = rast.mask[..., None]
        pos = interpolate(v, rast, faces)
        fn = _face_normal_image(face_normals, rast.tri)
        # linear view depth: camera-space -z
        v_cam = transform_points_mat4(v, w2cs[i])[:, :3]
        depth = interpolate(v_cam[:, 2:3], rast, faces)
        depth = torch.where(mask, -depth, torch.full_like(depth, float("inf")))
        views.append((rast.tri, mask, pos, fn, depth))
    tri, mask, pos, fn, depth = (torch.stack(x) for x in zip(*views))
    return {
        "tri": tri,
        "mask": mask,
        "position": pos,
        "face_normal": fn,
        "depth": depth,
        "mvp": mvp,
        "w2cs": w2cs,
    }


@torch.no_grad()
@exact_f32()
def uv_render(
    mesh: Mesh,
    uv_size: int,
    face_chunk: int = 512,
    pixel_tile: int = 0,
    tile_batch: int = 64,
) -> Dict[str, torch.Tensor]:
    """UV-space geometry buffers: per-texel mask, 3D position, face normal,
    triangle id.  ``pixel_tile`` only bounds memory in the JAX package and
    is accepted and ignored, as in ``render_views``."""
    rast = rasterize_uv(mesh.uv, mesh.faces_uv.long(), uv_size,
                        face_chunk=face_chunk, tile_batch=tile_batch)
    faces = mesh.faces.long()
    face_normals = compute_face_normals(mesh.vertices, faces)
    pos = interpolate(mesh.vertices, rast, faces)
    fn = _face_normal_image(face_normals, rast.tri)
    return {"tri": rast.tri, "mask": rast.mask[..., None], "position": pos,
            "face_normal": fn}


def _one_view_visibility(
    pos, mask_2d, fn_2d, mvp_i, c2w_i, w2c_i, depth_i, mask_i, img_i,
    *, perspective, ray_normal_angle_threshold, depth_eps, ring_kernels,
):
    """One view's texel visibility (depth test) and sampled color."""
    clip = transform_points_mat4(pos, mvp_i)             # [H2, W2, 4]
    cw = clip[..., 3:4]
    w = torch.where(torch.abs(cw) > 1e-12, cw, torch.full_like(cw, 1e-12))
    ndc = clip[..., :2] / w
    tex_depth = -transform_points_mat4(pos, w2c_i)[..., 2:3]
    # sampled view depth + view mask (+ view color when it shares the
    # geometry buffers' resolution) as ONE bilinear gather
    fuse_color = img_i.shape[:2] == depth_i.shape[:2]
    planes = [torch.where(mask_i, depth_i, torch.zeros_like(depth_i)),
              mask_i.float()]
    if fuse_color:
        planes.append(img_i)
    samp = grid_sample(torch.cat(planes, dim=-1), ndc)
    view_depth, view_alpha = samp[..., :1], samp[..., 1:2]
    vis = (view_alpha > 0.999) & (torch.abs(view_depth - tex_depth) < depth_eps)
    if perspective:
        rays_d = pos - c2w_i[:3, 3]
    else:
        rays_d = (-c2w_i[:3, 2]).expand_as(pos)
    rays_d = rays_d / torch.clamp(
        torch.linalg.norm(rays_d, dim=-1, keepdim=True), min=1e-12)
    cos_rn = torch.sum(rays_d * fn_2d, dim=-1, keepdim=True)
    vis = vis & (cos_rn < math.cos(math.radians(ray_normal_angle_threshold)))
    color = samp[..., 2:] if fuse_color else grid_sample(img_i, ndc)
    if ring_kernels:
        vis = ring_close_mask(vis, ring_kernels)
    return vis & mask_2d, color


@torch.no_grad()
@exact_f32()
def _visibility_paste(
    uv_pos, uv_mask, uv_fn,
    mvp, w2cs, c2ws, depth, maskv, view_images,
    *, perspective, ray_normal_angle_threshold, depth_eps, ring_kernels,
    priority, kernel_size_boundary, kernel_size_boundary_blur,
):
    """Per-view visibility + fixed-priority paste.  Returns (color_cur,
    mask_cur, boundary, visible_any, visible_per_view [M, ...])."""
    M = view_images.shape[0]
    visible, colors = [], []
    for i in range(M):
        vis, color = _one_view_visibility(
            uv_pos, uv_mask, uv_fn, mvp[i], c2ws[i], w2cs[i], depth[i],
            maskv[i], view_images[i],
            perspective=perspective,
            ray_normal_angle_threshold=ray_normal_angle_threshold,
            depth_eps=depth_eps, ring_kernels=ring_kernels,
        )
        visible.append(vis)
        colors.append(color)
    H2, W2 = uv_mask.shape[:2]
    C = view_images.shape[-1]
    color_cur = torch.zeros((H2, W2, C), dtype=view_images.dtype,
                            device=view_images.device)
    mask_cur = torch.zeros((H2, W2, 1), dtype=torch.bool, device=uv_mask.device)
    boundary = torch.zeros_like(mask_cur)
    for i in priority:
        extra = (~mask_cur) & visible[i]
        color_cur = torch.where(extra, colors[i], color_cur)
        mask_cur = mask_cur | extra
        b_in, b_out = boundary_mask(extra, kernel_size_boundary)
        boundary = boundary | b_in | b_out
    boundary = dilate_mask(boundary, kernel_size_boundary_blur)
    boundary = boundary & erode_mask(
        uv_mask, 2 * (kernel_size_boundary_blur // 2) + 5)
    visible = torch.stack(visible)
    return color_cur, mask_cur, boundary, visible.any(dim=0), visible


def _select_masked_points(points, values, mask, max_n: int):
    """Static-size selection of up to ``max_n`` masked points: valid points
    first in a fixed pseudo-random order (golden-ratio hash of the index,
    uint32 arithmetic done in int64 and masked), invalid last; stable."""
    N = points.shape[0]
    idx = torch.arange(N, dtype=torch.int64, device=points.device)
    h = ((idx * 2654435761) & 0xFFFFFFFF) ^ (idx >> 16)
    key = torch.where(mask, h >> 1, torch.full_like(h, 0xFFFFFFFF))
    take = torch.argsort(key, stable=True)[:max_n]
    return points[take], values[take], mask[take]


@torch.no_grad()
def _fill_invisible_knn(
    pos_flat, color_flat, visible_flat, target_mask_flat,
    k: int = 1, max_ref: int = 65536, chunk: int = 4096,
    max_fill: int = 1 << 20,
):
    """Fill target texels with the nearest visible texel's color in 3D
    (k=1).  Up to ``max_fill`` targets are gathered first (targets first
    in index order, stable) so the KNN runs only on them."""
    if k != 1:
        raise NotImplementedError("the k > 1 inverse-distance fill is not ported")
    n_fill = int(torch.count_nonzero(target_mask_flat))  # host sync
    if n_fill == 0:
        return color_flat
    ref_pts, ref_vals, ref_valid = _select_masked_points(
        pos_flat, color_flat, visible_flat, max_ref)
    if n_fill <= max_fill:
        qidx = torch.argsort((~target_mask_flat).to(torch.uint8),
                             stable=True)[:max_fill]
        _, idx = knn(pos_flat[qidx], ref_pts, k=1, chunk=chunk,
                     ref_valid=ref_valid)
        nn_color = ref_vals[idx[:, 0]]
        upd = torch.where(target_mask_flat[qidx][:, None], nn_color,
                          color_flat[qidx])
        out = color_flat.clone()
        out[qidx] = upd
        return out
    _, idx = knn(pos_flat, ref_pts, k=1, chunk=chunk, ref_valid=ref_valid)
    return torch.where(target_mask_flat[:, None], ref_vals[idx[:, 0]], color_flat)


@torch.no_grad()
def _finish_reproject_blur(
    uv_out, color_cur, mask_cur, boundary, visible_any,
    *, method, kernel_size_blur, knn_max_ref, knn_chunk,
):
    """KNN fill + seam blur + pull-push — the bake tail after the paste."""
    mask_2d = uv_out["mask"]
    H2, W2, C = color_cur.shape
    color_flat = _fill_invisible_knn(
        uv_out["position"].reshape(-1, 3), color_cur.reshape(-1, C),
        mask_cur.reshape(-1), (mask_2d & ~mask_cur).reshape(-1),
        k=1, max_ref=knn_max_ref, chunk=knn_chunk,
    )
    color_cur = color_flat.reshape(H2, W2, C)
    if method == "gaussian":
        blurred = gaussian_blur(color_cur, kernel_size_blur)
    else:
        # the reference's seam softener: the complex-kernel bokeh with its
        # stock radius/components (kernel_size_blur is not read)
        blurred = lens_blur(color_cur)
    color_cur = torch.where(boundary, blurred, color_cur)
    return {
        "texture": pull_push(color_cur, mask_2d),
        "color_before_fill": color_cur,
        "mask_2d": mask_2d,
        "mask_visible_any": visible_any,
        "boundary": boundary,
    }


_DEFERRED_KWARGS = {
    "query_field": None, "query_field_auto": None, "fill_relax_iters": 0,
    "fill_k": 1, "paste_mode": "priority", "geometry_size": None,
    "low_hbm_row_chunk": None,
}


@torch.no_grad()
def bake_texture(
    mesh: Mesh,
    view_images: torch.Tensor,
    c2ws: torch.Tensor,
    intrinsics: torch.Tensor,
    uv_size: int = 2048,
    perspective: bool = False,
    method: str = "reproject",
    grad_norm_threshold: float = 0.15,
    ray_normal_angle_threshold: float = 100.0,
    filt_gradient_points: bool = False,
    depth_eps: float = 5e-3,
    visibility_mode: str = "depth",
    knn_max_ref: int = 65536,
    knn_chunk: int = 4096,
    face_chunk: int = 512,
    low_hbm: bool = False,
    **bake_kwargs,
) -> Dict[str, torch.Tensor]:
    """Full stage-2 bake, reproject route: view_images [M, H, W, C] ->
    texture [uv_size, uv_size, C] and diagnostic masks, on the device of
    the mesh.  ``grad_norm_threshold`` is read only by the (deferred)
    gradient filter."""
    if method != "reproject":
        raise NotImplementedError(f"bake method {method!r} is not ported")
    if low_hbm or visibility_mode != "depth" or filt_gradient_points:
        raise NotImplementedError(
            "low_hbm, the triangle-id visibility modes and the gradient "
            "filter are not ported")
    for key, default in _DEFERRED_KWARGS.items():
        if bake_kwargs.get(key, default) != default:
            raise NotImplementedError(f"bake option {key!r} is not ported")
    M, H, W, C = view_images.shape
    uv_out = uv_render(mesh, uv_size, face_chunk=face_chunk)
    mv_out = mv_render(mesh, c2ws, intrinsics, (H, W),
                       perspective=perspective, face_chunk=face_chunk)
    # without the gradient filter a view's visible mask is its coverage
    color_cur, mask_cur, boundary, visible_any, vis_pv = _visibility_paste(
        uv_out["position"], uv_out["mask"], uv_out["face_normal"],
        mv_out["mvp"], mv_out["w2cs"], c2ws, mv_out["depth"], mv_out["mask"],
        view_images,
        perspective=perspective,
        ray_normal_angle_threshold=ray_normal_angle_threshold,
        depth_eps=depth_eps,
        ring_kernels=(3, 5),
        priority=bake_kwargs.get("priority", VIEW_PRIORITY),
        kernel_size_boundary=bake_kwargs.get("kernel_size_boundary", 3),
        kernel_size_boundary_blur=bake_kwargs.get("kernel_size_boundary_blur", 3),
    )
    out = _finish_reproject_blur(
        uv_out, color_cur, mask_cur, boundary, visible_any,
        method=bake_kwargs.get("method", "lens"),
        kernel_size_blur=bake_kwargs.get("kernel_size_blur", 5),
        knn_max_ref=knn_max_ref, knn_chunk=knn_chunk,
    )
    out["visible_per_view"] = vis_pv
    out["mask_visible_any"] = visible_any
    return out
