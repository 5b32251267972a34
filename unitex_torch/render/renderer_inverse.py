"""Stage-2 texture baking: multi-view images -> UV atlas texture (port of
unitex_tpu/render/renderer_inverse.py).

* ``mv_render``    — rasterize the mesh per view: positions, face normals,
                     triangle ids, linear view depth, cos(ray, normal) and
                     the screen-gradient filter.
* ``uv_render``    — rasterize the UV atlas: per-texel 3D position, face
                     normal, triangle id.
* ``view_visibility`` — per-view texel visibility by the z-buffer depth
                     test (project the texel, compare its linear depth with
                     the view's sampled depth), by nearest-pixel triangle-id
                     equality, or by either; ray-normal angle test and ring
                     hole closing.
* ``_visibility_paste`` — visibility fused with the paste (fixed view
                     priority, or per texel the most head-on view) and its
                     seam boundary; ``_visibility_paste_scan`` is its
                     low-memory form (views in priority order, texels in
                     row slabs).
* ``_finish_reproject_blur`` — fill of the texels no view sees (k nearest
                     visible texels in 3D, inverse-distance weighted, then
                     optional relaxation; or a learned ``query_field``),
                     seam blur, pull-push dilation.
* ``bake_reproject_blending`` — priority paste, fill, per-view Poisson
                     blending (``ops/poisson.py``).
* ``bake_kdtree``  — 'order_mean' / 'mean' / 'mvpaint' KNN baking from the
                     views' pixel clouds.
* ``bake_texture`` — the orchestrator.

Every f32 product here is exact (no TF32): the depth test resolves 5e-3.
The fill counts its texels on the host (one scalar each), as the JAX
package does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

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
from ..ops.rasterize import Rast, interpolate, rasterize, rasterize_uv
from ..utils.precision import exact_f32

# per-view paste priority: frtbld -> fblrtd
VIEW_PRIORITY = (0, 3, 4, 1, 2, 5)

_NEIGHBOURS = ((0, 1), (0, -1), (1, 1), (1, -1))   # (dim, shift), wrapping


def _face_normal_image(face_normals, tri):
    """Gather per-pixel face normals by triangle id (0 where background)."""
    fn = face_normals[torch.clamp(tri, min=0)]
    return torch.where((tri >= 0)[..., None], fn, torch.zeros_like(fn))


def _unit(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)


@torch.no_grad()
@exact_f32()
def mv_render(
    mesh: Mesh,
    c2ws: torch.Tensor,
    intrinsics: torch.Tensor,
    render_size: Tuple[int, int],
    perspective: bool = False,
    grad_norm_threshold: float = 0.15,
    ray_normal_angle_threshold: float = 100.0,
    filt_gradient_points: bool = False,
    face_chunk: int = 512,
    tile_batch: int = 64,
) -> Dict[str, torch.Tensor]:
    """Per-view geometry buffers of the processed mesh [M, H, W, ...]:
    triangle ids, coverage mask, world position, face normal, linear view
    depth (+inf off the mesh), cos(ray, face normal), the views' mvp / w2c
    matrices, and ``mask_visible``: the coverage, or with
    ``filt_gradient_points`` the pixels that also face the camera within
    ``ray_normal_angle_threshold`` and lie in a smooth region (the gradient
    norm of [position, normal] under ``grad_norm_threshold``, eroded by a
    31² window).  Views are rasterized one at a time (the JAX package's
    low-memory ``view_scan``; its default vmaps them)."""
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
        if perspective:
            rays_d = pos - c2ws[i, :3, 3]
        else:
            rays_d = (-c2ws[i, :3, 2]).expand_as(pos)
        cos_rn = torch.sum(_unit(rays_d) * fn, dim=-1, keepdim=True)
        views.append((rast.tri, mask, pos, fn, depth, cos_rn))
    tri, mask, pos, fn, depth, cos_rn = (torch.stack(x) for x in zip(*views))

    if filt_gradient_points:
        cos_thresh = math.cos(math.radians(ray_normal_angle_threshold))
        attrs = torch.cat([pos, fn], dim=-1)                 # [M, H, W, 6]
        # central differences inside, one-sided at the edges (jnp.gradient)
        dy = torch.gradient(attrs, dim=1)[0]
        dx = torch.gradient(attrs, dim=2)[0]
        grad_norm = torch.sqrt(torch.sum(dx * dx + dy * dy, dim=-1, keepdim=True))
        smooth = erode_mask(grad_norm < grad_norm_threshold, 31)
        mask_vis = mask & (cos_rn < cos_thresh) & smooth
    else:
        mask_vis = mask
    return {
        "tri": tri,
        "mask": mask,
        "mask_visible": mask_vis,
        "position": pos,
        "face_normal": fn,
        "depth": depth,
        "cos_ray_normal": cos_rn,
        "mvp": mvp,
        "w2cs": w2cs,
    }


def _row_slabs(n: int, row_chunk: Optional[int]):
    """Row ranges of the slabs of ``row_chunk`` rows where it divides ``n``
    (and is smaller), else the whole."""
    if row_chunk is None or n <= row_chunk or n % row_chunk:
        return [slice(0, n)]
    return [slice(r, r + row_chunk) for r in range(0, n, row_chunk)]


@torch.no_grad()
@exact_f32()
def uv_render(
    mesh: Mesh,
    uv_size: int,
    face_chunk: int = 512,
    pixel_tile: int = 0,
    tile_batch: int = 64,
    row_chunk: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """UV-space geometry buffers: per-texel mask, 3D position, face normal,
    triangle id.  ``row_chunk`` computes the per-texel tail in row slabs
    (a memory bound; the same result).  ``pixel_tile`` only bounds memory
    in the JAX package and is accepted and ignored, as in
    ``render_views``."""
    rast = rasterize_uv(mesh.uv, mesh.faces_uv.long(), uv_size,
                        face_chunk=face_chunk, tile_batch=tile_batch)
    faces = mesh.faces.long()
    face_normals = compute_face_normals(mesh.vertices, faces)
    parts = []
    for rows in _row_slabs(uv_size, row_chunk):
        r = Rast(rast.bary[rows], rast.z[rows], rast.tri[rows])
        parts.append((interpolate(mesh.vertices, r, faces),
                      _face_normal_image(face_normals, r.tri)))
    pos, fn = (torch.cat(x) for x in zip(*parts))
    return {"tri": rast.tri, "mask": rast.mask[..., None], "position": pos,
            "face_normal": fn}


def _one_view_visibility(
    pos, mask_2d, tri_2d, fn_2d,
    mvp_i, w2c_i, c2w_i, depth_i, tri_i, mask_i, img_i,
    *, perspective, ray_normal_angle_threshold, depth_eps,
    visibility_mode, ring_kernels, row_chunk=None,
):
    """One view's texel visibility, sampled color (None without
    ``img_i``), texel NDC and cos(ray, texel normal).  ``row_chunk`` runs
    the pointwise texel math in row slabs; the ring closing runs on the
    assembled mask."""
    Hv, Wv = tri_i.shape[:2]
    # the view colour shares the depth/alpha taps when it has the geometry
    # buffers' resolution (one gather); ``geometry_size`` samples it apart
    fuse_color = img_i is not None and img_i.shape[:2] == depth_i.shape[:2]
    planes = [torch.where(mask_i, depth_i, torch.zeros_like(depth_i)),
              mask_i.float()]
    if fuse_color:
        planes.append(img_i)
    planes = torch.cat(planes, dim=-1)
    cos_thresh = math.cos(math.radians(ray_normal_angle_threshold))

    def pointwise(pos_s, tri2d_s, fn_s):
        clip = transform_points_mat4(pos_s, mvp_i)
        cw = clip[..., 3:4]
        w = torch.where(torch.abs(cw) > 1e-12, cw, torch.full_like(cw, 1e-12))
        ndc = clip[..., :2] / w
        tex_depth = -transform_points_mat4(pos_s, w2c_i)[..., 2:3]
        samp = grid_sample(planes, ndc)
        view_depth, view_alpha = samp[..., :1], samp[..., 1:2]
        depth_ok = (view_alpha > 0.999) & (torch.abs(view_depth - tex_depth) < depth_eps)
        if visibility_mode == "depth":
            vis = depth_ok
        else:
            # nearest-pixel triangle-id equality, gated by an in-frame
            # test (the pixel lookup clamps to the border)
            in_frame = ((torch.abs(ndc[..., 0]) <= 1.0)
                        & (torch.abs(ndc[..., 1]) <= 1.0))[..., None]
            px = torch.clamp(((ndc[..., 0] + 1) * 0.5 * Wv).to(torch.int32), 0, Wv - 1)
            py = torch.clamp(((ndc[..., 1] + 1) * 0.5 * Hv).to(torch.int32), 0, Hv - 1)
            tid_ok = ((tri_i[py.long(), px.long()] == tri2d_s)[..., None]
                      & (tri2d_s >= 0)[..., None] & in_frame)
            vis = tid_ok if visibility_mode == "tid" else depth_ok | tid_ok
        if perspective:
            rays_d = pos_s - c2w_i[:3, 3]
        else:
            rays_d = (-c2w_i[:3, 2]).expand_as(pos_s)
        cos_rn = torch.sum(_unit(rays_d) * fn_s, dim=-1, keepdim=True)
        vis = vis & (cos_rn < cos_thresh)
        if img_i is None:
            color = None
        elif fuse_color:
            color = samp[..., 2:]
        else:
            color = grid_sample(img_i, ndc)
        return vis, color, ndc, cos_rn

    parts = [pointwise(pos[r], tri_2d[r], fn_2d[r])
             for r in _row_slabs(pos.shape[0], row_chunk)]
    vis, color, ndc, cos_rn = (
        None if x[0] is None else torch.cat(x) for x in zip(*parts))
    if ring_kernels:
        vis = ring_close_mask(vis, ring_kernels)
    return vis & mask_2d, color, ndc, cos_rn


@torch.no_grad()
@exact_f32()
def view_visibility(
    uv_out: Dict[str, torch.Tensor],
    mv_out: Dict[str, torch.Tensor],
    c2ws: torch.Tensor,
    view_images: Optional[torch.Tensor],
    perspective: bool = False,
    ray_normal_angle_threshold: float = 100.0,
    depth_eps: float = 5e-3,
    visibility_mode: str = "depth",
    ring_kernels: Tuple[int, ...] = (3, 5),
) -> Dict[str, torch.Tensor]:
    """Per-view texel visibility + sampled view colours: 'visible'
    [M, H2, W2, 1] bool, 'colors' [M, H2, W2, C] (garbage where invisible;
    None without ``view_images``), 'ndc' [M, H2, W2, 2], 'cos'
    [M, H2, W2, 1]."""
    if visibility_mode not in ("depth", "tid", "both"):
        raise ValueError(f"visibility_mode {visibility_mode!r}")
    maskv = mv_out["mask"] & mv_out["mask_visible"]
    outs = []
    for i in range(c2ws.shape[0]):
        outs.append(_one_view_visibility(
            uv_out["position"], uv_out["mask"], uv_out["tri"],
            uv_out["face_normal"], mv_out["mvp"][i], mv_out["w2cs"][i],
            c2ws[i], mv_out["depth"][i], mv_out["tri"][i], maskv[i],
            None if view_images is None else view_images[i],
            perspective=perspective,
            ray_normal_angle_threshold=ray_normal_angle_threshold,
            depth_eps=depth_eps, visibility_mode=visibility_mode,
            ring_kernels=ring_kernels,
        ))
    vis, colors, ndc, cos = (
        None if x[0] is None else torch.stack(x) for x in zip(*outs))
    return {"visible": vis, "colors": colors, "ndc": ndc, "cos": cos}


def _paste_views(visible, colors, cos, priority, paste_mode, kernel_size_boundary):
    """Combine per-view (visible, colour) maps into one texture + seam
    boundary.  ``"priority"``: the first visible view in a fixed order.
    ``"cosine"``: per texel the most head-on visible view (max -cos; ties
    to the lower view), the seam where the winning view changes between
    4-neighbours (wrapping at the atlas edge)."""
    H2, W2 = visible.shape[1:3]
    C = colors.shape[-1]
    if paste_mode == "priority":
        color_cur = torch.zeros((H2, W2, C), dtype=colors.dtype, device=colors.device)
        mask_cur = torch.zeros((H2, W2, 1), dtype=torch.bool, device=colors.device)
        boundary = torch.zeros_like(mask_cur)
        for i in priority:
            extra = (~mask_cur) & visible[i]
            color_cur = torch.where(extra, colors[i], color_cur)
            mask_cur = mask_cur | extra
            b_in, b_out = boundary_mask(extra, kernel_size_boundary)
            boundary = boundary | b_in | b_out
        return color_cur, mask_cur, boundary
    if paste_mode != "cosine":
        raise ValueError(f"paste_mode {paste_mode!r}")
    score = torch.where(visible, -cos, torch.full_like(cos, -float("inf")))
    win = torch.argmax(score, dim=0)                           # [H2, W2, 1]
    mask_cur = visible.any(dim=0)
    color_cur = torch.gather(colors, 0, win[None].expand(1, H2, W2, C))[0]
    color_cur = torch.where(mask_cur, color_cur, torch.zeros_like(color_cur))
    wid = torch.where(mask_cur, win + 1, torch.zeros_like(win))  # 0 = no view
    change = torch.zeros_like(mask_cur)
    for dim, sh in _NEIGHBOURS:
        change = change | (wid != torch.roll(wid, sh, dims=dim))
    return color_cur, mask_cur, dilate_mask(change & mask_cur, kernel_size_boundary)


def _seam_band(boundary, uv_mask, kernel_size_boundary_blur):
    """The blurred seam: the boundary dilated, kept well inside the chart."""
    boundary = dilate_mask(boundary, kernel_size_boundary_blur)
    return boundary & erode_mask(uv_mask, 2 * (kernel_size_boundary_blur // 2) + 5)


@torch.no_grad()
@exact_f32()
def _visibility_paste(
    uv_pos, uv_mask, uv_tri, uv_fn,
    mvp, w2cs, c2ws, depth, tri, maskv, view_images,
    *, perspective, ray_normal_angle_threshold, depth_eps, visibility_mode,
    ring_kernels, priority, kernel_size_boundary, kernel_size_boundary_blur,
    paste_mode="priority",
):
    """Per-view visibility + paste.  Returns (color_cur, mask_cur,
    boundary, visible_any, visible_per_view [M, ...] in view order)."""
    visible, colors, cos = [], [], []
    for i in range(view_images.shape[0]):
        vis, color, _, c = _one_view_visibility(
            uv_pos, uv_mask, uv_tri, uv_fn,
            mvp[i], w2cs[i], c2ws[i], depth[i], tri[i], maskv[i], view_images[i],
            perspective=perspective,
            ray_normal_angle_threshold=ray_normal_angle_threshold,
            depth_eps=depth_eps, visibility_mode=visibility_mode,
            ring_kernels=ring_kernels,
        )
        visible.append(vis)
        colors.append(color)
        cos.append(c)
    visible = torch.stack(visible)
    color_cur, mask_cur, boundary = _paste_views(
        visible, torch.stack(colors), torch.stack(cos), priority, paste_mode,
        kernel_size_boundary)
    boundary = _seam_band(boundary, uv_mask, kernel_size_boundary_blur)
    return color_cur, mask_cur, boundary, visible.any(dim=0), visible


@torch.no_grad()
@exact_f32()
def _visibility_paste_scan(
    uv_pos, uv_mask, uv_tri, uv_fn,
    mvp, w2cs, c2ws, depth, tri, maskv, view_images,
    *, perspective, ray_normal_angle_threshold, depth_eps, visibility_mode,
    ring_kernels, priority, kernel_size_boundary, kernel_size_boundary_blur,
    row_chunk=256,
):
    """Low-memory form of :func:`_visibility_paste` (priority paste only):
    one view at a time in priority order, pasted as it comes, with the
    pointwise texel math in ``row_chunk`` slabs; the same result."""
    H2, W2 = uv_mask.shape[:2]
    C = view_images.shape[-1]
    color_cur = torch.zeros((H2, W2, C), dtype=view_images.dtype,
                            device=view_images.device)
    mask_cur = torch.zeros((H2, W2, 1), dtype=torch.bool, device=uv_mask.device)
    boundary = torch.zeros_like(mask_cur)
    visible = [None] * view_images.shape[0]
    for i in priority:
        vis, color, _, _ = _one_view_visibility(
            uv_pos, uv_mask, uv_tri, uv_fn,
            mvp[i], w2cs[i], c2ws[i], depth[i], tri[i], maskv[i], view_images[i],
            perspective=perspective,
            ray_normal_angle_threshold=ray_normal_angle_threshold,
            depth_eps=depth_eps, visibility_mode=visibility_mode,
            ring_kernels=ring_kernels, row_chunk=row_chunk,
        )
        extra = (~mask_cur) & vis
        color_cur = torch.where(extra, color, color_cur)
        mask_cur = mask_cur | extra
        b_in, b_out = boundary_mask(extra, kernel_size_boundary)
        boundary = boundary | b_in | b_out
        visible[i] = vis
    visible = torch.stack(visible)
    boundary = _seam_band(boundary, uv_mask, kernel_size_boundary_blur)
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
    query_field=None, max_fill: int = 1 << 20,
):
    """Fill target texels with the (inverse-distance weighted, k > 1)
    colour of the k nearest visible texels in 3D; ties go to the lower
    reference.  Up to ``max_fill`` targets are gathered first (targets
    first in index order, stable) so the KNN runs only on them.

    ``query_field(points, colors, queries, visible_mask=, query_mask=)``
    replaces the KNN fill when given (the learned inpainting hook): it
    gets the dense texel arrays and their masks and returns dense colours,
    of which the targets are kept."""
    if query_field is not None:
        field_colors = query_field(pos_flat, color_flat, pos_flat,
                                   visible_mask=visible_flat,
                                   query_mask=target_mask_flat)
        return torch.where(target_mask_flat[:, None], field_colors, color_flat)
    n_fill = int(torch.count_nonzero(target_mask_flat))  # host sync
    if n_fill == 0:
        return color_flat
    ref_pts, ref_vals, ref_valid = _select_masked_points(
        pos_flat, color_flat, visible_flat, max_ref)

    def blend(queries):
        d, idx = knn(queries, ref_pts, k=k, chunk=chunk, ref_valid=ref_valid)
        vals = ref_vals[idx]                                   # [q, k, C]
        if k == 1:
            return vals[:, 0]
        w = 1.0 / torch.clamp(d, min=1e-6)
        w = w / torch.sum(w, dim=-1, keepdim=True)
        return torch.einsum("qk,qkc->qc", w, vals)

    if n_fill <= max_fill:
        qidx = torch.argsort((~target_mask_flat).to(torch.uint8),
                             stable=True)[:max_fill]
        upd = torch.where(target_mask_flat[qidx][:, None], blend(pos_flat[qidx]),
                          color_flat[qidx])
        out = color_flat.clone()
        out[qidx] = upd
        return out
    return torch.where(target_mask_flat[:, None], blend(pos_flat), color_flat)


@torch.no_grad()
def _relax_fill(color, update_mask, support_mask, iters: int):
    """Jacobi-average each ``update_mask`` texel over its in-chart
    4-neighbours (wrapping at the atlas edge) ``iters`` times, holding the
    other texels fixed: the fill becomes continuous with the visible
    texels at the visibility boundary; out-of-chart texels never
    contribute."""
    w = support_mask.to(color.dtype)
    wsum = 0.0
    for dim, sh in _NEIGHBOURS:
        wsum = wsum + torch.roll(w, sh, dims=dim)
    upd = update_mask & support_mask & (wsum > 0)
    denom = torch.clamp(wsum, min=1e-6)
    for _ in range(iters):
        cw = color * w
        nsum = 0.0
        for dim, sh in _NEIGHBOURS:
            nsum = nsum + torch.roll(cw, sh, dims=dim)
        color = torch.where(upd, nsum / denom, color)
    return color


@torch.no_grad()
@exact_f32()
def _finish_reproject_blur(
    uv_out, color_cur, mask_cur, boundary, visible_any,
    *, method, kernel_size_blur, knn_max_ref, knn_chunk, query_field=None,
    fill_k=1, fill_relax_iters=0, query_field_auto=None,
):
    """Fill + seam blur + pull-push — the bake tail after the paste.

    ``query_field_auto``: with a ``query_field``, the chart's visible
    fraction (counted on the host) picks the fill: at or above the
    threshold the k-nearest fill and relaxation, below it the field
    without relaxation."""
    mask_2d = uv_out["mask"]
    H2, W2, C = color_cur.shape
    invis_flat = (mask_2d & ~mask_cur).reshape(-1)
    if query_field is not None and query_field_auto is not None:
        n_valid = int(torch.count_nonzero(mask_2d))        # host sync
        n_fill = int(torch.count_nonzero(invis_flat))
        if 1.0 - n_fill / max(1, n_valid) >= query_field_auto:
            query_field = None                             # IDW + relaxation
        else:
            fill_relax_iters = 0                           # field: no relaxation
    color_flat = _fill_invisible_knn(
        uv_out["position"].reshape(-1, 3), color_cur.reshape(-1, C),
        mask_cur.reshape(-1), invis_flat,
        k=fill_k, max_ref=knn_max_ref, chunk=knn_chunk, query_field=query_field,
    )
    color_cur = color_flat.reshape(H2, W2, C)
    if fill_relax_iters > 0:
        color_cur = _relax_fill(color_cur, mask_2d & ~mask_cur, mask_2d,
                                fill_relax_iters)
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
        "fill": "knn" if query_field is None else "field",
    }


@torch.no_grad()
@exact_f32()
def bake_reproject_blending(
    uv_out, vis_out, priority: Tuple[int, ...] = VIEW_PRIORITY,
    n_blend_iters: int = 100, n_outpaint_iters: int = 50,
    knn_max_ref: int = 65536, knn_chunk: int = 4096,
) -> Dict[str, torch.Tensor]:
    """Priority paste + k=1 fill, then each view's visible colours
    seamlessly cloned over the texture (lowest priority first), the chart
    exterior diffusion-outpainted before each clone."""
    from ..ops.poisson import diffusion_inpaint, poisson_blend

    mask_2d = uv_out["mask"]
    visible, colors = vis_out["visible"], vis_out["colors"]
    H2, W2 = mask_2d.shape[:2]
    C = colors.shape[-1]
    color_cur = torch.zeros((H2, W2, C), dtype=colors.dtype, device=colors.device)
    mask_cur = torch.zeros((H2, W2, 1), dtype=torch.bool, device=colors.device)
    for i in priority:
        extra = (~mask_cur) & visible[i]
        color_cur = torch.where(extra, colors[i], color_cur)
        mask_cur = mask_cur | extra
    color_cur = _fill_invisible_knn(
        uv_out["position"].reshape(-1, 3), color_cur.reshape(-1, C),
        mask_cur.reshape(-1), (mask_2d & ~mask_cur).reshape(-1),
        k=1, max_ref=knn_max_ref, chunk=knn_chunk,
    ).reshape(H2, W2, C)
    for i in reversed(priority):
        color_cur = diffusion_inpaint(color_cur, ~mask_2d, n_outpaint_iters)
        color_cur = poisson_blend(colors[i], color_cur, visible[i], n_blend_iters)
    color_cur = torch.where(mask_2d, color_cur, torch.zeros_like(color_cur))
    return {
        "texture": pull_push(color_cur, mask_2d),
        "mask_2d": mask_2d,
        "mask_visible_any": visible.any(dim=0),
    }


@torch.no_grad()
@exact_f32()
def bake_kdtree(
    uv_out, vis_out, mv_out, view_images, method: str = "order_mean",
    n_neighbors: int = 8, n_neighbors_visible: int = 4,
    n_neighbors_invisible: int = 8, priority: Tuple[int, ...] = VIEW_PRIORITY,
    knn_max_ref: int = 65536, knn_chunk: int = 4096, query_field=None,
) -> Dict[str, torch.Tensor]:
    """KNN baking from the views' visible pixel clouds: 'order_mean' takes
    for each texel the mean of the k nearest pixels of the highest-priority
    view that sees it; 'mean' / 'mvpaint' (inverse distance × normal
    agreement) blend all views at once.  Texels nothing covers take the
    k-nearest fill, or ``query_field``."""
    if method not in ("mean", "mvpaint", "order_mean"):
        raise ValueError(f"kdtree method {method!r}")
    mask_2d = uv_out["mask"]
    H2, W2 = mask_2d.shape[:2]
    C = view_images.shape[-1]
    q = uv_out["position"].reshape(-1, 3)
    mv_pos = mv_out["position"]
    mv_vis = (mv_out["mask"] & mv_out["mask_visible"])[..., 0]

    if method in ("mean", "mvpaint"):
        ref_pts, ref_vals, ref_valid = _select_masked_points(
            mv_pos.reshape(-1, 3),
            torch.cat([view_images.reshape(-1, C),
                       mv_out["face_normal"].reshape(-1, 3)], -1),
            mv_vis.reshape(-1), knn_max_ref)
        d, idx = knn(q, ref_pts, k=n_neighbors, chunk=knn_chunk, ref_valid=ref_valid)
        gathered = ref_vals[idx]
        colors_k = gathered[..., :C]
        if method == "mean":
            color_flat = colors_k.mean(dim=-2)
        else:
            w = 1.0 / torch.clamp(d, min=1e-8)
            w = w / torch.sum(w, dim=-1, keepdim=True)
            w = w * torch.einsum("qkc,qc->qk", gathered[..., C:],
                                 uv_out["face_normal"].reshape(-1, 3))
            color_flat = torch.nan_to_num(
                torch.einsum("qk,qkc->qc", w, colors_k)
                / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-8))
        covered = torch.ones((H2 * W2,), dtype=torch.bool, device=q.device)
    else:
        visible = vis_out["visible"]
        color_flat = torch.zeros((H2 * W2, C), dtype=view_images.dtype,
                                 device=q.device)
        covered = torch.zeros((H2 * W2,), dtype=torch.bool, device=q.device)
        for i in priority:
            extra = (~covered) & visible[i].reshape(-1)
            ref_pts, ref_vals, ref_valid = _select_masked_points(
                mv_pos[i].reshape(-1, 3), view_images[i].reshape(-1, C),
                mv_vis[i].reshape(-1), knn_max_ref)
            _, idx = knn(q, ref_pts, k=n_neighbors_visible, chunk=knn_chunk,
                         ref_valid=ref_valid)
            color_flat = torch.where(extra[:, None], ref_vals[idx].mean(dim=-2),
                                     color_flat)
            covered = covered | extra

    color_flat = _fill_invisible_knn(
        q, color_flat, covered, mask_2d.reshape(-1) & ~covered,
        k=n_neighbors_invisible, max_ref=knn_max_ref, chunk=knn_chunk,
        query_field=query_field,
    )
    color_2d = color_flat.reshape(H2, W2, C)
    color_2d = torch.where(mask_2d, color_2d, torch.zeros_like(color_2d))
    return {"texture": pull_push(color_2d, mask_2d), "mask_2d": mask_2d}


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
    """Full stage-2 bake: view_images [M, H, W, C] (C = 3 RGB or 9 PBR) ->
    texture [uv_size, uv_size, C] and diagnostic masks, on the device of
    the mesh.  ``method``: "reproject" (paste, fill, seam blur; its
    options ``paste_mode``, ``fill_k``, ``fill_relax_iters``,
    ``query_field``, ``query_field_auto``, ``geometry_size``,
    ``low_hbm_row_chunk`` and the paste/blur kernel sizes ride in
    ``bake_kwargs``), "reproject_blending" or "kdtree" (their keyword
    options likewise).  ``low_hbm`` pastes view by view in row slabs
    (priority paste only; the same texture, a smaller peak).
    ``geometry_size`` (reproject only) renders the views' geometry buffers
    at that size and samples the colour at the view images' own.  The
    reproject route's output says which fill it took under ``"fill"``:
    "knn" (k nearest visible texels) or "field" (``query_field``)."""
    if method not in ("reproject", "kdtree", "reproject_blending"):
        raise ValueError(f"bake method {method!r}")
    M, H, W, C = view_images.shape
    if C not in (3, 9):
        raise ValueError(f"view images with {C} channels (3 or 9)")
    row_chunk = bake_kwargs.get("low_hbm_row_chunk", 256)
    uv_out = uv_render(mesh, uv_size, face_chunk=face_chunk,
                       tile_batch=8 if low_hbm else 64,
                       row_chunk=row_chunk if low_hbm else None)
    geom_hw = tuple(bake_kwargs.get("geometry_size") or (H, W))
    if geom_hw != (H, W) and method != "reproject":
        raise ValueError("geometry_size other than the view size needs "
                         "method='reproject'")
    mv_out = mv_render(
        mesh, c2ws, intrinsics, geom_hw, perspective=perspective,
        grad_norm_threshold=grad_norm_threshold,
        ray_normal_angle_threshold=ray_normal_angle_threshold,
        filt_gradient_points=filt_gradient_points, face_chunk=face_chunk,
        tile_batch=8 if low_hbm else 64,
    )
    if method == "reproject":
        vp_kwargs = dict(
            perspective=perspective,
            ray_normal_angle_threshold=ray_normal_angle_threshold,
            depth_eps=depth_eps, visibility_mode=visibility_mode,
            ring_kernels=(3, 5),
            priority=bake_kwargs.get("priority", VIEW_PRIORITY),
            kernel_size_boundary=bake_kwargs.get("kernel_size_boundary", 3),
            kernel_size_boundary_blur=bake_kwargs.get("kernel_size_boundary_blur", 3),
        )
        if visibility_mode not in ("depth", "tid", "both"):
            raise ValueError(f"visibility_mode {visibility_mode!r}")
        maskv = mv_out["mask"] & mv_out["mask_visible"]
        if low_hbm:
            if bake_kwargs.get("paste_mode", "priority") != "priority":
                raise ValueError("the low_hbm bake takes the priority paste only")
            # the scanned paste reads only these of the view buffers
            mv_out = {k: mv_out[k] for k in ("mvp", "w2cs", "depth", "tri")}
            color_cur, mask_cur, boundary, visible_any, vis_pv = _visibility_paste_scan(
                uv_out["position"], uv_out["mask"], uv_out["tri"],
                uv_out["face_normal"], mv_out["mvp"], mv_out["w2cs"], c2ws,
                mv_out["depth"], mv_out["tri"], maskv, view_images,
                row_chunk=row_chunk, **vp_kwargs)
        else:
            color_cur, mask_cur, boundary, visible_any, vis_pv = _visibility_paste(
                uv_out["position"], uv_out["mask"], uv_out["tri"],
                uv_out["face_normal"], mv_out["mvp"], mv_out["w2cs"], c2ws,
                mv_out["depth"], mv_out["tri"], maskv, view_images,
                paste_mode=bake_kwargs.get("paste_mode", "priority"), **vp_kwargs)
        out = _finish_reproject_blur(
            uv_out, color_cur, mask_cur, boundary, visible_any,
            method=bake_kwargs.get("method", "lens"),
            kernel_size_blur=bake_kwargs.get("kernel_size_blur", 5),
            knn_max_ref=knn_max_ref, knn_chunk=knn_chunk,
            query_field=bake_kwargs.get("query_field"),
            fill_k=bake_kwargs.get("fill_k", 1),
            fill_relax_iters=bake_kwargs.get("fill_relax_iters", 0),
            query_field_auto=bake_kwargs.get("query_field_auto"),
        )
        out["visible_per_view"] = vis_pv
        out["mask_visible_any"] = visible_any
        return out
    # reproject-only options that may ride along: not taken by the others
    for consumed in ("geometry_size", "low_hbm_row_chunk", "query_field_auto"):
        bake_kwargs.pop(consumed, None)
    vis_out = view_visibility(
        uv_out, mv_out, c2ws, view_images, perspective=perspective,
        ray_normal_angle_threshold=ray_normal_angle_threshold,
        depth_eps=depth_eps, visibility_mode=visibility_mode,
    )
    if method == "reproject_blending":
        out = bake_reproject_blending(uv_out, vis_out, knn_max_ref=knn_max_ref,
                                      knn_chunk=knn_chunk, **bake_kwargs)
    else:
        out = bake_kdtree(uv_out, vis_out, mv_out, view_images,
                          knn_max_ref=knn_max_ref, knn_chunk=knn_chunk,
                          **bake_kwargs)
    out["visible_per_view"] = vis_out["visible"]
    out["mask_visible_any"] = vis_out["visible"].any(dim=0)
    return out
