"""Camera matrix conversions in PyTorch (port of unitex_tpu/camera/conversion.py).

Conventions match the JAX package: normalized 3x3 intrinsics, OpenGL-style
projection with the y row negated (image rows run top to bottom), world
frame x forward / y right / z up, camera looking along -z.  Every product
is exact f32: these projections feed the bake's 5e-3 depth test, so no
TF32 (see utils/precision.py).
"""

from __future__ import annotations

import torch

from ..utils.precision import exact_f32


def intr_to_proj(
    intr: torch.Tensor, near: float = 0.01, far: float = 1000.0,
    perspective: bool = True,
) -> torch.Tensor:
    """Normalized intrinsics [..., 3, 3] -> clip-space projection [..., 4, 4]."""
    batch = intr.shape[:-2]
    z = torch.zeros(batch, dtype=intr.dtype, device=intr.device)
    o = torch.ones(batch, dtype=intr.dtype, device=intr.device)
    fx, fy = intr[..., 0, 0], intr[..., 1, 1]
    cx, cy = intr[..., 0, 2], intr[..., 1, 2]
    if perspective:
        rows = [
            [2 * fx, z, 2 * cx - 1, z],
            [z, 2 * fy, 2 * cy - 1, z],
            [z, z, -(far + near) / (far - near) * o,
             -2.0 * far * near / (far - near) * o],
            [z, z, -o, z],
        ]
    else:
        rows = [
            [fx, z, z, -(2 * cx - 1)],
            [z, fy, z, -(2 * cy - 1)],
            [z, z, -2.0 / (far - near) * o, -(far + near) / (far - near) * o],
            [z, z, z, o],
        ]
    proj = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    flip = torch.tensor([1.0, -1.0, 1.0, 1.0], dtype=intr.dtype,
                        device=intr.device)
    return proj * flip[:, None]


@exact_f32()
def c2w_to_w2c(c2w: torch.Tensor) -> torch.Tensor:
    """Invert rigid camera-to-world transforms [..., 4, 4]."""
    rt = c2w[..., :3, :3].transpose(-1, -2)
    t = -torch.matmul(rt, c2w[..., :3, 3:])
    top = torch.cat([rt, t], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


@exact_f32()
def get_mvp(
    c2ws: torch.Tensor,
    intrinsics: torch.Tensor,
    perspective: bool = True,
    near: float = 0.01,
    far: float = 1000.0,
) -> torch.Tensor:
    """Model-view-projection matrices [..., 4, 4]."""
    proj = intr_to_proj(intrinsics, near=near, far=far, perspective=perspective)
    return torch.matmul(proj, c2w_to_w2c(c2ws))


@exact_f32()
def transform_points_mat4(points3: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """3D points [..., 3] through a 4x4 matrix -> homogeneous [..., 4],
    as the affine split ``p @ M[:, :3]^T + M[:, 3]`` (the JAX package's
    form, without a materialized homogeneous input)."""
    lin = torch.matmul(points3, mat[..., :, :3].transpose(-1, -2))
    return lin + mat[..., :, 3]


def proj_to_intr(proj: torch.Tensor, perspective: bool = True) -> torch.Tensor:
    """Inverse of :func:`intr_to_proj` (ignoring near/far)."""
    flip = torch.tensor([1.0, -1.0, 1.0, 1.0], dtype=proj.dtype,
                        device=proj.device)
    proj = proj * flip[:, None]
    batch = proj.shape[:-2]
    z = torch.zeros(batch, dtype=proj.dtype, device=proj.device)
    o = torch.ones(batch, dtype=proj.dtype, device=proj.device)
    if perspective:
        fx = proj[..., 0, 0] / 2.0
        fy = proj[..., 1, 1] / 2.0
        cx = 0.5 * proj[..., 0, 2] + 0.5
        cy = 0.5 * proj[..., 1, 2] + 0.5
    else:
        fx = proj[..., 0, 0]
        fy = proj[..., 1, 1]
        cx = 0.5 * (-proj[..., 0, 3]) + 0.5
        cy = 0.5 * (-proj[..., 1, 3]) + 0.5
    rows = [[fx, z, cx], [z, fy, cy], [z, z, o]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


@exact_f32()
def transform_points_homo(points_h: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] @ [..., 4, 4]ᵀ."""
    return torch.matmul(points_h, mat.transpose(-1, -2))


def project(points_h: torch.Tensor, intrinsics: torch.Tensor,
            perspective: bool = True):
    """Camera-space homogeneous points -> (ndc xy [..., 2], clip w [..., 1])."""
    clip = transform_points_homo(points_h,
                                 intr_to_proj(intrinsics, perspective=perspective))
    w = clip[..., 3:4]
    return clip[..., :2] / w, w


@exact_f32()
def unproject(ndc: torch.Tensor, depth: torch.Tensor, intrinsics: torch.Tensor,
              perspective: bool = True) -> torch.Tensor:
    """NDC xy + depth -> camera-space homogeneous points [..., 4]."""
    inv = torch.linalg.inv(intr_to_proj(intrinsics, perspective=perspective))
    if perspective:
        clip = torch.cat([ndc * depth, torch.zeros_like(depth), depth], dim=-1)
        pts = transform_points_homo(clip, inv)
    else:
        clip = torch.cat([ndc, torch.zeros_like(depth), torch.ones_like(depth)],
                         dim=-1)
        pts = transform_points_homo(clip, inv)
        pts = torch.cat([pts[..., :2], depth.expand_as(pts[..., 2:3]),
                         pts[..., 3:]], dim=-1)
    return torch.cat([pts[..., :3], torch.ones_like(pts[..., 3:])], dim=-1)


def discretize(ndc: torch.Tensor, H: int, W: int, is_ndc: bool = True,
               align_corner: bool = False) -> torch.Tensor:
    """NDC/unit xy -> continuous pixel coordinates (u right, v down)."""
    uf, vf = ndc[..., 0], ndc[..., 1]
    if is_ndc:
        uf = uf * 0.5 + 0.5
        vf = vf * 0.5 + 0.5
    if align_corner:
        return torch.stack([uf * (W - 1) + 0.5, vf * (H - 1) + 0.5], dim=-1)
    return torch.stack([uf * W, vf * H], dim=-1)


def undiscretize(pix: torch.Tensor, H: int, W: int, to_ndc: bool = True,
                 align_corner: bool = False) -> torch.Tensor:
    """Pixel coordinates -> NDC/unit xy."""
    ui, vi = pix[..., 0], pix[..., 1]
    if align_corner:
        uf, vf = ui / (W - 1), vi / (H - 1)
    else:
        uf, vf = (ui + 0.5) / W, (vi + 0.5) / H
    if to_ndc:
        uf, vf = uf * 2.0 - 1.0, vf * 2.0 - 1.0
    return torch.stack([uf, vf], dim=-1)


def c2ws_to_rays(c2ws: torch.Tensor):
    """Camera centres and central view directions in the world x-fwd /
    y-right / z-up frame."""
    rows = [2, 0, 1]
    return c2ws[..., rows, 3], -c2ws[..., rows, 2]


@exact_f32()
def c2ws_to_ray_matrices(c2ws: torch.Tensor, intrinsics: torch.Tensor, H: int,
                         W: int, perspective: bool = True):
    """Per-pixel ray origins and directions [..., H, W, 3] (directions not
    normalized), on the cameras' device."""
    c2ws = c2ws[..., None, :, :]
    intrinsics = intrinsics[..., None, :, :]
    rays_o = c2ws[..., :3, 3][..., None, :]
    rays_d = -c2ws[..., :3, 2][..., None, :]
    ys = torch.arange(H, dtype=c2ws.dtype, device=c2ws.device)
    xs = torch.arange(W, dtype=c2ws.dtype, device=c2ws.device)
    gv, gu = torch.meshgrid(ys, xs, indexing="ij")
    grid_f = undiscretize(torch.stack([gu, gv], dim=-1), H=H, W=W)
    pts_cam = unproject(grid_f, torch.ones_like(grid_f[..., :1]), intrinsics,
                        perspective=perspective)
    pts_world = transform_points_homo(pts_cam, c2ws)
    if perspective:
        rays_dm = pts_world[..., :3] - rays_o
        return torch.broadcast_to(rays_o, rays_dm.shape), rays_dm
    rays_om = pts_world[..., :3]
    return rays_om, torch.broadcast_to(rays_d, rays_om.shape)
