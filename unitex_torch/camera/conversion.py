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
