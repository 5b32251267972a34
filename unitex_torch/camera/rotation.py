"""Rotation representation conversions in PyTorch (port of
unitex_tpu/camera/rotation.py).

PyTorch3D-style conventions: right-handed, intrinsic rotations,
``convention`` strings like ``"XYZ"`` meaning R = R_X(a) @ R_Y(b) @ R_Z(c)
applied to column vectors; quaternions are (w, x, y, z).  The random
rotations take their normal draws (``draws`` [n, 4]) or a
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch


def _axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrices about a named axis for angles [...] -> [..., 3, 3]."""
    c = torch.cos(angle)
    s = torch.sin(angle)
    o = torch.ones_like(angle)
    z = torch.zeros_like(angle)
    if axis == "X":
        rows = (o, z, z, z, c, -s, z, s, c)
    elif axis == "Y":
        rows = (c, z, s, z, o, z, -s, z, c)
    elif axis == "Z":
        rows = (c, -s, z, s, c, z, z, z, o)
    else:
        raise ValueError(f"invalid axis {axis!r}")
    return torch.stack(rows, dim=-1).reshape(*angle.shape, 3, 3)


def euler_angles_to_matrix(euler_angles: torch.Tensor,
                           convention: str = "XYZ") -> torch.Tensor:
    """[..., 3] euler angles (radians) -> [..., 3, 3] rotation matrices."""
    if len(convention) != 3:
        raise ValueError("convention must have 3 letters")
    mats = [_axis_angle_rotation(axis, euler_angles[..., i])
            for i, axis in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def _angle_from_tan(axis, other_axis, data, horizontal, tait_bryan):
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ("XY", "YZ", "ZX")
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor,
                           convention: str = "XYZ") -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] euler angles (radians)."""
    if len(convention) != 3:
        raise ValueError("convention must have 3 letters")
    i0 = "XYZ".index(convention[0])
    i2 = "XYZ".index(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        sign = -1.0 if i0 - i2 in (-1, 2) else 1.0
        central = torch.asin(torch.clamp(matrix[..., i0, i2] * sign, -1.0, 1.0))
    else:
        central = torch.acos(torch.clamp(matrix[..., i0, i0], -1.0, 1.0))
    o = (
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False,
                        tait_bryan),
        central,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True,
                        tait_bryan),
    )
    return torch.stack(o, dim=-1)


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) quaternions -> [..., 3, 3]."""
    r, i, j, k = (quaternions[..., n] for n in range(4))
    two_s = 2.0 / torch.sum(quaternions * quaternions, dim=-1)
    o = torch.stack(
        (
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ),
        dim=-1,
    )
    return o.reshape(*quaternions.shape[:-1], 3, 3)


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w, x, y, z), branch-free (Shepperd): the
    candidate of the largest |component| wins, the first on a tie."""
    m00, m01, m02 = matrix[..., 0, 0], matrix[..., 0, 1], matrix[..., 0, 2]
    m10, m11, m12 = matrix[..., 1, 0], matrix[..., 1, 1], matrix[..., 1, 2]
    m20, m21, m22 = matrix[..., 2, 0], matrix[..., 2, 1], matrix[..., 2, 2]

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    q_abs = torch.stack([
        safe_sqrt(1.0 + m00 + m11 + m22),
        safe_sqrt(1.0 + m00 - m11 - m22),
        safe_sqrt(1.0 - m00 + m11 - m22),
        safe_sqrt(1.0 - m00 - m11 + m22),
    ], dim=-1)
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
    ], dim=-2)
    candidates = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    quat = torch.take_along_dim(
        candidates, best[..., None, None].expand(*best.shape, 1, 4), dim=-2
    )[..., 0, :]
    return quat / torch.linalg.norm(quat, dim=-1, keepdim=True)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle (Rodrigues) -> [..., 3, 3]."""
    angle = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    axis = axis_angle / torch.clamp(angle, min=1e-12)
    half = angle[..., 0] * 0.5
    xyz = axis * torch.sin(half)[..., None]
    return quaternion_to_matrix(torch.cat([torch.cos(half)[..., None], xyz],
                                          dim=-1))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """[..., 6] continuous 6D rotation representation -> [..., 3, 3]
    (Zhou et al. 2019): Gram-Schmidt on the two embedded vectors, which
    become the matrix's first two rows."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True), min=1e-12)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.norm(a2p, dim=-1, keepdim=True), min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 6]: the first two rows, flattened."""
    return matrix[..., :2, :].reshape(*matrix.shape[:-2], 6)


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """The representative with a non-negative real part."""
    return torch.where(quaternions[..., :1] < 0, -quaternions, quaternions)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product [..., 4] x [..., 4] -> [..., 4] (w, x, y, z)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product with a non-negative real part."""
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(quaternion: torch.Tensor) -> torch.Tensor:
    """The conjugate: the inverse rotation of a unit quaternion."""
    return quaternion * quaternion.new_tensor([1.0, -1.0, -1.0, -1.0])


def quaternion_apply(quaternion: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate points [..., 3] by unit quaternions [..., 4]: q p q⁻¹."""
    p = torch.cat([torch.zeros_like(point[..., :1]), point], dim=-1)
    out = quaternion_raw_multiply(quaternion_raw_multiply(quaternion, p),
                                  quaternion_invert(quaternion))
    return out[..., 1:]


def _sin_half_over_angle(angle, half):
    """sin(t/2)/t, its Taylor form 1/2 - t²/48 below 1e-6."""
    return torch.where(torch.abs(angle) < 1e-6, 0.5 - (angle ** 2) / 48.0,
                       torch.sin(half) / torch.clamp(angle, min=1e-30))


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """[..., 3] Rodrigues vector -> unit quaternion (w, x, y, z)."""
    angle = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = angle * 0.5
    return torch.cat([torch.cos(half),
                      axis_angle * _sin_half_over_angle(angle, half)], dim=-1)


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> Rodrigues vector."""
    norms = torch.linalg.norm(quaternions[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(norms, quaternions[..., :1])
    return quaternions[..., 1:] / _sin_half_over_angle(2.0 * half, half)


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] Rodrigues vector."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def random_quaternions(n: int, generator: Optional[torch.Generator] = None,
                       draws: Optional[torch.Tensor] = None,
                       device=None) -> torch.Tensor:
    """n uniform random unit quaternions with a non-negative real part,
    from standard-normal ``draws`` [n, 4], else drawn from ``generator``
    on ``device`` (by default the generator's device, else CUDA)."""
    if draws is None:
        if device is None:
            device = generator.device if generator is not None else "cuda"
        draws = torch.randn((n, 4), generator=generator, device=device)
    q = torch.as_tensor(draws, dtype=torch.float32)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return standardize_quaternion(q)


def random_rotations(n: int, generator: Optional[torch.Generator] = None,
                     draws: Optional[torch.Tensor] = None,
                     device=None) -> torch.Tensor:
    """n uniform random rotation matrices [n, 3, 3]."""
    return quaternion_to_matrix(random_quaternions(n, generator, draws, device))


def random_rotation(generator: Optional[torch.Generator] = None,
                    draws: Optional[torch.Tensor] = None,
                    device=None) -> torch.Tensor:
    """One uniform random rotation matrix [3, 3]."""
    return random_rotations(1, generator, draws, device)[0]
