"""Camera pose generation in PyTorch (port of unitex_tpu/camera/generator.py).

The six axis-aligned "box" views come out in the fixed order front, right,
back, left, top, down ("frbltd"); the pipeline reshuffles them into the
2x3 grid order front, right, top, back, left, down ("frtbld").  These
matrices are pinned numerically: the multi-view LoRAs were trained on them.
"""

from __future__ import annotations

import math

import torch

BOX_VIEW_NAMES = ("front", "right", "back", "left", "top", "down")
# frbltd -> frtbld
FRBLTD_TO_FRTBLD = (0, 1, 4, 2, 3, 5)
# frtbld -> fblrtd (per-view bake priority)
FRTBLD_TO_FBLRTD = (0, 3, 4, 1, 2, 5)
# frtbld grid -> frbltd-with-flipped-bottom used by infer_mv
FRTBLD_TO_FRBLTD = (0, 1, 3, 4, 2, 5)


def generate_intrinsics(
    f_x: float, f_y: float, fov: bool = True, degree: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Normalized 3x3 intrinsics.  ``fov=True``: f is a field of view
    (radians unless ``degree``); ``fov=False``: f is focal/size for
    perspective or the scale for orthographic cameras."""
    if fov:
        if degree:
            f_x, f_y = math.radians(f_x), math.radians(f_y)
        fx = 1.0 / (2.0 * math.tan(f_x / 2.0))
        fy = 1.0 / (2.0 * math.tan(f_y / 2.0))
    else:
        fx, fy = f_x, f_y
    return torch.tensor(
        [[fx, 0.0, 0.5], [0.0, fy, 0.5], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
    )


def lookat_to_matrix(lookat: torch.Tensor) -> torch.Tensor:
    """Camera positions [..., 3] looking at the origin -> c2w [..., 4, 4].

    Top/down poses (position parallel to z) use the hard-coded y-axis
    tangent, as the JAX package does."""
    lookat = lookat.to(torch.float32)
    batch = lookat.shape[:-1]
    dev = lookat.device
    e2 = torch.tensor([0.0, 1.0, 0.0], device=dev)
    e3 = torch.tensor([0.0, 0.0, 1.0], device=dev)
    z_axis = lookat / torch.clamp(
        torch.linalg.norm(lookat, dim=-1, keepdim=True), min=1e-12)
    x_axis = torch.linalg.cross(e3.expand_as(z_axis), z_axis, dim=-1)
    degenerate = torch.all(x_axis == 0.0, dim=-1, keepdim=True)
    x_axis = torch.where(degenerate, e2, x_axis)
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=-1)
    rots = torch.stack([x_axis, y_axis, z_axis], dim=-1)
    last = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand(*batch, 1, 4)
    c2w = torch.cat([torch.cat([rots, lookat[..., None]], dim=-1), last], dim=-2)
    # world axes are (x fwd, y right, z up); camera matrix rows must be
    # (z, x, y): reorder rows (1, 2, 0, 3)
    return c2w[..., (1, 2, 0, 3), :]


def generate_orbit_views_c2ws(
    num_views: int,
    radius: float = 1.0,
    height: float = 0.0,
    theta_0: float = 0.0,
    degree: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Turntable ring of cameras [num_views, 4, 4] looking at the origin.
    The endpoint is included (the last view duplicates the first), as
    with ``linspace``.  The angles are ``jnp.linspace``'s start·(1 − t) +
    stop·t in f32, with the product by 1/(n − 1) that XLA's CPU backend
    makes of its division, so a ring from 0 has the JAX package's angles
    bit for bit.  One view sits at the start angle, as ``linspace``'s
    single sample."""
    if degree:
        theta_0 = math.radians(theta_0)
    projected = math.sqrt(radius**2 - height**2)
    f32 = dict(dtype=torch.float32, device=device)
    start = torch.tensor(theta_0, **f32)
    stop = torch.tensor(2.0 * math.pi + theta_0, **f32)
    inv = 1.0 / torch.tensor(num_views - 1, **f32)
    i = torch.arange(num_views - 1, **f32)
    theta = torch.cat([start * (1 - i * inv) + (stop * inv) * i, stop[None]]) \
        if num_views > 1 else start[None]
    xyz = torch.stack([
        projected * torch.cos(theta),
        projected * torch.sin(theta),
        torch.full((num_views,), height, **f32),
    ], dim=-1)
    return lookat_to_matrix(xyz)


def generate_box_views_c2ws(radius: float = 2.8, device="cuda") -> torch.Tensor:
    """The six axis-aligned ortho views in frbltd order [6, 4, 4]."""
    r = float(radius)
    front = lookat_to_matrix(torch.tensor(
        [[r, 0, 0], [0, r, 0], [-r, 0, 0], [0, -r, 0]],
        dtype=torch.float32, device=device))
    top_down = torch.tensor(
        [
            [[1.0, 0.0, 0.0, 0.0],
             [0.0, 0.0, 1.0, r],
             [0.0, -1.0, 0.0, 0.0],
             [0.0, 0.0, 0.0, 1.0]],
            [[-1.0, 0.0, 0.0, 0.0],
             [0.0, 0.0, -1.0, -r],
             [0.0, -1.0, 0.0, 0.0],
             [0.0, 0.0, 0.0, 1.0]],
        ],
        dtype=torch.float32, device=device,
    )
    return torch.cat([front, top_down], dim=0)
