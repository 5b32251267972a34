"""Geometry conditioning renders + the pipeline's grid/strip permutations
(port of unitex_tpu/render/conditioning.py).

The multi-view LoRAs were trained on these exact layouts, so the
permutations are pinned:

* box cameras come out in **frbltd** (front right back left top down);
* the 2x3 condition grid uses **frtbld** (c2ws reorder [0,1,4,2,3,5]):
  row 0 = front right top, row 1 = back left down;
* before FLUX, the grid becomes a 1x6 strip in order
  [front, left, right, back, top, down] — cell permutation [0,4,1,3,2,5]
  of the row-major frtbld grid — with the **down view rotated 180°**;
* after FLUX, the strip maps back with the inverse permutation
  [0,2,4,3,1,5] and the down view rotated back.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..camera.generator import (
    FRBLTD_TO_FRTBLD,
    generate_box_views_c2ws,
    generate_intrinsics,
)
from ..geometry.mesh import Mesh
from .renderer import RenderOutputs, render_views

# row-major frtbld grid cells -> 1x6 FLUX strip
GRID_TO_STRIP = (0, 4, 1, 3, 2, 5)
# 1x6 FLUX strip -> row-major frtbld grid cells
STRIP_TO_GRID = (0, 2, 4, 3, 1, 5)
# index of the "down" view: grid cell 5, strip cell 5
DOWN_CELL = 5


def views_to_grid(views: torch.Tensor, rows: int = 2, cols: int = 3) -> torch.Tensor:
    """[rows*cols, H, W, C] -> [rows*H, cols*W, C] row-major tiling."""
    n, H, W, C = views.shape
    if n != rows * cols:
        raise ValueError(f"{n} views do not tile {rows}x{cols}")
    return (
        views.reshape(rows, cols, H, W, C)
        .permute(0, 2, 1, 3, 4)
        .reshape(rows * H, cols * W, C)
    )


def grid_to_views(grid: torch.Tensor, rows: int = 2, cols: int = 3) -> torch.Tensor:
    """[rows*H, cols*W, C] -> [rows*cols, H, W, C]."""
    GH, GW, C = grid.shape
    H, W = GH // rows, GW // cols
    return (
        grid.reshape(rows, H, cols, W, C)
        .permute(0, 2, 1, 3, 4)
        .reshape(rows * cols, H, W, C)
    )


def _flip_down(views: torch.Tensor) -> torch.Tensor:
    views = views.clone()
    views[DOWN_CELL] = torch.flip(views[DOWN_CELL], dims=(0, 1))
    return views


def grid_to_strip(grid: torch.Tensor) -> torch.Tensor:
    """frtbld 2x3 grid image -> 1x6 FLUX strip image with the down view
    rotated 180°."""
    views = _flip_down(grid_to_views(grid, 2, 3))
    return views_to_grid(views[list(GRID_TO_STRIP)], 1, 6)


def strip_to_grid(strip: torch.Tensor) -> torch.Tensor:
    """1x6 FLUX strip image -> frtbld 2x3 grid image, down view rotated back."""
    views = _flip_down(grid_to_views(strip, 1, 6))
    return views_to_grid(views[list(STRIP_TO_GRID)], 2, 3)


def condition_cameras(
    radius: float = 2.8, ortho_scale: float = 1.0, device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The six frtbld condition cameras + normalized ortho intrinsics."""
    c2ws = generate_box_views_c2ws(radius, device=device)[list(FRBLTD_TO_FRTBLD)]
    intr = generate_intrinsics(ortho_scale, ortho_scale, fov=False, device=device)
    return c2ws, intr


def render_geometry_condition(
    mesh: Mesh,
    view_size: int = 512,
    radius: float = 2.8,
    ortho_scale: float = 1.0,
    background: float = 0.5,
    rows: int = 2,
    cols: int = 3,
    face_chunk: int = 512,
    tile_batch: int = 64,
) -> Dict[str, torch.Tensor]:
    """Render the 6-view geometry conditioning grids of an already scaled
    mesh.  Returns 'alpha' [GH, GW, 1], 'ccm'/'normal' [GH, GW, 3] in
    [0, 1] (background = ``background`` grey), their per-view forms, plus
    'c2ws' [6, 4, 4] and 'intrinsics' [3, 3], on the mesh's device."""
    c2ws, intr = condition_cameras(radius, ortho_scale,
                                   device=mesh.vertices.device)
    out: RenderOutputs = render_views(
        mesh, c2ws, intr, (view_size, view_size),
        perspective=False,
        render_world_normal=True,
        render_world_position=True,
        face_chunk=face_chunk,
        tile_batch=tile_batch,
    )
    alpha = out.alpha
    ccm = out.world_position * 0.5 + 0.5
    normal = out.world_normal * 0.5 + 0.5
    ccm = ccm * alpha + background * (1.0 - alpha)
    normal = normal * alpha + background * (1.0 - alpha)
    return {
        "alpha": views_to_grid(alpha, rows, cols),
        "ccm": views_to_grid(ccm, rows, cols),
        "normal": views_to_grid(normal, rows, cols),
        "alpha_views": alpha,
        "ccm_views": ccm,
        "normal_views": normal,
        "c2ws": c2ws,
        "intrinsics": intr,
    }
