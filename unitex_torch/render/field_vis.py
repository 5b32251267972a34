"""Scalar-field visualization: grid evaluation and isosurface extraction
(port of unitex_tpu/render/field_vis.py).

``create_grid`` evaluates a field callback on the dense [-1, 1]³
cell-centre grid; ``marching_tetrahedra`` extracts an isosurface with
vectorized marching tetrahedra (6 tets a cell, every case as a numpy
mask), orienting each triangle against the field gradient so normals
point out of the {value > iso} region; ``export_isosurface`` writes the
mesh, viewable with ``scripts/view_mesh.py``.  A numpy copy of the JAX
package's module, the same arrays bit for bit; only ``create_grid`` also
takes a field on a torch device (``device=``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def create_grid(
    field: Callable,
    D: int,
    H: int,
    W: int,
    device=None,
) -> np.ndarray:
    """Evaluate ``field(xs, ys, zs)`` on the [-1, 1]³ cell-centre grid: xs
    varies along W, ys along H, zs along D.  Returns values [D, H, W]
    float32 on the host.  With ``device`` the coordinates are passed as
    tensors on that device (the same values) and the field may answer with
    a tensor there, so a field on the card can be browsed."""
    xs = np.linspace(-1.0, 1.0, W + 1, dtype=np.float32)[:W] + (1.0 / W)
    ys = (np.linspace(-1.0, 1.0, H + 1, dtype=np.float32)[:H] + (1.0 / H))[:, None]
    zs = (np.linspace(-1.0, 1.0, D + 1, dtype=np.float32)[:D] + (1.0 / D))[
        :, None, None
    ]
    xs, ys, zs = np.broadcast_arrays(xs, ys, zs)
    if device is not None:
        import torch

        xs, ys, zs = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                      for a in (xs, ys, zs))
    values = field(xs, ys, zs)
    if hasattr(values, "detach"):
        values = values.detach().cpu().numpy()
    return np.asarray(values, np.float32)


# cube corners in (x, y, z) bit order and the 6-tet decomposition sharing
# the main diagonal (corner 0 -> corner 7)
_CORNERS = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.int64
)
_TETS = np.array(
    [
        (0, 5, 1, 7),
        (0, 1, 3, 7),
        (0, 3, 2, 7),
        (0, 2, 6, 7),
        (0, 6, 4, 7),
        (0, 4, 5, 7),
    ],
    np.int64,
)


def marching_tetrahedra(
    values: np.ndarray, iso: float = 0.0, grid_coords: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``values == iso`` surface from a [D, H, W] scalar grid.

    Returns (vertices [N, 3] float32 in the grid's coordinate frame, faces
    [F, 3] int64).  ``grid_coords`` [D, H, W, 3] overrides the default
    cell-center frame of ``create_grid``; vertices are linearly interpolated
    along tetrahedron edges that cross the isovalue."""
    D, H, W = values.shape
    if grid_coords is None:
        xs = np.linspace(-1.0, 1.0, W + 1, dtype=np.float32)[:W] + 1.0 / W
        ys = np.linspace(-1.0, 1.0, H + 1, dtype=np.float32)[:H] + 1.0 / H
        zs = np.linspace(-1.0, 1.0, D + 1, dtype=np.float32)[:D] + 1.0 / D
        gz, gy, gx = np.meshgrid(zs, ys, xs, indexing="ij")
        grid_coords = np.stack([gx, gy, gz], axis=-1)

    # corner values/positions for every cell: [C, 8]
    dz, dy, dx = np.meshgrid(
        np.arange(D - 1), np.arange(H - 1), np.arange(W - 1), indexing="ij"
    )
    base = np.stack([dx.ravel(), dy.ravel(), dz.ravel()], axis=-1)  # [C, 3]
    cx = base[:, None, 0] + _CORNERS[None, :, 0]
    cy = base[:, None, 1] + _CORNERS[None, :, 1]
    cz = base[:, None, 2] + _CORNERS[None, :, 2]
    cval = values[cz, cy, cx]  # [C, 8]
    cpos = grid_coords[cz, cy, cx]  # [C, 8, 3]

    tv = cval[:, _TETS].reshape(-1, 4)  # [T, 4]
    tp = cpos[:, _TETS].reshape(-1, 4, 3)  # [T, 4, 3]
    inside = tv > iso
    code = (
        inside[:, 0] * 1 + inside[:, 1] * 2 + inside[:, 2] * 4 + inside[:, 3] * 8
    )

    def edge_point(t_idx, a, b):
        va, vb = tv[t_idx, a], tv[t_idx, b]
        t = (iso - va) / np.where(np.abs(vb - va) > 1e-30, vb - va, 1.0)
        t = np.clip(t, 0.0, 1.0)[:, None]
        return tp[t_idx, a] * (1.0 - t) + tp[t_idx, b] * t

    tris = []
    others = {0: (1, 2, 3), 1: (0, 2, 3), 2: (0, 1, 3), 3: (0, 1, 2)}
    # one-inside (and mirrored three-inside) cases: a fan from that vertex
    for k in range(4):
        m, n, o = others[k]
        for c in (1 << k, 15 ^ (1 << k)):
            idx = np.nonzero(code == c)[0]
            if len(idx):
                tris.append(
                    np.stack(
                        [
                            edge_point(idx, k, m),
                            edge_point(idx, k, n),
                            edge_point(idx, k, o),
                        ],
                        axis=1,
                    )
                )
    # two-inside cases: a quad between the inside pair and the outside pair
    for k, l in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
        c = (1 << k) | (1 << l)
        idx = np.nonzero(code == c)[0]
        if len(idx):
            m, n = [x for x in range(4) if x not in (k, l)]
            km = edge_point(idx, k, m)
            kn = edge_point(idx, k, n)
            lm = edge_point(idx, l, m)
            ln = edge_point(idx, l, n)
            tris.append(np.stack([km, kn, ln], axis=1))
            tris.append(np.stack([km, ln, lm], axis=1))
    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    tri = np.concatenate(tris, axis=0)  # [F, 3, 3]

    # orient every triangle so its normal points OUT of the enclosed
    # {value > iso} region, i.e. along the negative field gradient
    centroid = tri.mean(axis=1)
    grad = _trilinear_gradient(values, grid_coords, centroid)
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.einsum("ij,ij->i", nrm, grad) > 0
    tri[flip] = tri[flip][:, ::-1]

    # weld duplicate edge vertices so the surface is a connected mesh
    verts = tri.reshape(-1, 3)
    key = np.round(verts.astype(np.float64) * 1e6).astype(np.int64)
    _, first, inv = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    return verts[first].astype(np.float32), inv.reshape(-1, 3)


def _trilinear_gradient(
    values: np.ndarray, grid_coords: np.ndarray, points: np.ndarray
) -> np.ndarray:
    """Central-difference field gradient sampled (nearest-cell) at points."""
    D, H, W = values.shape
    gz, gy, gx = np.gradient(values)
    lo = grid_coords[0, 0, 0]
    hi = grid_coords[-1, -1, -1]
    rel = (points - lo) / np.maximum(hi - lo, 1e-12)
    ix = np.clip(np.round(rel[:, 0] * (W - 1)).astype(np.int64), 0, W - 1)
    iy = np.clip(np.round(rel[:, 1] * (H - 1)).astype(np.int64), 0, H - 1)
    iz = np.clip(np.round(rel[:, 2] * (D - 1)).astype(np.int64), 0, D - 1)
    return np.stack(
        [gx[iz, iy, ix], gy[iz, iy, ix], gz[iz, iy, ix]], axis=-1
    )


def export_isosurface(
    field_or_values,
    out_path: str,
    resolution: int = 64,
    iso: float = 0.0,
    device=None,
) -> str:
    """Evaluate (given a callable, on ``device`` as :func:`create_grid`)
    and extract the isosurface, then write it as a mesh (.obj/.ply/.glb),
    viewable with ``python -m unitex_torch.scripts.view_mesh``."""
    if callable(field_or_values):
        values = create_grid(field_or_values, resolution, resolution,
                             resolution, device=device)
    else:
        values = np.asarray(field_or_values, np.float32)
    verts, faces = marching_tetrahedra(values, iso=iso)
    from ..geometry.io.mesh_io import HostMesh, save_mesh

    save_mesh(out_path, HostMesh(vertices=verts, faces=faces.astype(np.int64)))
    return out_path
