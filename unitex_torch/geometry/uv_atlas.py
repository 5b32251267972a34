"""UV atlas generation: chart segmentation, parameterization, packing.

Standalone replacement for the open3d UVAtlas / xatlas unwrap used by the
reference (TextureTools geometry/uv/uv_atlas.py:83-123): faces are clustered
into charts by dominant normal direction (box projection, split into
connected components), each chart is flattened — planar projection with an
LSCM (least-squares conformal map, scipy.sparse) refinement for curved
charts — and the charts are packed into a square atlas with a gutter margin,
scaled for uniform texel density.

Host-side numpy/scipy: unwrapping is irreducibly sequential/sparse, the same
reason the reference keeps it on CPU.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from .io.mesh_io import HostMesh

# the 6 box directions: +x -x +y -y +z -z
_BOX_DIRS = np.asarray(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    dtype=np.float64,
)
# per-direction (u_axis, v_axis) for planar projection
_BOX_AXES = {
    0: ((0, -1, 0), (0, 0, 1)),
    1: ((0, 1, 0), (0, 0, 1)),
    2: ((1, 0, 0), (0, 0, 1)),
    3: ((-1, 0, 0), (0, 0, 1)),
    4: ((1, 0, 0), (0, 1, 0)),
    5: ((1, 0, 0), (0, -1, 0)),
}


def _face_normals(v, f):
    tri = v[f]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)


def _face_areas(v, f):
    tri = v[f]
    return 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1
    )


def _connected_components(faces: np.ndarray, face_ids: np.ndarray) -> List[np.ndarray]:
    """Split a face subset into edge-connected components (scipy graph)."""
    sub = faces[face_ids]
    edges = np.sort(
        np.concatenate([sub[:, (0, 1)], sub[:, (1, 2)], sub[:, (2, 0)]], axis=0), axis=1
    )
    ekey = edges[:, 0].astype(np.int64) * (faces.max() + 1) + edges[:, 1]
    order = np.argsort(ekey, kind="stable")
    ekey_s = ekey[order]
    fid_s = np.tile(np.arange(len(sub)), 3)[order]
    # adjacent equal keys -> face-face adjacency
    same = ekey_s[1:] == ekey_s[:-1]
    rows = fid_s[:-1][same]
    cols = fid_s[1:][same]
    n = len(sub)
    g = sp.coo_matrix(
        (np.ones(len(rows) * 2), (np.concatenate([rows, cols]), np.concatenate([cols, rows]))),
        shape=(n, n),
    ).tocsr()
    n_comp, labels = sp.csgraph.connected_components(g, directed=False)
    return [face_ids[labels == c] for c in range(n_comp)]


def _planar_project(v, f_sub, direction_idx):
    u_ax, v_ax = _BOX_AXES[direction_idx]
    used = np.unique(f_sub.reshape(-1))
    remap = np.full(v.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    pts = v[used]
    uv = np.stack([pts @ np.asarray(u_ax, dtype=np.float64),
                   pts @ np.asarray(v_ax, dtype=np.float64)], axis=-1)
    return uv, remap[f_sub], used


def _lscm(v: np.ndarray, faces: np.ndarray, init_uv: np.ndarray) -> np.ndarray:
    """Least-squares conformal map of one chart.

    v [Vc, 3] chart vertices, faces [Fc, 3] local indices, init_uv [Vc, 2]
    initial guess (used to pick the two pinned vertices and to keep the
    orientation).  Returns [Vc, 2].
    """
    Vc = len(v)
    Fc = len(faces)
    if Fc == 0 or Vc < 3:
        return init_uv
    # local orthonormal frame per triangle
    tri = v[faces]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = np.cross(e1, e2)
    n_len = np.maximum(np.linalg.norm(n, axis=-1), 1e-20)
    x_ax = e1 / np.maximum(np.linalg.norm(e1, axis=-1, keepdims=True), 1e-20)
    y_ax = np.cross(n / n_len[:, None], x_ax)
    # 2D coords of the 3 corners in the triangle plane
    x1 = np.zeros(Fc)
    y1 = np.zeros(Fc)
    x2 = np.einsum("fi,fi->f", e1, x_ax)
    y2 = np.zeros(Fc)
    x3 = np.einsum("fi,fi->f", e2, x_ax)
    y3 = np.einsum("fi,fi->f", e2, y_ax)
    dT = np.maximum((x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1), 1e-20)
    sqrt_dT = np.sqrt(dT)
    # gradients (conformal energy):  W real/imag parts per corner
    wr = np.stack([x3 - x2, x1 - x3, x2 - x1], axis=1) / sqrt_dT[:, None]
    wi = np.stack([y3 - y2, y1 - y3, y2 - y1], axis=1) / sqrt_dT[:, None]

    # pin the two vertices farthest apart in the init parameterization
    p0 = int(np.argmin(init_uv[:, 0] + init_uv[:, 1]))
    p1 = int(np.argmax(init_uv[:, 0] + init_uv[:, 1]))
    if p0 == p1:
        return init_uv
    pinned = np.asarray([p0, p1])
    pin_uv = init_uv[pinned]

    free = np.setdiff1d(np.arange(Vc), pinned)
    col_of = np.full(Vc, -1, dtype=np.int64)
    col_of[free] = np.arange(len(free))

    rows, cols, vals_r, vals_i = [], [], [], []
    b = np.zeros(2 * Fc)
    for corner in range(3):
        vid = faces[:, corner]
        isfree = col_of[vid] >= 0
        fi = np.arange(Fc)
        # free columns
        rows.extend(fi[isfree])
        cols.extend(col_of[vid[isfree]])
        vals_r.extend(wr[isfree, corner])
        vals_i.extend(wi[isfree, corner])
        # pinned contribute to b
        pidx = ~isfree
        if pidx.any():
            which = (vid[pidx][:, None] == pinned[None, :]).argmax(axis=1)
            u_p = pin_uv[which, 0]
            v_p = pin_uv[which, 1]
            wr_p = wr[pidx, corner]
            wi_p = wi[pidx, corner]
            b[fi[pidx]] -= wr_p * u_p - wi_p * v_p
            b[Fc + fi[pidx]] -= wi_p * u_p + wr_p * v_p

    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals_r = np.asarray(vals_r)
    vals_i = np.asarray(vals_i)
    nf = len(free)
    # A = [[Wr, -Wi], [Wi, Wr]] acting on [u_free; v_free]
    A = sp.coo_matrix(
        (
            np.concatenate([vals_r, -vals_i, vals_i, vals_r]),
            (
                np.concatenate([rows, rows, Fc + rows, Fc + rows]),
                np.concatenate([cols, nf + cols, cols, nf + cols]),
            ),
        ),
        shape=(2 * Fc, 2 * nf),
    ).tocsr()
    # direct solve of the normal equations: the LSCM system is small per
    # chart (hundreds-to-thousands of free vertices) and Laplacian-like,
    # so one sparse LU beats LSQR's ~600 matvec iterations — measured
    # 2.9 s -> 0.2 s for the 18-chart trefoil unwrap on the single host
    # core (the serving critical path, PROFILE_preprocess).  LSQR stays as
    # the fallback for a singular/ill-conditioned A^T A.
    try:
        AtA = (A.T @ A).tocsc()
        sol = spla.spsolve(AtA, A.T @ b)
    except Exception:
        sol = None
    if sol is None or not np.isfinite(np.asarray(sol)).all():
        sol = spla.lsqr(A, b, atol=1e-10, btol=1e-10, iter_lim=2000)[0]
    uv = init_uv.copy()
    uv[free, 0] = sol[:nf]
    uv[free, 1] = sol[nf:]
    if not np.isfinite(uv).all():
        return init_uv
    return uv


def unwrap_atlas(
    mesh: HostMesh,
    size: int = 2048,
    gutter: int = 4,
    use_lscm: bool = True,
    max_chart_faces: int = 50_000,
) -> HostMesh:
    """Unwrap a mesh into a packed UV atlas (capability of
    ``compute_uvatlas(size=2048, gutter=4, max_stretch=1/6)``, uv_atlas.py:83-115).

    Returns a mesh with seam-split ``uv``/``faces_uv`` in [0, 1], v-up.
    """
    v = mesh.vertices.astype(np.float64)
    f = mesh.faces.astype(np.int64)
    fn = _face_normals(v, f)
    areas = _face_areas(v, f)

    # 1. assign each face to its dominant box direction
    sim = fn @ _BOX_DIRS.T
    bin_of = np.argmax(sim, axis=1)

    # 2. split bins into connected components -> charts
    charts: List[Tuple[np.ndarray, int]] = []
    for b in range(6):
        ids = np.nonzero(bin_of == b)[0]
        if len(ids) == 0:
            continue
        for comp in _connected_components(f, ids):
            # bound chart size for solver stability
            for start in range(0, len(comp), max_chart_faces):
                charts.append((comp[start: start + max_chart_faces], b))

    # 3. parameterize each chart
    chart_uvs = []       # local uv per chart [Vc, 2]
    chart_faces = []     # local faces [Fc, 3]
    chart_verts = []     # global vertex ids [Vc]
    chart_area3d = []
    for face_ids, b in charts:
        f_sub = f[face_ids]
        uv, f_local, used = _planar_project(v, f_sub, b)
        if use_lscm and len(used) >= 4 and len(face_ids) >= 2:
            uv = _lscm(v[used], f_local, uv)
        chart_uvs.append(uv)
        chart_faces.append(f_local)
        chart_verts.append(used)
        chart_area3d.append(float(areas[face_ids].sum()))

    # 4. uniform texel density: scale each chart so uv area ~ 3d area
    for i, uv in enumerate(chart_uvs):
        tri = uv[chart_faces[i]]
        e1 = tri[:, 1] - tri[:, 0]
        e2 = tri[:, 2] - tri[:, 0]
        uv_area = float(np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).sum() * 0.5)
        target = chart_area3d[i]
        if uv_area > 1e-12 and target > 1e-12:
            uv *= np.sqrt(target / uv_area)
        uv -= uv.min(axis=0, keepdims=True)
        chart_uvs[i] = uv

    # 5. shelf-pack charts into a square of side S (world units), then
    # normalize to [0,1] with gutter pixels of margin
    sizes = np.asarray(
        [uv.max(axis=0) if len(uv) else np.zeros(2) for uv in chart_uvs]
    )
    total_area = float((sizes[:, 0] * sizes[:, 1]).sum()) if len(sizes) else 1.0
    side = np.sqrt(max(total_area, 1e-12)) * 1.1
    margin_frac = gutter / size
    placements = np.zeros((len(chart_uvs), 2))
    for _attempt in range(8):
        margin = side * margin_frac / max(1e-12, 1.0)
        order = np.argsort(-sizes[:, 1])  # tallest first
        x = y = shelf_h = 0.0
        ok = True
        for ci in order:
            w, h = sizes[ci] + margin
            if x + w > side:
                x = 0.0
                y += shelf_h
                shelf_h = 0.0
            if y + h > side or w > side:
                ok = False
                break
            placements[ci] = (x, y)
            x += w
            shelf_h = max(shelf_h, h)
        if ok:
            break
        side *= 1.15
    # normalize into [0,1]
    uv_tables = []
    faces_uv = np.zeros_like(f)
    offset = 0
    order_map = {}
    for ci, (face_ids, _b) in enumerate(charts):
        uv = (chart_uvs[ci] + placements[ci] + side * margin_frac * 0.5) / side
        uv_tables.append(uv)
        faces_uv[face_ids] = chart_faces[ci] + offset
        offset += len(uv)
    uv_all = np.concatenate(uv_tables, axis=0) if uv_tables else np.zeros((0, 2))
    return HostMesh(
        mesh.vertices,
        mesh.faces,
        uv=np.clip(uv_all, 0.0, 1.0).astype(np.float32),
        faces_uv=faces_uv.astype(np.int32),
        normals=mesh.normals,
        vertex_colors=mesh.vertex_colors,
        texture=mesh.texture,
    )


def preprocess_blank_mesh(
    mesh: HostMesh,
    min_faces: int = 20_000,
    max_faces: int = 200_000,
    uv_size: int = 2048,
    gutter: int = 4,
) -> HostMesh:
    """Full ``preprocess_blank_mesh`` equivalent (uv_atlas.py:177-194):
    geometry cleanup/budget + UV unwrap."""
    from .process import preprocess_blank_mesh_geometry

    mesh = preprocess_blank_mesh_geometry(mesh, min_faces=min_faces, max_faces=max_faces)
    return unwrap_atlas(mesh, size=uv_size, gutter=gutter)
