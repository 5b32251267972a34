"""Triangle-mesh topology queries: boundaries, mask morphology, UV seams
(port of unitex_tpu/geometry/topology.py, a numpy copy that gives the
same arrays bit for bit).

Find boundary vertices, grow or shrink face selections over the
adjacency graph, and extract the UV-seam submesh: the directed face edges
that are boundaries in texture space but interior in position space,
optionally pairing the two faces across each seam and mirroring their
dual texture vertices across the seam edge (for seam-aware texture
continuation).  Host-side numpy: these are data-dependent
``unique``/sort queries of mesh preprocessing; the device-side erosion
is :func:`unitex_torch.geometry.mesh.erode_face_mask`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _half_edges(faces: np.ndarray) -> np.ndarray:
    """Directed ccw half-edge triples [3F, 3]: two edge vertices + the dual
    (opposite) vertex of the owning face."""
    return np.concatenate(
        [faces[:, (0, 1, 2)], faces[:, (1, 2, 0)], faces[:, (2, 0, 1)]], axis=0
    )


def _unique_edges(half_edges: np.ndarray):
    """-> (unique sorted edges [E, 2], half-edge -> edge id [3F], counts [E])."""
    ekey = np.sort(half_edges[:, :2], axis=1)
    edges, inverse, counts = np.unique(
        ekey, axis=0, return_inverse=True, return_counts=True
    )
    return edges, inverse.reshape(-1), counts


def unique_edges(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges [E, 2] (vertex-sorted): the input of the
    edge-Laplacian smoothing and loss (geometry.mesh.laplacian_smooth)."""
    edges, _, _ = _unique_edges(_half_edges(np.asarray(faces, np.int64)))
    return edges.astype(np.int32)


def get_boundary(faces: np.ndarray) -> np.ndarray:
    """Vertex indices on open boundaries: edges referenced by exactly one
    face."""
    edges, _, counts = _unique_edges(_half_edges(np.asarray(faces, np.int64)))
    return np.unique(edges[counts == 1].reshape(-1))


def dilate_face_mask(
    faces: np.ndarray, face_mask: np.ndarray, n_vertices: int, rings: int = 1
) -> np.ndarray:
    """Grow a face selection by ``rings`` vertex-adjacency rings:
    a face joins if ANY of its vertices touches a
    selected face."""
    mask = np.asarray(face_mask, bool).copy()
    f = np.asarray(faces, np.int64)
    for _ in range(rings):
        touched = np.zeros((n_vertices,), bool)
        touched[f[mask].reshape(-1)] = True
        mask = touched[f].any(axis=-1)
    return mask


def erode_face_mask(
    faces: np.ndarray, face_mask: np.ndarray, n_vertices: int, rings: int = 1
) -> np.ndarray:
    """Shrink a selection: the dual of dilation."""
    return ~dilate_face_mask(faces, ~np.asarray(face_mask, bool), n_vertices, rings)


def dilate_erode_face_mask(
    faces: np.ndarray, face_mask: np.ndarray, n_vertices: int, rings: int = 1
) -> np.ndarray:
    """Morphological closing then opening:
    dilate(d) -> erode(2d) -> dilate(d), removing pinholes and spurs."""
    m = dilate_face_mask(faces, face_mask, n_vertices, rings)
    m = erode_face_mask(faces, m, n_vertices, 2 * rings)
    return dilate_face_mask(faces, m, n_vertices, rings)


def get_boundary_tex(
    faces_pos: np.ndarray, faces_uv: np.ndarray, paired: bool = False
):
    """UV-seam query.

    A seam half-edge is a texture-space boundary (its uv edge has one
    incident face) whose position-space edge is interior (two incident
    faces).

    ``paired=False`` -> (seam pos-vertex ids, seam uv-vertex ids, faces
    touching any seam vertex as [F_s, 3] pos indices, same faces' [F_s, 3]
    uv indices).

    ``paired=True`` -> (seam pos-vertex ids, seam uv-vertex ids,
    pos ccw triples [E_s, 2, 3], uv ccw triples [E_s, 2, 3]) where group 0
    is the seam half-edge's own face and group 1 the partner face across the
    position edge — both triples ordered (edge v1, edge v2, dual vertex).
    """
    fp = np.asarray(faces_pos, np.int64)
    ft = np.asarray(faces_uv, np.int64)
    he_pos = _half_edges(fp)
    he_tex = _half_edges(ft)
    _, inv_pos, cnt_pos = _unique_edges(he_pos)
    _, inv_tex, cnt_tex = _unique_edges(he_tex)
    sel = (cnt_tex[inv_tex] == 1) & (cnt_pos[inv_pos] != 1)  # [3F]

    v_sel_pos = np.unique(he_pos[sel][:, :2].reshape(-1))
    v_sel_tex = np.unique(he_tex[sel][:, :2].reshape(-1))

    if not paired:
        f_touch = np.isin(fp, v_sel_pos).any(axis=-1)
        return v_sel_pos, v_sel_tex, fp[f_touch], ft[f_touch]

    # partner lookup: for each unique pos edge, its (up to 2) half-edge rows
    order = np.argsort(inv_pos, kind="stable")
    # rows grouped by edge id; counts give group extents
    starts = np.zeros(len(cnt_pos), np.int64)
    starts[1:] = np.cumsum(cnt_pos)[:-1]
    sel_rows = np.nonzero(sel)[0]
    eid = inv_pos[sel_rows]
    # within each selected edge's group, the partner is the other row
    g0 = order[starts[eid]]
    # edges with >2 incident faces are non-manifold; take the second row
    g1 = order[np.minimum(starts[eid] + 1, starts[eid] + cnt_pos[eid] - 1)]
    partner = np.where(g0 == sel_rows, g1, g0)
    triples_pos = np.stack([he_pos[sel_rows], he_pos[partner]], axis=1)
    triples_tex = np.stack([he_tex[sel_rows], he_tex[partner]], axis=1)
    return v_sel_pos, v_sel_tex, triples_pos, triples_tex


def reverse_triangle_2d(
    v1: np.ndarray, v2: np.ndarray, v3: np.ndarray, u1: np.ndarray, u2: np.ndarray
) -> np.ndarray:
    """Transport the dual vertex v3 of triangle (v1, v2, v3) into the chart
    whose seam edge is (u1, u2): a scaled offset from u1."""
    scale = np.linalg.norm(u2 - u1, axis=-1, keepdims=True) / np.maximum(
        np.linalg.norm(v2 - v1, axis=-1, keepdims=True), 1e-20
    )
    return u1 + scale * (v3 - v1)


def reverse_triangle_group_2d(e_v_ccw_sel_tex: np.ndarray) -> np.ndarray:
    """Swap each seam pair's dual vertices across the seam:
    input/output [E_s, 2, 3, 2] uv coordinates."""
    flat = e_v_ccw_sel_tex.reshape(-1, 6, 2)
    v1, v2, v3, u1, u2, u3 = [flat[:, i] for i in range(6)]
    u3r = reverse_triangle_2d(v1, v2, v3, u1, u2)
    v3r = reverse_triangle_2d(u1, u2, u3, v1, v2)
    return np.stack([v1, v2, v3r, u1, u2, u3r], axis=1).reshape(-1, 2, 3, 2)


def get_seams_submesh(
    vertices: np.ndarray,
    faces_pos: np.ndarray,
    uv: np.ndarray,
    faces_uv: np.ndarray,
    reverse: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The seam-adjacent submesh: returns (vertices, seam faces [F_s, 3], uv table, seam faces_uv).  With
    ``reverse=True`` the paired dual uv vertices are mirrored across the
    seam (reverse_triangle_group_2d), yielding uv triangles that continue
    each chart past its seam — note the mirrored coordinates are written to
    a COPY of the uv table."""
    uv = np.asarray(uv, np.float32).copy()
    v_sel_pos, v_sel_tex, tri_pos, tri_tex = get_boundary_tex(
        faces_pos, faces_uv, paired=reverse
    )
    if reverse:
        coords = uv[tri_tex]  # [E_s, 2, 3, 2]
        uv_flat_idx = tri_tex.reshape(-1)
        uv_flat = reverse_triangle_group_2d(coords).reshape(-1, 2)
        uv[uv_flat_idx] = uv_flat
        return (
            np.asarray(vertices, np.float32),
            tri_pos.reshape(-1, 3),
            uv,
            tri_tex.reshape(-1, 3),
        )
    return np.asarray(vertices, np.float32), tri_pos, uv, tri_tex
