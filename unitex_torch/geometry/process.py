"""Host-side mesh preprocessing: cleanup, welding, subdivision, decimation.

Replaces the open3d/pymeshlab preprocessing chain of the reference
(TextureTools geometry/uv/uv_atlas.py:40-74): remove non-manifold and
degenerate faces, merge close vertices, loop-subdivide small meshes, and
quadric-decimate large ones into the 20k-200k face budget
(reference pipeline.py:171).

Pure numpy/scipy; decimation dispatches to the C++ native kernel
(unitex_torch/native) when built, with an equivalent numpy implementation as
fallback — the dual-implementation pattern used for all native components.
"""

from __future__ import annotations

import heapq
from typing import Optional, Tuple

import numpy as np

from .io.mesh_io import HostMesh


def merge_close_vertices(mesh: HostMesh, eps: float = 1e-8) -> HostMesh:
    """Weld vertices closer than ``eps`` (grid quantization, like
    open3d merge_close_vertices used at uv_atlas.py:64)."""
    if mesh.n_vertices == 0:
        return mesh
    q = np.round(mesh.vertices / max(eps, 1e-12)).astype(np.int64)
    _, first, inverse = np.unique(q, axis=0, return_index=True, return_inverse=True)
    new_vertices = mesh.vertices[first]
    new_faces = inverse[mesh.faces]
    keep = (
        (new_faces[:, 0] != new_faces[:, 1])
        & (new_faces[:, 1] != new_faces[:, 2])
        & (new_faces[:, 2] != new_faces[:, 0])
    )
    out = HostMesh(new_vertices, new_faces[keep].astype(np.int32))
    if mesh.uv is not None and mesh.faces_uv is not None:
        out.uv = mesh.uv
        out.faces_uv = mesh.faces_uv[keep]
    if mesh.vertex_colors is not None:
        out.vertex_colors = mesh.vertex_colors[first]
    out.texture = mesh.texture
    return out


def remove_degenerate_faces(mesh: HostMesh, area_eps: float = 1e-12) -> HostMesh:
    v = mesh.vertices
    tri = v[mesh.faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area2 = np.linalg.norm(n, axis=-1)
    keep = area2 > area_eps
    out = HostMesh(mesh.vertices, mesh.faces[keep], mesh.uv,
                   mesh.faces_uv[keep] if mesh.faces_uv is not None else None,
                   mesh.normals, mesh.vertex_colors, mesh.texture)
    return out


def remove_unreferenced_vertices(mesh: HostMesh) -> HostMesh:
    """Drop vertices not referenced by any face and reindex
    (geometry/triangle_topology/clean.py:4)."""
    used = np.zeros(mesh.n_vertices, dtype=bool)
    used[mesh.faces.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    out = HostMesh(
        mesh.vertices[used],
        remap[mesh.faces].astype(np.int32),
        mesh.uv,
        mesh.faces_uv,
        mesh.normals[used] if mesh.normals is not None else None,
        mesh.vertex_colors[used] if mesh.vertex_colors is not None else None,
        mesh.texture,
    )
    return out


def normalize_to_unit_cube(mesh: HostMesh, scale: float = 1.0) -> HostMesh:
    """Center + uniform-scale so the bbox fits [-scale, scale]^3
    (uv_atlas.py normalize + pipeline.py:176 geometry_scale 0.95)."""
    vmin = mesh.vertices.min(axis=0)
    vmax = mesh.vertices.max(axis=0)
    center = (vmin + vmax) / 2.0
    extent = max(float((vmax - vmin).max()) / 2.0, 1e-12)
    v = (mesh.vertices - center) / extent * scale
    return HostMesh(v.astype(np.float32), mesh.faces, mesh.uv, mesh.faces_uv,
                    mesh.normals, mesh.vertex_colors, mesh.texture)


def smooth_simple(mesh: HostMesh, iterations: int = 3) -> HostMesh:
    """Simple neighbor-average vertex smoothing — open3d
    ``filter_smooth_simple`` semantics (v' = (v + sum of neighbors) /
    (1 + degree)), which the reference applies for 3 iterations to make the
    smoothed unwrap copy (uv_atlas.py:70, :169).  Connectivity and
    attributes are untouched; only positions move."""
    if mesh.n_vertices == 0 or mesh.faces.size == 0:
        return mesh
    f = mesh.faces.astype(np.int64)
    ekey = np.sort(
        np.concatenate([f[:, (0, 1)], f[:, (1, 2)], f[:, (2, 0)]], axis=0), axis=1
    )
    edges = np.unique(ekey, axis=0)
    e0, e1 = edges[:, 0], edges[:, 1]
    V = mesh.n_vertices
    deg = np.bincount(np.concatenate([e0, e1]), minlength=V).astype(np.float64)
    v = mesh.vertices.astype(np.float64)
    for _ in range(max(iterations, 0)):
        nbr = np.zeros_like(v)
        np.add.at(nbr, e0, v[e1])
        np.add.at(nbr, e1, v[e0])
        v = (v + nbr) / (1.0 + deg)[:, None]
    return HostMesh(v.astype(np.float32), mesh.faces, mesh.uv, mesh.faces_uv,
                    mesh.normals, mesh.vertex_colors, mesh.texture)


def loop_subdivide(mesh: HostMesh, iterations: int = 1) -> HostMesh:
    """Loop subdivision (the reference loop-subdivides meshes under 20k faces
    twice, uv_atlas.py:56-63).  Vectorized numpy; drops UVs (re-unwrapped later)."""
    v = mesh.vertices.astype(np.float64)
    f = mesh.faces.astype(np.int64)
    for _ in range(iterations):
        V = len(v)
        edges = np.concatenate([f[:, (0, 1)], f[:, (1, 2)], f[:, (2, 0)]], axis=0)
        opposite = np.concatenate([f[:, 2], f[:, 0], f[:, 1]], axis=0)
        ekey = np.sort(edges, axis=1)
        uniq, inverse = np.unique(ekey, axis=0, return_inverse=True)
        E = len(uniq)

        # accumulate opposite-vertex sums and counts per undirected edge
        opp_sum = np.zeros((E, 3))
        np.add.at(opp_sum, inverse, v[opposite])
        cnt = np.zeros(E)
        np.add.at(cnt, inverse, 1.0)

        end_sum = v[uniq[:, 0]] + v[uniq[:, 1]]
        interior = cnt >= 2.0
        # interior edges have exactly two incident faces: 3/8 (a+b) + 1/8 (o1+o2);
        # boundary edges use the midpoint rule
        edge_pts = np.where(
            interior[:, None],
            0.375 * end_sum + 0.125 * opp_sum,
            0.5 * end_sum,
        )

        # even (original) vertex update
        deg = np.zeros(V)
        np.add.at(deg, uniq.reshape(-1), 1.0)
        nbr_sum = np.zeros((V, 3))
        np.add.at(nbr_sum, uniq[:, 0], v[uniq[:, 1]])
        np.add.at(nbr_sum, uniq[:, 1], v[uniq[:, 0]])
        n = np.maximum(deg, 3.0)
        beta = np.where(n == 3.0, 3.0 / 16.0, 3.0 / (8.0 * n))
        v_new = v * (1.0 - n * beta)[:, None] + nbr_sum * beta[:, None]

        # boundary (odd-valence treatment): vertices on boundary edges use
        # the 1/8-3/4-1/8 curve rule
        boundary_edge = ~interior
        if boundary_edge.any():
            on_boundary = np.zeros(V, dtype=bool)
            on_boundary[uniq[boundary_edge].reshape(-1)] = True
            bnd_sum = np.zeros((V, 3))
            bnd_cnt = np.zeros(V)
            be = uniq[boundary_edge]
            np.add.at(bnd_sum, be[:, 0], v[be[:, 1]])
            np.add.at(bnd_sum, be[:, 1], v[be[:, 0]])
            np.add.at(bnd_cnt, be.reshape(-1), 1.0)
            curve = 0.75 * v + 0.125 * bnd_sum
            ok = on_boundary & (bnd_cnt == 2.0)
            v_new[ok] = curve[ok]
            v_new[on_boundary & ~ok] = v[on_boundary & ~ok]

        # new faces: each triangle splits into 4
        e_ab = inverse[0 * len(f): 1 * len(f)] + V
        e_bc = inverse[1 * len(f): 2 * len(f)] + V
        e_ca = inverse[2 * len(f): 3 * len(f)] + V
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.concatenate(
            [
                np.stack([a, e_ab, e_ca], axis=1),
                np.stack([b, e_bc, e_ab], axis=1),
                np.stack([c, e_ca, e_bc], axis=1),
                np.stack([e_ab, e_bc, e_ca], axis=1),
            ],
            axis=0,
        )
        v = np.concatenate([v_new, edge_pts], axis=0)
    return HostMesh(v.astype(np.float32), f.astype(np.int32))


# ------------------------------------------------------------- decimation


def _face_quadrics(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Fundamental error quadrics Kp = p p^T per face, p = (n, -n·x0)."""
    tri = v[f]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-20)
    d = -np.einsum("fi,fi->f", n, tri[:, 0])
    p = np.concatenate([n, d[:, None]], axis=1)  # [F, 4]
    return p[:, :, None] * p[:, None, :]         # [F, 4, 4]


def qem_decimate(
    mesh: HostMesh, target_faces: int, use_native: bool = True
) -> HostMesh:
    """Quadric-error-metric edge-collapse decimation (Garland–Heckbert),
    the capability of open3d's simplify_quadric_decimation used at
    uv_atlas.py:56-60.  Dispatches to the C++ kernel when available."""
    if mesh.n_faces <= target_faces:
        return mesh
    if use_native:
        try:
            from ..native import meshproc

            if meshproc.available():
                v, f = meshproc.qem_decimate(mesh.vertices, mesh.faces, target_faces)
                return HostMesh(v, f)
        except ImportError:
            pass
    return _qem_decimate_py(mesh, target_faces)


def _qem_decimate_py(mesh: HostMesh, target_faces: int) -> HostMesh:
    """Reference numpy/heapq implementation (slow above ~50k faces — the
    native path covers production sizes)."""
    v = mesh.vertices.astype(np.float64).copy()
    f = mesh.faces.astype(np.int64).copy()
    V = len(v)
    Kf = _face_quadrics(v, f)
    Q = np.zeros((V, 4, 4))
    for i in range(3):
        np.add.at(Q, f[:, i], Kf)

    # union-find vertex remap
    parent = np.arange(V)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    edges = np.unique(
        np.sort(
            np.concatenate([f[:, (0, 1)], f[:, (1, 2)], f[:, (2, 0)]], axis=0), axis=1
        ),
        axis=0,
    )

    def collapse_cost(a, b):
        Qe = Q[a] + Q[b]
        A = Qe.copy()
        A[3] = [0.0, 0.0, 0.0, 1.0]
        try:
            target = np.linalg.solve(A, np.asarray([0.0, 0.0, 0.0, 1.0]))
        except np.linalg.LinAlgError:
            mid = (v[a] + v[b]) / 2.0
            target = np.asarray([mid[0], mid[1], mid[2], 1.0])
        cost = float(target @ Qe @ target)
        return cost, target[:3]

    heap = []
    version = {}
    for a, b in edges:
        cost, pos = collapse_cost(a, b)
        heap.append((cost, int(a), int(b), 0, 0, tuple(pos)))
    heapq.heapify(heap)
    vert_version = np.zeros(V, dtype=np.int64)

    n_faces = len(f)
    face_alive = np.ones(n_faces, dtype=bool)
    # vertex -> set of face ids
    vf = [[] for _ in range(V)]
    for fi, (a, b, c) in enumerate(f):
        vf[a].append(fi)
        vf[b].append(fi)
        vf[c].append(fi)

    alive_faces = n_faces
    while alive_faces > target_faces and heap:
        cost, a, b, va, vb, pos = heapq.heappop(heap)
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        if vert_version[ra] != va or vert_version[rb] != vb:
            # stale entry: recompute
            c2, p2 = collapse_cost(ra, rb)
            heapq.heappush(
                heap, (c2, ra, rb, int(vert_version[ra]), int(vert_version[rb]), tuple(p2))
            )
            continue
        # collapse rb into ra
        parent[rb] = ra
        v[ra] = np.asarray(pos)
        Q[ra] = Q[ra] + Q[rb]
        vert_version[ra] += 1
        faces_ab = set(vf[ra]) | set(vf[rb])
        new_list = []
        for fi in faces_ab:
            if not face_alive[fi]:
                continue
            tri = [find(x) for x in f[fi]]
            if len(set(tri)) < 3:
                face_alive[fi] = False
                alive_faces -= 1
            else:
                f[fi] = tri
                new_list.append(fi)
        vf[ra] = new_list
        vf[rb] = []
        # push refreshed edges around ra
        neighbors = set()
        for fi in new_list:
            for x in f[fi]:
                rx = find(x)
                if rx != ra:
                    neighbors.add(rx)
        for nb in neighbors:
            c2, p2 = collapse_cost(ra, nb)
            heapq.heappush(
                heap, (c2, int(ra), int(nb), int(vert_version[ra]), int(vert_version[nb]), tuple(p2))
            )

    f_final = np.asarray([[find(x) for x in tri] for tri in f[face_alive]], dtype=np.int64)
    keep = (
        (f_final[:, 0] != f_final[:, 1])
        & (f_final[:, 1] != f_final[:, 2])
        & (f_final[:, 2] != f_final[:, 0])
    )
    f_final = f_final[keep]
    out = HostMesh(v.astype(np.float32), f_final.astype(np.int32))
    return remove_unreferenced_vertices(out)


def preprocess_blank_mesh_geometry(
    mesh: HostMesh,
    min_faces: int = 20_000,
    max_faces: int = 200_000,
    merge_eps: float = 1e-8,
) -> HostMesh:
    """The geometry half of ``preprocess_blank_mesh`` (uv_atlas.py:177-194):
    normalize, clean, decimate/subdivide into budget, weld.  UV unwrapping is
    applied separately (uv_atlas module)."""
    mesh = normalize_to_unit_cube(mesh, scale=1.0)
    mesh = remove_degenerate_faces(mesh)
    mesh = remove_unreferenced_vertices(mesh)
    if mesh.n_faces > max_faces:
        mesh = qem_decimate(mesh, max_faces)
    else:
        while mesh.n_faces < min_faces:
            mesh = loop_subdivide(mesh, 1)
    mesh = merge_close_vertices(mesh, merge_eps)
    mesh = remove_degenerate_faces(mesh)
    mesh = remove_unreferenced_vertices(mesh)
    return mesh
