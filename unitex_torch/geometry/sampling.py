"""Point-cloud sampling: surface, sharp-edge and farthest-point sampling
(port of unitex_tpu/geometry/sampling.py).

The reference's geometry sampling samples area-weighted surface points
and sharp-edge points (dihedral angle > 15°, equal steps along edges),
then reduces each set by farthest-point sampling.  Everything here runs
on the host in numpy and gives the JAX package's arrays bit for bit,
except ``sample_spatial`` and ``sample_near_surface``, whose re-projection
onto the surface runs on the device (``ops/closest_point.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .io.mesh_io import HostMesh


def sample_surface(
    mesh: HostMesh, n_samples: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted surface samples -> (points [N, 3], normals [N, 3])."""
    rng = np.random.default_rng(seed)
    v = mesh.vertices.astype(np.float64)
    f = mesh.faces.astype(np.int64)
    tri = v[f]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    areas = 0.5 * np.linalg.norm(n, axis=-1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh: zero surface area")
    probs = areas / total
    face_idx = rng.choice(len(f), size=n_samples, p=probs)
    r1 = np.sqrt(rng.uniform(size=n_samples))
    r2 = rng.uniform(size=n_samples)
    a = 1.0 - r1
    b = r1 * (1.0 - r2)
    c = r1 * r2
    pts = (
        tri[face_idx, 0] * a[:, None]
        + tri[face_idx, 1] * b[:, None]
        + tri[face_idx, 2] * c[:, None]
    )
    normals = n[face_idx] / np.maximum(
        np.linalg.norm(n[face_idx], axis=-1, keepdims=True), 1e-20
    )
    return pts.astype(np.float32), normals.astype(np.float32)


def find_sharp_edges(
    mesh: HostMesh, angle_threshold_deg: float = 15.0
) -> np.ndarray:
    """Edges whose two incident faces meet at a dihedral angle above the
    threshold.  Returns [E, 2] vertex indices."""
    v = mesh.vertices.astype(np.float64)
    f = mesh.faces.astype(np.int64)
    tri = v[f]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)

    edges = np.concatenate([f[:, (0, 1)], f[:, (1, 2)], f[:, (2, 0)]], axis=0)
    ekey = np.sort(edges, axis=1)
    face_of = np.tile(np.arange(len(f)), 3)
    order = np.lexsort((ekey[:, 1], ekey[:, 0]))
    ekey_s = ekey[order]
    face_s = face_of[order]
    same = (ekey_s[1:] == ekey_s[:-1]).all(axis=1)
    fa = face_s[:-1][same]
    fb = face_s[1:][same]
    cos = np.einsum("ij,ij->i", fn[fa], fn[fb])
    sharp = cos < np.cos(np.radians(angle_threshold_deg))
    return ekey_s[:-1][same][sharp]


def sample_sharp_edges(
    mesh: HostMesh,
    n_samples: int,
    angle_threshold_deg: float = 15.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Equal-arc-length samples along sharp edges.  Returns (points [N, 3],
    edge direction [N, 3]); N may be 0 for smooth meshes."""
    edges = find_sharp_edges(mesh, angle_threshold_deg)
    if len(edges) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    v = mesh.vertices.astype(np.float64)
    p0 = v[edges[:, 0]]
    p1 = v[edges[:, 1]]
    lengths = np.linalg.norm(p1 - p0, axis=-1)
    total = lengths.sum()
    # equal-step sampling: counts proportional to edge length
    counts = np.maximum(1, np.round(lengths / total * n_samples)).astype(np.int64)
    rng = np.random.default_rng(seed)
    pts, dirs = [], []
    for (a, b), cnt in zip(edges, counts):
        t = (np.arange(cnt) + rng.uniform(size=cnt)) / cnt
        pts.append(v[a][None] * (1 - t[:, None]) + v[b][None] * t[:, None])
        d = v[b] - v[a]
        d = d / max(np.linalg.norm(d), 1e-20)
        dirs.append(np.broadcast_to(d, (cnt, 3)))
    pts = np.concatenate(pts)[:n_samples]
    dirs = np.concatenate(dirs)[:n_samples]
    return pts.astype(np.float32), dirs.astype(np.float32)


def sample_surface_with_faces(
    mesh: HostMesh, n_samples: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Area-weighted surface samples with provenance: points [N, 3], face
    index [N], barycentric uvw [N, 3]."""
    rng = np.random.default_rng(seed)
    v = mesh.vertices.astype(np.float64)
    f = mesh.faces.astype(np.int64)
    tri = v[f]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    areas = 0.5 * np.linalg.norm(n, axis=-1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh: zero surface area")
    face_idx = rng.choice(len(f), size=n_samples, p=areas / total)
    r1 = np.sqrt(rng.uniform(size=n_samples))
    r2 = rng.uniform(size=n_samples)
    uvw = np.stack([1.0 - r1, r1 * (1.0 - r2), r1 * r2], axis=-1)
    pts = np.einsum("nkc,nk->nc", tri[face_idx], uvw)
    return pts.astype(np.float32), face_idx, uvw.astype(np.float32)


def _project(samples: np.ndarray, mesh: HostMesh, exact: bool, device):
    """(face_index [N] int64, face_uvw [N, 3] f32) of each sample's closest
    surface point, found on ``device``."""
    import torch

    from ..ops.closest_point import closest_point_on_mesh

    cp = closest_point_on_mesh(
        torch.as_tensor(samples, device=device),
        torch.as_tensor(mesh.vertices.astype(np.float32), device=device),
        torch.as_tensor(mesh.faces.astype(np.int64), device=device),
        exact=exact,
    )
    return (cp.face.cpu().numpy().astype(np.int64),
            cp.uvw.cpu().numpy().astype(np.float32))


def sample_spatial(
    mesh: HostMesh,
    n_samples: int = 100_000,
    seed: int = 666,
    bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    exact: bool = False,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Uniform samples in the spatial bbox plus their closest-surface
    projection (the reference's cuBVH ``unsigned_distance``; here
    ``ops/closest_point.py`` on ``device``).  Returns (samples [N, 3],
    face_index [N], face_uvw [N, 3])."""
    rng = np.random.default_rng(seed)
    if bounds is None:
        lo = mesh.vertices.min(axis=0)
        hi = mesh.vertices.max(axis=0)
    else:
        lo, hi = bounds
    samples = rng.uniform(size=(n_samples, 3)).astype(np.float32) * (hi - lo) + lo
    return (samples, *_project(samples, mesh, exact, device))


def sample_near_surface(
    mesh: HostMesh,
    n_samples: int = 100_000,
    seed: int = 666,
    distance_threshold: float = 1.0,
    depth: int = 8,
    exact: bool = False,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Surface samples perturbed along the interpolated vertex normal by a
    uniform offset in ±``distance_threshold * 2/2**depth``, re-projected to
    the surface on ``device``.  Returns (samples [N, 3], face_index [N],
    face_uvw [N, 3])."""
    # independent child streams: the face-selection draws and the normal
    # offsets must not be correlated
    s_faces, s_deltas = np.random.SeedSequence(seed).spawn(2)
    rng = np.random.default_rng(s_deltas)
    offset = distance_threshold * (2.0 / (2.0 ** depth))
    v = mesh.vertices.astype(np.float64)
    f = mesh.faces.astype(np.int64)
    tri = v[f]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    # uniform (not area-weighted) accumulation of normalized face normals
    vn = np.zeros((len(v), 3))
    np.add.at(vn, f.reshape(-1), np.repeat(fn, 3, axis=0))
    vn = vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-20)

    pts, face_idx, uvw = sample_surface_with_faces(mesh, n_samples, seed=s_faces)
    sn = np.einsum("nkc,nk->nc", vn[f[face_idx]], uvw)
    deltas = rng.uniform(-1.0, 1.0, size=(n_samples, 3))
    samples = (pts + offset * deltas * sn).astype(np.float32)
    return (samples, *_project(samples, mesh, exact, device))


def sample_pbr_mesh(pbr_mesh, n_samples: int = 100_000, seed: int = 666):
    """Surface samples carrying interpolated PBR attributes: not ported.
    It needs the PBR mesh of ``texture/pbr.py`` and
    ``geometry/mesh.sample_pbr_attribute``, which come with the texturing
    tools (ROADMAP Queue A, A17a)."""
    raise NotImplementedError(
        "sample_pbr_mesh is not ported: it needs texture/pbr.py and "
        "geometry/mesh.sample_pbr_attribute (ROADMAP A17a)")


def fps(points: np.ndarray, k: int, start: int = 0) -> np.ndarray:
    """Farthest point sampling indices (native C++ kernel, numpy fallback)."""
    from ..native import meshproc

    return meshproc.farthest_point_sampling(points, k, start)


def geometry_sampling(
    mesh: HostMesh,
    n_samples: int = 200_000,
    n_fps: int = 32_768,
    sharp_angle_deg: float = 15.0,
    seed: int = 0,
    timeout_s: float = 60.0,
) -> dict:
    """Sample surface and sharp edges, drop non-finite points, FPS each to
    ``n_fps``; a hard host-time cap like the reference's @timeout(60)."""
    from ..utils.timer import timeout

    return timeout(timeout_s)(_geometry_sampling)(
        mesh, n_samples, n_fps, sharp_angle_deg, seed
    )


def _geometry_sampling(mesh, n_samples, n_fps, sharp_angle_deg, seed) -> dict:
    surf_pts, surf_nrm = sample_surface(mesh, n_samples, seed)
    edge_pts, edge_dir = sample_sharp_edges(mesh, n_samples, sharp_angle_deg, seed)

    def scrub(p, extra):
        ok = np.isfinite(p).all(axis=1)
        return p[ok], extra[ok]

    surf_pts, surf_nrm = scrub(surf_pts, surf_nrm)
    out = {}
    idx = fps(surf_pts, n_fps)
    out["surface_points"] = surf_pts[idx]
    out["surface_normals"] = surf_nrm[idx]
    if len(edge_pts):
        edge_pts, edge_dir = scrub(edge_pts, edge_dir)
        idx_e = fps(edge_pts, min(n_fps, len(edge_pts)))
        out["sharp_points"] = edge_pts[idx_e]
        out["sharp_directions"] = edge_dir[idx_e]
    else:
        out["sharp_points"] = np.zeros((0, 3), np.float32)
        out["sharp_directions"] = np.zeros((0, 3), np.float32)
    return out
