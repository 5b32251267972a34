"""Closest point on a mesh: unsigned distance, face index and barycentrics
(port of unitex_tpu/ops/closest_point.py).

The reference answers this with a BVH walk (cuBVH ``unsigned_distance``).
As in the JAX package, the search has two modes:

1. candidate faces per query by a centroid KNN (``ops/knn.knn``, k <= 8),
   then the exact point-triangle closest point on the k candidates;
2. ``exact=True``: a running best over every face, chunk by chunk.

The point-triangle closest point is Ericson's seven Voronoi regions
(Real-Time Collision Detection §5.1.5) as a ``torch.where`` cascade.  A
numpy reference of another formulation (each edge segment and vertex
checked explicitly) cross-checks the math in the tests.  Products are f32
without TF32.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.precision import exact_f32


class ClosestPoint(NamedTuple):
    """distance [N], face index [N] int64, barycentric uvw [N, 3] (weights
    of face vertices 0/1/2), projected point [N, 3]."""

    distance: torch.Tensor
    face: torch.Tensor
    uvw: torch.Tensor
    point: torch.Tensor


def closest_point_triangle(
    p: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest point on triangle (a, b, c) to p; inputs broadcastable
    [..., 3].  Returns (uvw [..., 3], squared distance [...]); of the
    Voronoi-region cases the first that holds wins."""
    ab = b - a
    ac = c - a
    ap = p - a

    def dot(x, y):
        return torch.sum(x * y, dim=-1)

    d1 = dot(ab, ap)
    d2 = dot(ac, ap)
    bp = p - b
    d3 = dot(ab, bp)
    d4 = dot(ac, bp)
    cp = p - c
    d5 = dot(ab, cp)
    d6 = dot(ac, cp)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    def safe_div(n, d):
        return n / torch.where(torch.abs(d) > 1e-30, d, torch.ones_like(d))

    v_ab = safe_div(d1, d1 - d3)
    w_ac = safe_div(d2, d2 - d6)
    w_bc = safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    denom = safe_div(torch.ones_like(va), va + vb + vc)
    v_in = vb * denom
    w_in = vc * denom

    conds = [
        (d1 <= 0.0) & (d2 <= 0.0),                           # vertex A
        (d3 >= 0.0) & (d4 <= d3),                            # vertex B
        (d6 >= 0.0) & (d5 <= d6),                            # vertex C
        (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0),             # edge AB
        (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0),             # edge AC
        (va <= 0.0) & (d4 - d3 >= 0.0) & (d5 - d6 >= 0.0),  # edge BC
    ]
    zeros = torch.zeros_like(d1)
    ones = torch.ones_like(d1)
    u_cases = [ones, zeros, zeros, 1.0 - v_ab, 1.0 - w_ac, zeros]
    v_cases = [zeros, ones, zeros, v_ab, zeros, 1.0 - w_bc]
    w_cases = [zeros, zeros, ones, zeros, w_ac, w_bc]

    def select(cases, default):
        # jnp.select: the first true condition wins, so apply them last
        # to first
        out = default
        for cond, val in zip(reversed(conds), reversed(cases)):
            out = torch.where(cond, val, out)
        return out

    u = select(u_cases, 1.0 - v_in - w_in)
    v = select(v_cases, v_in)
    w = select(w_cases, w_in)
    uvw = torch.stack([u, v, w], dim=-1)
    q = a * u[..., None] + b * v[..., None] + c * w[..., None]
    d2q = dot(p - q, p - q)
    return uvw, d2q


@torch.no_grad()
@exact_f32()
def closest_point_on_mesh(
    points: torch.Tensor,
    vertices: torch.Tensor,
    faces: torch.Tensor,
    k: int = 8,
    chunk: int = 8192,
    exact: bool = False,
    face_chunk: int = 2048,
) -> ClosestPoint:
    """points [N, 3], vertices [V, 3], faces [F, 3] -> ClosestPoint.

    ``exact=False``: the centroid KNN's ``k`` candidate faces, then the
    exact distance on them.  ``exact=True``: a running best over all faces
    in ``face_chunk`` slices (O(N·F), guaranteed); ties keep the lower
    face index.  Queries go in ``chunk``-row slices."""
    faces = faces.long()
    tri = vertices[faces].float()                                 # [F, 3, 3]
    pts = points.float()
    N, F = pts.shape[0], faces.shape[0]
    d2 = torch.empty((N,), dtype=torch.float32, device=pts.device)
    face = torch.empty((N,), dtype=torch.long, device=pts.device)
    uvw = torch.empty((N, 3), dtype=torch.float32, device=pts.device)

    if exact:
        for q0 in range(0, N, chunk):
            p_c = pts[q0:q0 + chunk]
            rows = torch.arange(p_c.shape[0], device=pts.device)
            bd2 = torch.full((p_c.shape[0],), float("inf"), device=pts.device)
            bface = torch.full((p_c.shape[0],), -1, dtype=torch.long,
                               device=pts.device)
            buvw = torch.zeros((p_c.shape[0], 3), device=pts.device)
            for f0 in range(0, F, face_chunk):
                t = tri[f0:f0 + face_chunk]
                uvw_c, d2_c = closest_point_triangle(
                    p_c[:, None, :], t[None, :, 0], t[None, :, 1], t[None, :, 2])
                best = torch.argmin(d2_c, dim=1)
                db = d2_c[rows, best]
                better = db < bd2
                bd2 = torch.where(better, db, bd2)
                bface = torch.where(better, f0 + best, bface)
                buvw = torch.where(better[:, None], uvw_c[rows, best], buvw)
            d2[q0:q0 + chunk], face[q0:q0 + chunk] = bd2, bface
            uvw[q0:q0 + chunk] = buvw
    else:
        from .knn import knn

        centroids = tri.mean(dim=1)                               # [F, 3]
        _, cand = knn(pts, centroids, k=min(k, F), chunk=chunk)   # [N, k]
        for q0 in range(0, N, chunk):
            c_c = cand[q0:q0 + chunk]
            tc = tri[c_c]                                         # [c, k, 3, 3]
            uvw_k, d2_k = closest_point_triangle(
                pts[q0:q0 + chunk, None, :], tc[..., 0, :], tc[..., 1, :],
                tc[..., 2, :])
            best = torch.argmin(d2_k, dim=1)
            rows = torch.arange(c_c.shape[0], device=pts.device)
            d2[q0:q0 + chunk] = d2_k[rows, best]
            face[q0:q0 + chunk] = c_c[rows, best]
            uvw[q0:q0 + chunk] = uvw_k[rows, best]

    proj = torch.einsum("nkc,nk->nc", vertices[faces[face]].float(), uvw)
    return ClosestPoint(torch.sqrt(torch.clamp(d2, min=0.0)), face, uvw, proj)


def closest_point_on_mesh_ref(
    points: np.ndarray, vertices: np.ndarray, faces: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact numpy reference (brute force over all faces, each clamped by
    per-edge projections) for the tests.  Returns (distance [N], face [N],
    uvw [N, 3])."""
    tri = vertices[faces].astype(np.float64)  # [F, 3, 3]
    N = len(points)
    F = len(faces)
    dist = np.full((N,), np.inf)
    face = np.full((N,), -1, np.int64)
    uvw = np.zeros((N, 3))
    for fi in range(F):
        a, b, c = tri[fi]
        q, bary = _closest_point_triangle_np(points.astype(np.float64), a, b, c)
        d = np.linalg.norm(points - q, axis=-1)
        better = d < dist
        dist[better] = d[better]
        face[better] = fi
        uvw[better] = bary[better]
    return dist, face.astype(np.int32), uvw


def _closest_point_triangle_np(p, a, b, c):
    """Closest point of batched points on one triangle: the unconstrained
    barycentric solution if inside, else the best of the three edge
    segments (another formulation than the Voronoi cascade above)."""

    def seg(p, s0, s1):
        d = s1 - s0
        t = np.clip(((p - s0) @ d) / max(float(d @ d), 1e-30), 0.0, 1.0)
        return s0 + t[:, None] * d, t

    # unconstrained barycentric via normal equations
    e0 = b - a
    e1 = c - a
    g = np.array([[e0 @ e0, e0 @ e1], [e0 @ e1, e1 @ e1]])
    rhs = np.stack([(p - a) @ e0, (p - a) @ e1], axis=-1)  # [N, 2]
    try:
        sol = rhs @ np.linalg.inv(g).T
    except np.linalg.LinAlgError:
        sol = np.zeros_like(rhs)
    v, w = sol[:, 0], sol[:, 1]
    inside = (v >= 0) & (w >= 0) & (v + w <= 1)

    candidates = []
    barys = []
    q_in = a + v[:, None] * e0 + w[:, None] * e1
    candidates.append(np.where(inside[:, None], q_in, np.inf))
    barys.append(np.stack([1 - v - w, v, w], axis=-1))
    for (s0, s1, mk) in [
        (a, b, lambda t: np.stack([1 - t, t, np.zeros_like(t)], -1)),
        (a, c, lambda t: np.stack([1 - t, np.zeros_like(t), t], -1)),
        (b, c, lambda t: np.stack([np.zeros_like(t), 1 - t, t], -1)),
    ]:
        q, t = seg(p, s0, s1)
        candidates.append(q)
        barys.append(mk(t))
    d = np.stack([np.linalg.norm(p - q, axis=-1) for q in candidates], axis=-1)
    best = np.argmin(d, axis=-1)
    ridx = np.arange(len(p))
    q = np.stack(candidates, axis=1)[ridx, best]
    bary = np.stack(barys, axis=1)[ridx, best]
    return q, bary
