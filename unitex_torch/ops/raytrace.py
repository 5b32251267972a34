"""Ray-mesh intersection: brute-force Möller–Trumbore with a running
closest hit (port of unitex_tpu/ops/raytrace.py).

:func:`ray_triangle_intersect` tiles the work into ray chunks x face
chunks: each tile evaluates every (ray, face) pair at once and keeps the
nearest hit, which replaces a ray's best only when it is strictly nearer.
So the lowest face index wins a tie, inside a chunk (the first minimum)
and across chunks (the earlier chunk), and the triangle ids are the JAX
package's as integers.  O(rays x faces), plain PyTorch (the JAX package
leaves it to XLA); the texturing path's visibility never needs it, it
compares rasterized depths instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RayHits(NamedTuple):
    """Closest-hit results: hit mask [N], front-face mask [N], triangle id
    [N] (-1 = miss), location [N, 3], barycentric uv [N, 2], distance [N]
    (inf on a miss)."""

    hit: torch.Tensor
    front: torch.Tensor
    tri: torch.Tensor
    loc: torch.Tensor
    uv: torch.Tensor
    t: torch.Tensor


@torch.no_grad()
def ray_triangle_intersect(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    vertices: torch.Tensor,
    faces: torch.Tensor,
    ray_chunk: int = 8192,
    face_chunk: int = 2048,
    eps: float = 1e-9,
) -> RayHits:
    """Closest-hit Möller–Trumbore: rays_o / rays_d [N, 3], vertices
    [V, 3], faces [F, 3] -> RayHits.  Double-sided; ``front`` says whether
    the ray met the face's counter-clockwise side.  f32 throughout,
    ``eps`` bounding |det| as in the JAX package."""
    N, F = rays_o.shape[0], faces.shape[0]
    dev = rays_o.device
    tri = vertices[faces.long()]
    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    inf = torch.tensor(float("inf"), device=dev)
    t_out = torch.full((N,), float("inf"), device=dev)
    tri_out = torch.full((N,), -1, dtype=torch.int64, device=dev)
    u_out = torch.zeros(N, device=dev)
    v_out = torch.zeros(N, device=dev)
    sgn_out = torch.zeros(N, device=dev)
    for r0 in range(0, N, ray_chunk):
        ro = rays_o[r0:r0 + ray_chunk, None, :]
        rd = rays_d[r0:r0 + ray_chunk, None, :]
        bt, btri = t_out[r0:r0 + ray_chunk], tri_out[r0:r0 + ray_chunk]
        bu, bv = u_out[r0:r0 + ray_chunk], v_out[r0:r0 + ray_chunk]
        bsgn = sgn_out[r0:r0 + ray_chunk]
        rows = torch.arange(ro.shape[0], device=dev)
        for f0 in range(0, F, face_chunk):
            fv0, fe1, fe2 = (x[None, f0:f0 + face_chunk] for x in (v0, e1, e2))
            pvec = torch.linalg.cross(rd.expand(-1, fe2.shape[1], -1),
                                      fe2.expand(rd.shape[0], -1, -1), dim=-1)
            det = torch.sum(pvec * fe1, dim=-1)
            det_ok = torch.abs(det) > eps
            inv_det = torch.where(det_ok, 1.0 / det, torch.zeros_like(det))
            tvec = ro - fv0
            u = torch.sum(tvec * pvec, dim=-1) * inv_det
            qvec = torch.linalg.cross(tvec, fe1.expand_as(tvec), dim=-1)
            v = torch.sum(qvec * rd, dim=-1) * inv_det
            t = torch.sum(fe2 * qvec, dim=-1) * inv_det
            ok = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-6)
            t_m = torch.where(ok, t, inf)
            best = torch.argmin(t_m, dim=1)   # the first face of a tie
            tb = t_m[rows, best]
            better = tb < bt
            bt.copy_(torch.where(better, tb, bt))
            btri.copy_(torch.where(better, best + f0, btri))
            bu.copy_(torch.where(better, u[rows, best], bu))
            bv.copy_(torch.where(better, v[rows, best], bv))
            bsgn.copy_(torch.where(better, torch.sign(det[rows, best]), bsgn))
    hit = tri_out >= 0
    loc = rays_o + rays_d * torch.where(hit, t_out, torch.zeros_like(t_out))[:, None]
    return RayHits(hit=hit, front=sgn_out > 0, tri=tri_out, loc=loc,
                   uv=torch.stack([u_out, v_out], dim=-1),
                   t=torch.where(hit, t_out, inf))
