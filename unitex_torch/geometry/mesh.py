"""Meshes, PBR meshes and point clouds in PyTorch (port of
unitex_tpu/geometry/mesh.py), with the derived quantities as functions:
normals, areas, tangents, the edge Laplacian, face-mask erosion and
barycentric attribute lookups.

Geometry convention ("storage frame"): the front box camera has identity
rotation and sits at +z.  UVs: u right, v up in [0, 1]; ``faces_uv``
indexes a separate ``uv`` table (seam-split layout, like OBJ's).
Faces are int64 on the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Triangle mesh.  vertices [V, 3] float32, faces [F, 3] int64;
    optional uv table [T, 2] + faces_uv [F, 3] and per-vertex colors."""

    vertices: torch.Tensor
    faces: torch.Tensor
    uv: Optional[torch.Tensor] = None
    faces_uv: Optional[torch.Tensor] = None
    vertex_colors: Optional[torch.Tensor] = None

    @property
    def n_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def n_faces(self) -> int:
        return self.faces.shape[0]

    def with_vertices(self, vertices) -> "Mesh":
        return dataclasses.replace(self, vertices=vertices)


@dataclasses.dataclass(frozen=True)
class PBRMesh:
    """Mesh with PBR maps (albedo, metallic, roughness, bump), each a
    [H, W, C] map read through the UV layer, a [V, C] vertex table or a
    [C] constant."""

    vertices: torch.Tensor
    faces: torch.Tensor
    uv: Optional[torch.Tensor] = None
    faces_uv: Optional[torch.Tensor] = None
    albedo: Optional[torch.Tensor] = None
    metallic: Optional[torch.Tensor] = None
    roughness: Optional[torch.Tensor] = None
    bump: Optional[torch.Tensor] = None

    @property
    def mesh(self) -> Mesh:
        return Mesh(self.vertices, self.faces, self.uv, self.faces_uv)


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Fixed-size point set with a validity mask [N] bool instead of
    ragged shapes."""

    points: torch.Tensor
    normals: Optional[torch.Tensor] = None
    colors: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    def mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.points.shape[0], dtype=torch.bool,
                              device=self.points.device)
        return self.valid


def gather_face_vertices(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """[V, C], [F, 3] -> [F, 3, C]."""
    return vertices[faces]


def compute_face_normals(
    vertices: torch.Tensor, faces: torch.Tensor, normalize: bool = True
) -> torch.Tensor:
    """Per-face normals [F, 3]; unnormalized value is 2x the face area vector."""
    tri = vertices[faces]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    if normalize:
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-20)
    return n


def compute_face_areas(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Triangle areas [F]."""
    return 0.5 * torch.linalg.norm(
        compute_face_normals(vertices, faces, normalize=False), dim=-1)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-20)


def _segment_sum(data: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    return data.new_zeros((n, *data.shape[1:])).index_add(0, idx, data)


def compute_vertex_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals [V, 3] (scatter-add of face normals)."""
    fn = compute_face_normals(vertices, faces, normalize=False)
    contrib = fn.repeat_interleave(3, dim=0)
    vn = torch.zeros_like(vertices).index_add_(0, faces.reshape(-1), contrib)
    return vn / torch.clamp(torch.linalg.norm(vn, dim=-1, keepdim=True), min=1e-20)


def compute_vertex_tangents(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    uv: torch.Tensor,
    faces_uv: Optional[torch.Tensor] = None,
    vertex_normals: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-vertex tangents [V, 3] from UV derivatives: each face's dP/du
    through the UV-edge Jacobian (its denominator kept at |d| >= 1e-6 with
    its sign), count-averaged onto the corner vertices, then
    Gram-Schmidt orthogonalized against the vertex normal."""
    if faces_uv is None:
        faces_uv = faces
    V = vertices.shape[0]
    p = vertices[faces]
    t = uv[faces_uv]
    pe1, pe2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    ue1, ue2 = t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]
    nom = pe1 * ue2[:, 1:2] - pe2 * ue1[:, 1:2]
    denom = ue1[:, 0:1] * ue2[:, 1:2] - ue1[:, 1:2] * ue2[:, 0:1]
    denom = torch.where(denom > 0.0, torch.clamp(denom, min=1e-6),
                        torch.clamp(denom, max=-1e-6))
    idx = faces.reshape(-1)
    tsum = _segment_sum((nom / denom).repeat_interleave(3, dim=0), idx, V)
    cnt = _segment_sum(torch.ones(idx.shape[0], dtype=vertices.dtype,
                                  device=vertices.device), idx, V)
    tng = _unit(tsum / torch.clamp(cnt, min=1.0)[:, None])
    nrm = (vertex_normals if vertex_normals is not None
           else compute_vertex_normals(vertices, faces))
    return _unit(tng - torch.sum(tng * nrm, dim=-1, keepdim=True) * nrm)


def laplacian_smooth(
    v_attr: torch.Tensor, edges: torch.Tensor, n_vertices: int, depth: int = 1
) -> torch.Tensor:
    """Apply the degree-normalized edge Laplacian (the neighbour mean)
    ``depth - 1`` times; ``edges`` are unique undirected edges [E, 2]
    (:func:`~.topology.unique_edges`), isolated vertices map to 0.
    Differentiable in ``v_attr``."""
    e0, e1 = edges[:, 0].long(), edges[:, 1].long()
    both = torch.cat([e0, e1])
    deg = _segment_sum(torch.ones(both.shape[0], dtype=v_attr.dtype,
                                  device=v_attr.device), both, n_vertices)
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0),
                          torch.zeros_like(deg))
    for _ in range(depth - 1):
        nbr_sum = _segment_sum(torch.cat([v_attr[e1], v_attr[e0]]), both,
                               n_vertices)
        v_attr = nbr_sum * inv_deg[:, None]
    return v_attr


def laplacian_loss(
    v_attr: torch.Tensor, edges: torch.Tensor, n_vertices: int, depth: int = 1
) -> torch.Tensor:
    """Mean norm of the depth-smoothed attribute (a regularizer)."""
    return torch.linalg.norm(
        laplacian_smooth(v_attr, edges, n_vertices, depth=depth), dim=-1).mean()


def pad_mesh_to_bucket(mesh: Mesh, bucket: int, mode: str = "pow2") -> Mesh:
    """Pad faces and vertices up to a size bucket so differently-sized
    meshes share the same device shapes.

    mode="pow2" (default): next power of two, floored at ``bucket``;
    mode="multiple": next multiple of ``bucket``.  Padding is invisible to
    every consumer: extra faces are (0, 0, 0) — zero-area, culled by the
    rasterizers — and extra vertices duplicate vertex 0.  UV faces pad
    identically; the UV table pads to at least 2x the padded vertex count,
    as in the JAX package, so both packages see the same shapes."""
    if bucket <= 0:
        return mesh

    def up(n):
        if mode == "pow2":
            m = bucket
            while m < n:
                m *= 2
            return m
        return -(-n // bucket) * bucket

    F, V = mesh.faces.shape[0], mesh.vertices.shape[0]
    newF, newV = up(F), up(V)
    if newF == F and newV == V:
        return mesh

    def pad_rows(x, n, fill_row0):
        if n == x.shape[0]:
            return x
        if fill_row0:
            extra = x[:1].expand(n - x.shape[0], *x.shape[1:])
        else:
            extra = x.new_zeros((n - x.shape[0], *x.shape[1:]))
        return torch.cat([x, extra])

    kwargs = {}
    if mesh.vertex_colors is not None:
        kwargs["vertex_colors"] = pad_rows(mesh.vertex_colors, newV, True)
    if mesh.uv is not None:
        nuv = mesh.uv.shape[0]
        kwargs["uv"] = pad_rows(mesh.uv, max(2 * newV, up(nuv)), True)
    if mesh.faces_uv is not None:
        kwargs["faces_uv"] = pad_rows(mesh.faces_uv, newF, False)
    return dataclasses.replace(
        mesh,
        vertices=pad_rows(mesh.vertices, newV, True),
        faces=pad_rows(mesh.faces, newF, False),
        **kwargs,
    )


def scale_to_bbox(
    vertices: torch.Tensor, scale: float = 0.95, uniform: bool = True
) -> torch.Tensor:
    """Center and scale vertices so the bounding box fits in
    [-scale, scale]^3."""
    vmin = vertices.min(dim=0).values
    vmax = vertices.max(dim=0).values
    center = (vmin + vmax) * 0.5
    extent = (vmax - vmin) * 0.5
    if uniform:
        extent = extent.max()
    return (vertices - center) / torch.clamp(extent, min=1e-12) * scale


def mesh_edges(faces: torch.Tensor) -> torch.Tensor:
    """All directed edges [3F, 2]."""
    return torch.cat([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])


def erode_face_mask(
    faces: torch.Tensor, face_mask: torch.Tensor, n_vertices: int, rings: int = 1
) -> torch.Tensor:
    """Shrink a face selection by ``rings`` adjacency rings: a face
    survives only if none of its vertices touches an unselected face."""
    mask = face_mask
    for _ in range(rings):
        bad = torch.zeros(n_vertices + 1, dtype=torch.bool, device=faces.device)
        idx = torch.where(~mask[:, None], faces, torch.full_like(faces, n_vertices))
        bad[idx.reshape(-1)] = True
        mask = mask & ~bad[:n_vertices][faces].any(dim=-1)
    return mask


def interpolate_attributes(
    attr: torch.Tensor, faces: torch.Tensor, face_idx: torch.Tensor,
    bary: torch.Tensor,
) -> torch.Tensor:
    """Barycentric interpolation of per-vertex attributes: attr [V, C],
    faces [F, 3], face_idx [...], bary [..., 3] -> [..., C].  Face ids
    out of range (-1 for background) read another face: mask at the
    call site."""
    return torch.einsum("...kc,...k->...c", attr[faces[face_idx]], bary)


def sample_pbr_attribute(
    mesh: PBRMesh, attr: torch.Tensor, face_idx: torch.Tensor,
    bary: torch.Tensor,
) -> torch.Tensor:
    """A PBR attribute at surface points (face, barycentric): ``attr`` a
    [H, W, C] map read through the UV layer, a [V, C] vertex table or a
    [C] constant."""
    if attr.dim() == 3:
        if mesh.uv is None or mesh.faces_uv is None:
            raise ValueError("a map attribute needs the mesh's uv and faces_uv")
        from ..ops.grid_sample import sample_texture

        uv = torch.einsum("...kc,...k->...c", mesh.uv[mesh.faces_uv[face_idx]],
                          bary)
        return sample_texture(attr, uv)
    if attr.dim() == 2:
        return interpolate_attributes(attr, mesh.faces, face_idx, bary)
    return attr.expand(*bary.shape[:-1], *attr.shape)


def split_point_cloud(pc: PointCloud, sizes: Sequence[int]) -> List[PointCloud]:
    """Split a PointCloud into consecutive chunks of ``sizes`` points."""
    out, start = [], 0
    for n in sizes:
        sl = slice(start, start + int(n))

        def cut(a):
            return None if a is None else a[sl]

        out.append(PointCloud(points=pc.points[sl], normals=cut(pc.normals),
                              colors=cut(pc.colors), valid=cut(pc.valid)))
        start += int(n)
    return out


def concat_point_clouds(pcs: Sequence[PointCloud]) -> Tuple[PointCloud, torch.Tensor]:
    """Concatenate PointClouds into one plus [N, 3] int32 (start, stop,
    count) intervals; an optional field survives only when every input
    has it."""
    counts = [int(p.points.shape[0]) for p in pcs]
    starts = [sum(counts[:i]) for i in range(len(counts))]
    intervals = torch.tensor([[s, s + n, n] for s, n in zip(starts, counts)],
                             dtype=torch.int32, device=pcs[0].points.device)

    def cat(field):
        vals = [getattr(p, field) for p in pcs]
        return None if any(v is None for v in vals) else torch.cat(vals)

    merged = PointCloud(points=torch.cat([p.points for p in pcs]),
                        normals=cat("normals"), colors=cat("colors"),
                        valid=cat("valid"))
    return merged, intervals
