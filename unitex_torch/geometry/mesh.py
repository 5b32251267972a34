"""Device triangle mesh in PyTorch (port of the parts of
unitex_tpu/geometry/mesh.py on the texturing path).

Geometry convention ("storage frame"): the front box camera has identity
rotation and sits at +z.  UVs: u right, v up in [0, 1]; ``faces_uv``
indexes a separate ``uv`` table (seam-split layout, like OBJ's).
Faces are int64 on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


def compute_face_normals(
    vertices: torch.Tensor, faces: torch.Tensor, normalize: bool = True
) -> torch.Tensor:
    """Per-face normals [F, 3]; unnormalized value is 2x the face area vector."""
    tri = vertices[faces]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    if normalize:
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-20)
    return n


def compute_vertex_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals [V, 3] (scatter-add of face normals)."""
    fn = compute_face_normals(vertices, faces, normalize=False)
    contrib = fn.repeat_interleave(3, dim=0)
    vn = torch.zeros_like(vertices).index_add_(0, faces.reshape(-1), contrib)
    return vn / torch.clamp(torch.linalg.norm(vn, dim=-1, keepdim=True), min=1e-20)


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
