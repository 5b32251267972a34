"""Texture remapping between meshes: UV re-baking (port of
unitex_tpu/texture/remapping.py).

A texture moves from a source mesh (its own UV layout and map, or vertex
colours) onto a target mesh's UV atlas: the target's atlas is rasterized
for each texel's 3D position, each texel takes the inverse-distance blend
of its k nearest coloured samples of the source surface, and pull-push
fills the gutters.  The source sampling is host numpy, bit for bit the
JAX package's; the rest runs on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..geometry.io.mesh_io import HostMesh
from ..geometry.mesh import Mesh
from ..ops.image_ops import pull_push
from ..ops.knn import knn
from ..render.renderer_inverse import uv_render
from ..utils.precision import exact_f32


def _sample_source_colors(src: HostMesh, n_samples: int, seed: int = 0):
    """Area-weighted surface samples of the source (``sample_surface``'s
    draws) and their colours from its texture (nearest texel) or its
    vertex colours (barycentric)."""
    rng = np.random.default_rng(seed)
    v = src.vertices.astype(np.float64)
    f = src.faces.astype(np.int64)
    tri = v[f]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    areas = 0.5 * np.linalg.norm(n, axis=-1)
    if areas.sum() <= 0:
        raise ValueError("degenerate mesh: zero surface area")
    probs = areas / areas.sum()
    face_idx = rng.choice(len(f), size=n_samples, p=probs)
    r1 = np.sqrt(rng.uniform(size=n_samples))
    r2 = rng.uniform(size=n_samples)
    bary = np.stack([1.0 - r1, r1 * (1.0 - r2), r1 * r2], axis=-1)
    pts = np.einsum("nkc,nk->nc", tri[face_idx], bary).astype(np.float32)

    if src.texture is not None and src.uv is not None and src.faces_uv is not None:
        uv_tri = src.uv[src.faces_uv.astype(np.int64)][face_idx]
        uv = np.einsum("nkc,nk->nc", uv_tri, bary)
        Ht, Wt = src.texture.shape[:2]
        px = np.clip((uv[:, 0] * Wt).astype(np.int64), 0, Wt - 1)
        py = np.clip(((1.0 - uv[:, 1]) * Ht).astype(np.int64), 0, Ht - 1)
        colors = src.texture[py, px, :3].astype(np.float32) / 255.0
    elif src.vertex_colors is not None:
        col_tri = src.vertex_colors[f][face_idx][..., :3]
        colors = np.einsum("nkc,nk->nc", col_tri, bary).astype(np.float32)
    else:
        raise ValueError("source mesh has neither texture nor vertex colors")
    return pts, colors


@torch.no_grad()
@exact_f32()
def remap_texture(
    src: HostMesh,
    dst: HostMesh,
    uv_size: int = 1024,
    n_samples: int = 200_000,
    k: int = 3,
    seed: int = 0,
    knn_chunk: int = 8192,
    device="cuda",
) -> np.ndarray:
    """Bake the source mesh's appearance into the target mesh's UV atlas,
    on ``device``.  Both meshes must live in the same world frame.
    Returns a [uv_size, uv_size, 3] float32 texture."""
    if dst.uv is None or dst.faces_uv is None:
        raise ValueError("the target mesh needs UVs")
    src_pts, src_col = _sample_source_colors(src, n_samples, seed)

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    mesh = Mesh(t(dst.vertices, torch.float32), t(dst.faces, torch.long),
                uv=t(dst.uv, torch.float32), faces_uv=t(dst.faces_uv, torch.long))
    uv_out = uv_render(mesh, uv_size)
    pos = uv_out["position"].reshape(-1, 3)
    mask = uv_out["mask"].reshape(-1)

    d, idx = knn(pos, t(src_pts, torch.float32), k=k, chunk=knn_chunk)
    w = 1.0 / torch.clamp(d, min=1e-6)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    colors = torch.einsum("qk,qkc->qc", w, t(src_col, torch.float32)[idx])
    tex = torch.where(mask[:, None], colors, torch.zeros_like(colors))
    tex = tex.reshape(uv_size, uv_size, 3)
    return pull_push(tex, uv_out["mask"]).cpu().numpy()


def color_transfer_v_uv(
    src: HostMesh,
    dst: Optional[HostMesh] = None,
    uv_size: int = 1024,
    n_samples: int = 200_000,
    seed: int = 0,
    device="cuda",
) -> HostMesh:
    """Transfer the source's colours into a (possibly UV-less) destination
    mesh's texture map: the reference's texture transfer (a Blender
    smart-UV subprocess and a MeshLab vertex-attribute bake) as the repo's
    own UV unwrap and the UV-rasterized KNN bake, with no subprocess.
    ``dst=None`` retextures the source itself.  Returns the destination
    with uv/faces_uv and a uint8 texture attached."""
    from ..geometry.uv_atlas import unwrap_atlas

    if dst is None:
        dst = src
    if dst.uv is None or dst.faces_uv is None:
        dst = unwrap_atlas(dst, size=uv_size)
    tex = remap_texture(src, dst, uv_size=uv_size, n_samples=n_samples,
                        seed=seed, device=device)
    tex_u8 = (np.clip(tex, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return dataclasses.replace(dst, texture=tex_u8)
