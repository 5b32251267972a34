"""Triangle rasterization in PyTorch (port of unitex_tpu/ops/rasterize.py).

Edge functions are evaluated for (pixel block x face chunk) pairs with a
running z-buffer; above ``binned_threshold`` faces the tile-binned
rasterizer (ops/rasterize_binned.py) takes over.  The arithmetic follows
the JAX package step for step, so the edge-inclusion (``>= 0`` on all
three edge functions, double-sided) and depth-tie (first face index of
the smallest z wins) rules are the same.

Output convention (``dr.rasterize``'s (u, v, z, tri_id) buffer):
``Rast.bary`` holds perspective-corrected barycentric weights (b1, b2) of
vertices 1 and 2, ``Rast.z`` the NDC depth (+1 far), ``Rast.tri`` the face
id with -1 for background.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..utils.precision import exact_f32

# pixels evaluated at once by the brute-force rasterizer (a band of whole
# rows): bounds the [pixels, face_chunk] edge-function temporaries
_PIXEL_BLOCK = 4096


@dataclasses.dataclass(frozen=True)
class Rast:
    """Rasterization result for one view: bary [H, W, 2] f32, z [H, W] f32,
    tri [H, W] int64 (-1 = background)."""

    bary: torch.Tensor
    z: torch.Tensor
    tri: torch.Tensor

    @property
    def mask(self) -> torch.Tensor:
        return self.tri >= 0

    @property
    def bary3(self) -> torch.Tensor:
        b1 = self.bary[..., 0]
        b2 = self.bary[..., 1]
        return torch.stack([1.0 - b1 - b2, b1, b2], dim=-1)


def _triangle_setup(verts_clip: torch.Tensor, faces: torch.Tensor, H: int, W: int):
    """Per-triangle screen-space setup: pixel-space corners [F, 3, 2], ndc
    z [F, 3], clip w [F, 3], and validity (w > eps at every corner)."""
    tri = verts_clip[faces]                     # [F, 3, 4]
    w = tri[..., 3]
    valid = torch.all(w > 1e-6, dim=-1)
    w_safe = torch.where(torch.abs(w) > 1e-12, w, torch.full_like(w, 1e-12))
    ndc = tri[..., :3] / w_safe[..., None]
    pix = torch.stack(
        [(ndc[..., 0] * 0.5 + 0.5) * W, (ndc[..., 1] * 0.5 + 0.5) * H], dim=-1
    )
    return pix, ndc[..., 2], w, valid


def _edge_eval(px, py, pix, z, w, valid):
    """Edge functions of candidate triangles at pixel centers.

    px/py [..., P]; pix [..., K, 3, 2], z/w [..., K, 3], valid [..., K].
    Returns (z_masked [..., P, K] with +inf outside, b0, b1, b2 [..., P, K])."""
    ax, ay = pix[..., 0, 0], pix[..., 0, 1]
    bx, by = pix[..., 1, 0], pix[..., 1, 1]
    cx, cy = pix[..., 2, 0], pix[..., 2, 1]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)     # [..., K]
    nz = torch.abs(area) > 1e-12
    inv_area = torch.where(nz, 1.0 / area, torch.zeros_like(area))
    pxe = px[..., :, None]
    pye = py[..., :, None]

    def edge(x1, y1, x2, y2):
        return (x2 - x1)[..., None, :] * (pye - y1[..., None, :]) - (
            (y2 - y1)[..., None, :] * (pxe - x1[..., None, :])
        )

    e0 = edge(bx, by, cx, cy)    # weight of v0
    e1 = edge(cx, cy, ax, ay)    # weight of v1
    e2 = edge(ax, ay, bx, by)    # weight of v2
    s = torch.sign(area)[..., None, :]
    inside = (e0 * s >= 0) & (e1 * s >= 0) & (e2 * s >= 0)
    inside &= (nz & valid)[..., None, :]
    ia = inv_area[..., None, :]
    b0, b1, b2 = e0 * ia, e1 * ia, e2 * ia
    zs = b0 * z[..., None, :, 0] + b1 * z[..., None, :, 1] + b2 * z[..., None, :, 2]
    inside &= (zs >= -1.0) & (zs <= 1.0)
    z_masked = torch.where(inside, zs, torch.full_like(zs, float("inf")))
    return z_masked, b0, b1, b2


def _pick(z_masked, b0, b1, b2, w):
    """Nearest candidate per pixel (the first of equal depths): (zbest
    [..., P], best [..., P], perspective-corrected bary [..., P, 3]).
    w [..., K, 3] has the leading dims of z_masked [..., P, K]."""
    best = torch.argmin(z_masked, dim=-1)
    idx = best[..., None]
    zb = z_masked.gather(-1, idx)[..., 0]
    bb = torch.stack([b0.gather(-1, idx)[..., 0], b1.gather(-1, idx)[..., 0],
                      b2.gather(-1, idx)[..., 0]], dim=-1)
    wb = torch.gather(w, -2, best[..., None].expand(*best.shape, 3))
    pc = bb / wb
    pc = pc / torch.sum(pc, dim=-1, keepdim=True)
    return zb, best, pc


def _rasterize_brute(pix, z_ndc, w_clip, valid, H, W, face_chunk):
    """All faces against every pixel, in bands of rows.  A band only
    evaluates the faces whose screen y-range reaches it (with a one-pixel
    margin); a face that cannot reach the band is never inside there, so
    the result — nearest z, ties to the lowest face index — is the one of
    the full evaluation."""
    dev = pix.device
    P = H * W
    zbuf = torch.full((P,), float("inf"), device=dev)
    tribuf = torch.full((P,), -1, dtype=torch.int64, device=dev)
    b1buf = torch.zeros((P,), device=dev)
    b2buf = torch.zeros((P,), device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    ymin = pix[..., 1].min(dim=1).values
    ymax = pix[..., 1].max(dim=1).values
    band = max(1, _PIXEL_BLOCK // W)
    for r0 in range(0, H, band):
        r1 = min(H, r0 + band)
        sel = torch.nonzero((ymax >= r0 - 1) & (ymin <= r1 + 1))[:, 0]
        if sel.numel() == 0:
            continue
        ys = torch.arange(r0, r1, dtype=torch.float32, device=dev) + 0.5
        px = xs[None, :].expand(r1 - r0, W).reshape(-1)
        py = ys[:, None].expand(r1 - r0, W).reshape(-1)
        p0, p1 = r0 * W, r1 * W
        for f0 in range(0, sel.numel(), face_chunk):
            ids = sel[f0:f0 + face_chunk]
            z_masked, b0, b1, b2 = _edge_eval(
                px, py, pix[ids], z_ndc[ids], w_clip[ids], valid[ids])
            zb, best, pc = _pick(z_masked, b0, b1, b2, w_clip[ids])
            better = zb < zbuf[p0:p1]
            zbuf[p0:p1] = torch.where(better, zb, zbuf[p0:p1])
            tribuf[p0:p1] = torch.where(better, ids[best], tribuf[p0:p1])
            b1buf[p0:p1] = torch.where(better, pc[:, 1], b1buf[p0:p1])
            b2buf[p0:p1] = torch.where(better, pc[:, 2], b2buf[p0:p1])
    zbuf = torch.where(torch.isinf(zbuf), torch.ones_like(zbuf), zbuf)
    return Rast(
        torch.stack([b1buf, b2buf], dim=-1).reshape(H, W, 2),
        zbuf.reshape(H, W),
        tribuf.reshape(H, W),
    )


@exact_f32()
def rasterize(
    verts_clip: torch.Tensor,
    faces: torch.Tensor,
    resolution: Tuple[int, int],
    face_chunk: int = 512,
    binned_threshold: int = 8192,
    tile_batch: int = 64,
) -> Rast:
    """Rasterize clip-space triangles into a z-buffered id/barycentric buffer.

    verts_clip [V, 4] (after MVP), faces [F, 3], resolution (H, W).  Above
    ``binned_threshold`` faces (and for H, W multiples of 32) the
    tile-binned rasterizer takes over, with the same bin capacity rule as
    the JAX package."""
    H, W = resolution
    faces = faces.long()
    if (
        binned_threshold > 0
        and faces.shape[0] > binned_threshold
        and H % 32 == 0
        and W % 32 == 0
    ):
        from .rasterize_binned import rasterize_binned

        n_tiles = (H // 32) * (W // 32)
        est = faces.shape[0] * 4 // max(n_tiles, 1)
        cap = min(8192, (est * 4 + 128 + 127) // 128 * 128)
        return rasterize_binned(
            verts_clip, faces, resolution, bin_capacity=cap,
            tile_batch=tile_batch,
        )
    pix, z_ndc, w_clip, valid = _triangle_setup(verts_clip, faces, H, W)
    return _rasterize_brute(pix, z_ndc, w_clip, valid, H, W, face_chunk)


def rasterize_uv(
    uv: torch.Tensor,
    faces_uv: torch.Tensor,
    resolution: int,
    face_chunk: int = 512,
    tile_batch: int = 64,
) -> Rast:
    """Rasterize the UV atlas into texture space.  UVs are [T, 2] in [0,1],
    v-up; image row 0 = v=1 (top)."""
    ndc = torch.stack([uv[:, 0] * 2.0 - 1.0, 1.0 - uv[:, 1] * 2.0], dim=-1)
    clip = torch.cat([ndc, torch.zeros_like(ndc[:, :1]),
                      torch.ones_like(ndc[:, :1])], dim=-1)
    return rasterize(
        clip, faces_uv, (resolution, resolution),
        face_chunk=face_chunk, tile_batch=tile_batch,
    )


def interpolate(
    attr: torch.Tensor,
    rast: Rast,
    faces: torch.Tensor,
    fill: float = 0.0,
) -> torch.Tensor:
    """Interpolate per-vertex attributes over a rast buffer
    (``dr.interpolate`` equivalent): attr [V, C], faces [F, 3] -> [H, W, C];
    background pixels get ``fill``.  The barycentric blend is exact f32
    (elementwise, no matmul): interpolated positions feed the bake's
    5e-3 depth test."""
    tri = torch.clamp(rast.tri, min=0)
    corners = attr[faces[tri]]                    # [H, W, 3, C]
    b = rast.bary3[..., None]
    out = corners[..., 0, :] * b[..., 0, :] + corners[..., 1, :] * b[..., 1, :] \
        + corners[..., 2, :] * b[..., 2, :]
    return torch.where(rast.mask[..., None], out,
                       torch.full_like(out, fill))
