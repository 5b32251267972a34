"""Tile-binned rasterization in PyTorch (port of
unitex_tpu/ops/rasterize_binned.py) — the path for meshes above 8192 faces.

1.  per-triangle screen bbox -> the 32x32 screen tiles it may cover; each
    small triangle emits up to ``max_tiles_per_tri`` (tile, tri) entries,
    and the ``n_big`` largest triangles are tested against every tile;
2.  entries are sorted (stably) by tile and then by nearest depth, so an
    overflowing bin drops its farthest triangles; segment offsets turn the
    sorted list into a dense [n_tiles, bin_capacity] table;
3.  each tile z-buffers only its own candidates, ``tile_batch`` tiles at
    a time.

Same Rast contract as ops/rasterize.rasterize.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .rasterize import Rast, _edge_eval, _pick, _triangle_setup


def rasterize_binned(
    verts_clip: torch.Tensor,
    faces: torch.Tensor,
    resolution: Tuple[int, int],
    tile: int = 32,
    max_tiles_per_tri: int = 8,
    bin_capacity: int = 1024,
    n_big: int = 256,
    tile_batch: int = 64,
) -> Rast:
    """Tile-binned z-buffer rasterization; same contract as ``rasterize``."""
    H, W = resolution
    if H % tile or W % tile:
        raise ValueError(f"resolution {resolution} is not a multiple of {tile}")
    TX, TY = W // tile, H // tile
    T = TX * TY
    tile_batch = math.gcd(tile_batch, T)
    faces = faces.long()
    F = faces.shape[0]
    dev = verts_clip.device

    pix, z_ndc, w_clip, valid = _triangle_setup(verts_clip, faces, H, W)

    # ---- tile bboxes per triangle
    pxmin, pxmax = pix[..., 0].min(dim=1).values, pix[..., 0].max(dim=1).values
    pymin, pymax = pix[..., 1].min(dim=1).values, pix[..., 1].max(dim=1).values
    xmin = torch.clamp(torch.floor(pxmin / tile), 0, TX - 1)
    xmax = torch.clamp(torch.floor(pxmax / tile), 0, TX - 1)
    ymin = torch.clamp(torch.floor(pymin / tile), 0, TY - 1)
    ymax = torch.clamp(torch.floor(pymax / tile), 0, TY - 1)
    on_screen = (pxmax >= 0) & (pxmin < W) & (pymax >= 0) & (pymin < H) & valid
    bw = (xmax - xmin + 1).long()
    bh = (ymax - ymin + 1).long()
    n_tiles_tri = bw * bh
    small = on_screen & (n_tiles_tri <= max_tiles_per_tri)

    # ---- big triangles: the n_big with the most covered tiles (ties by
    # lower face index, like lax.top_k), tested against every tile
    big_score = torch.where(on_screen & ~small, n_tiles_tri,
                            torch.zeros_like(n_tiles_tri))
    order_big = torch.sort(big_score, descending=True, stable=True).indices
    big_ids = order_big[: min(n_big, F)]
    big_ids = torch.where(big_score[big_ids] > 0, big_ids,
                          torch.full_like(big_ids, -1))

    # ---- (tile, tri) entries of the small triangles
    r = torch.arange(max_tiles_per_tri, device=dev)
    bw1 = torch.clamp(bw, min=1)[:, None]
    dy = r[None, :] // bw1
    dx = r[None, :] % bw1
    entry_valid = small[:, None] & (dy < bh[:, None])
    tx = xmin.long()[:, None] + dx
    ty = ymin.long()[:, None] + dy
    tile_id = torch.where(entry_valid, ty * TX + tx, torch.full_like(tx, T))
    tri_id = torch.arange(F, device=dev)[:, None].expand_as(tile_id)
    tile_flat = tile_id.reshape(-1)
    tri_flat = tri_id.reshape(-1)

    # sort by (tile, nearest z16): the composite key of the JAX package
    z_near = torch.clamp(z_ndc.min(dim=1).values, -1.0, 1.0)
    z16 = ((z_near + 1.0) * 0.5 * 65535.0).long()
    key = tile_flat * 65536 + z16[tri_flat]
    order = torch.argsort(key, stable=True)
    tile_sorted = tile_flat[order]
    tri_sorted = tri_flat[order]

    # ---- dense [T, bin_capacity] table via segment positions
    seg_start = torch.searchsorted(
        tile_sorted, torch.arange(T, device=dev, dtype=tile_sorted.dtype))
    pos = torch.arange(tile_sorted.shape[0], device=dev) - seg_start[
        torch.clamp(tile_sorted, max=T - 1)]
    keep = (tile_sorted < T) & (pos < bin_capacity)
    table = torch.full((T + 1, bin_capacity), -1, dtype=torch.long, device=dev)
    # rejected entries go to row T, which is dropped
    table[torch.where(keep, tile_sorted, torch.full_like(tile_sorted, T)),
          torch.where(keep, pos, torch.zeros_like(pos))] = tri_sorted
    table = table[:T]

    # ---- per-tile rasterization, tile_batch tiles at a time
    ly = torch.arange(tile, dtype=torch.float32, device=dev) + 0.5
    lx = torch.arange(tile, dtype=torch.float32, device=dev) + 0.5
    local_x = lx[None, :].expand(tile, tile).reshape(-1)
    local_y = ly[:, None].expand(tile, tile).reshape(-1)
    bary = torch.empty((T, tile * tile, 2), device=dev)
    zout = torch.empty((T, tile * tile), device=dev)
    tri_out = torch.empty((T, tile * tile), dtype=torch.long, device=dev)
    for t0 in range(0, T, tile_batch):
        tids = torch.arange(t0, t0 + tile_batch, device=dev)
        ids = torch.cat([table[t0:t0 + tile_batch],
                         big_ids[None].expand(tile_batch, -1)], dim=1)
        safe = torch.clamp(ids, min=0)
        cvalid = valid[safe] & (ids >= 0)
        ox = ((tids % TX) * tile).float()[:, None]
        oy = ((tids // TX) * tile).float()[:, None]
        px = ox + local_x[None, :]
        py = oy + local_y[None, :]
        cw = w_clip[safe]
        z_masked, b0, b1, b2 = _edge_eval(px, py, pix[safe], z_ndc[safe], cw, cvalid)
        zb, best, pc = _pick(z_masked, b0, b1, b2, cw)
        hit = torch.isfinite(zb)
        tri = torch.where(hit, ids.gather(1, best), torch.full_like(best, -1))
        bary[t0:t0 + tile_batch] = torch.where(
            hit[..., None], pc[..., 1:], torch.zeros_like(pc[..., 1:]))
        zout[t0:t0 + tile_batch] = torch.where(hit, zb, torch.ones_like(zb))
        tri_out[t0:t0 + tile_batch] = tri

    def untile(a):
        a = a.reshape(TY, TX, tile, tile, *a.shape[2:])
        return a.transpose(1, 2).reshape(H, W, *a.shape[4:])

    return Rast(untile(bary), untile(zout), untile(tri_out))
