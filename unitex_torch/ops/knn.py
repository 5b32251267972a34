"""K-nearest-neighbour and fixed-radius search as a chunked matmul (port of
unitex_tpu/ops/knn.py).

The distance matrix is one product per query chunk via
||q - r||² = ||q||² + ||r||² - 2 q·r, never more than [chunk, n_ref].  For
k <= 8 it is reduced by k passes of arg-min, as in the JAX package; above
that (and for ``query_ball``'s ``cap``) by a top-k that keeps
``lax.top_k``'s order: ascending distance, ties to the lower reference
index.  The product is exact f32 (no TF32): the fill picks the nearest
visible texel by these distances.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.precision import exact_f32


def _penalty(references: torch.Tensor, ref_valid: Optional[torch.Tensor]):
    """||r||² [R] and the +inf penalty of the masked references [R]."""
    ref_sq = torch.sum(references * references, dim=-1)
    if ref_valid is None:
        return ref_sq, torch.zeros_like(ref_sq)
    return ref_sq, torch.where(ref_valid, torch.zeros_like(ref_sq),
                               torch.full_like(ref_sq, float("inf")))


def _chunks(queries, references, chunk, ref_valid):
    """(start, d2 [c, R]) of each query chunk: squared distances clamped at
    0, masked references +inf."""
    ref_sq, penalty = _penalty(references, ref_valid)
    for q0 in range(0, queries.shape[0], chunk):
        q = queries[q0:q0 + chunk]
        # (||q||² + ||r||²) - 2 q·r in the JAX package's order, with two
        # [chunk, R] buffers alive (the sum and the product, doubled in place)
        d2 = torch.sum(q * q, dim=-1, keepdim=True) + ref_sq[None, :]
        d2.sub_((q @ references.T).mul_(2.0))
        yield q0, d2.clamp_(min=0.0).add_(penalty[None, :])


# the top-k branch's working set: row blocks of at most this many distances
_TOPK_BLOCK = 1 << 28


def _stable_smallest(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row of d2, ascending, ties to the lower
    index (``lax.top_k(-d2, k)``'s order), in row blocks of at most
    ``_TOPK_BLOCK`` elements.  ``torch.topk`` finds the set; a row whose k-th
    value is tied past the k-th slot is sorted whole."""
    idx = torch.empty((d2.shape[0], k), dtype=torch.long, device=d2.device)
    step = max(1, _TOPK_BLOCK // d2.shape[1])
    for r0 in range(0, d2.shape[0], step):
        d = d2[r0:r0 + step]
        kth = torch.topk(d, k, dim=1, largest=False, sorted=True)[0][:, -1:]
        # the set is exact where exactly k values are <= the k-th value
        sel = d <= kth
        exact = sel.sum(dim=1) == k
        out = idx[r0:r0 + step]
        if bool(exact.any()):
            rows = exact.nonzero()[:, 0]
            # nonzero walks each row in index order; a stable sort by
            # value then keeps the lower index first among equal values
            cand = sel[rows].nonzero()[:, 1].reshape(-1, k)
            order = torch.sort(torch.gather(d[rows], 1, cand), dim=1,
                               stable=True)[1]
            out[rows] = torch.gather(cand, 1, order)
        if not bool(exact.all()):
            rows = (~exact).nonzero()[:, 0]
            out[rows] = torch.sort(d[rows], dim=1, stable=True)[1][:, :k]
    return torch.gather(d2, 1, idx), idx


@torch.no_grad()
@exact_f32()
def knn(
    queries: torch.Tensor,
    references: torch.Tensor,
    k: int = 1,
    chunk: int = 65536,
    ref_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, D], references [R, D] -> (dists [Q, k], idx [Q, k]).

    Distances are Euclidean (not squared), ascending; ties go to the lower
    reference index.  ``ref_valid`` [R] masks out padded references."""
    Q = queries.shape[0]
    k = min(k, references.shape[0])
    dists = torch.empty((Q, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((Q, k), dtype=torch.long, device=queries.device)
    for q0, d2 in _chunks(queries, references, chunk, ref_valid):
        if k > 8:
            d_sel, i_sel = _stable_smallest(d2, k)
            dists[q0:q0 + chunk], idx[q0:q0 + chunk] = d_sel, i_sel
            continue
        rows = torch.arange(d2.shape[0], device=d2.device)
        for j in range(k):
            best = torch.argmin(d2, dim=1)
            dists[q0:q0 + chunk, j] = d2[rows, best]
            idx[q0:q0 + chunk, j] = best
            if j + 1 < k:
                d2[rows, best] = float("inf")
    return torch.sqrt(torch.clamp(dists, min=0.0)), idx


@torch.no_grad()
@exact_f32()
def query_ball(
    queries: torch.Tensor,
    references: torch.Tensor,
    radius: float,
    cap: int = 32,
    chunk: int = 65536,
    ref_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-radius neighbour search with static shapes: the ``cap``
    nearest in-radius references of each query and the true in-radius
    count (which may exceed ``cap``).

    queries [Q, D], references [R, D] -> idx [Q, cap] (any value where
    invalid), mask [Q, cap] bool (within radius and valid), counts [Q]."""
    Q = queries.shape[0]
    cap = min(cap, references.shape[0])
    r2 = torch.square(torch.as_tensor(radius, dtype=queries.dtype,
                                      device=queries.device))
    idx = torch.empty((Q, cap), dtype=torch.long, device=queries.device)
    mask = torch.empty((Q, cap), dtype=torch.bool, device=queries.device)
    counts = torch.empty((Q,), dtype=torch.int32, device=queries.device)
    for q0, d2 in _chunks(queries, references, chunk, ref_valid):
        counts[q0:q0 + chunk] = torch.sum(d2 <= r2, dim=1, dtype=torch.int32)
        d_sel, i_sel = _stable_smallest(d2, cap)
        idx[q0:q0 + chunk], mask[q0:q0 + chunk] = i_sel, d_sel <= r2
    return idx, mask, counts


def knn_gather_blend(
    queries: torch.Tensor,
    references: torch.Tensor,
    values: torch.Tensor,
    k: int = 4,
    chunk: int = 65536,
    ref_valid: Optional[torch.Tensor] = None,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Inverse-distance-weighted KNN interpolation of ``values`` [R, C] at
    ``queries`` (the fill of the texels no view sees)."""
    dists, idx = knn(queries, references, k=k, chunk=chunk, ref_valid=ref_valid)
    w = 1.0 / (dists + eps)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return torch.einsum("qk,qkc->qc", w, values[idx])
