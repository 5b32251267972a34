"""K-nearest-neighbour search as a chunked matmul + arg-min (port of
unitex_tpu/ops/knn.py ``knn``).

The distance matrix is one product per query chunk via
||q - r||² = ||q||² + ||r||² - 2 q·r, reduced by k passes of arg-min,
never materializing more than [chunk, n_ref].  The product is exact f32
(no TF32): the fill picks the nearest visible texel by these distances.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.precision import exact_f32


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
    R = references.shape[0]
    k = min(k, R)
    if k > 8:
        raise NotImplementedError("knn with k > 8 (the top-k branch) is not ported")
    ref_sq = torch.sum(references * references, dim=-1)
    if ref_valid is not None:
        penalty = torch.where(ref_valid, torch.zeros_like(ref_sq),
                              torch.full_like(ref_sq, float("inf")))
    else:
        penalty = torch.zeros_like(ref_sq)
    dists = torch.empty((Q, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((Q, k), dtype=torch.long, device=queries.device)
    for q0 in range(0, Q, chunk):
        q = queries[q0:q0 + chunk]
        q_sq = torch.sum(q * q, dim=-1, keepdim=True)
        d2 = q_sq + ref_sq[None, :] - 2.0 * (q @ references.T)
        d2 = torch.clamp(d2, min=0.0) + penalty[None, :]
        rows = torch.arange(d2.shape[0], device=d2.device)
        for j in range(k):
            best = torch.argmin(d2, dim=1)
            dists[q0:q0 + chunk, j] = d2[rows, best]
            idx[q0:q0 + chunk, j] = best
            if j + 1 < k:
                d2[rows, best] = float("inf")
    return torch.sqrt(torch.clamp(dists, min=0.0)), idx
