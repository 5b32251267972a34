"""Background removal (the RMBG-2.0 / rembg capability,
reference pipeline.py:34-78).

Only the dependency-free heuristic backend is ported: ``SaliencyRemover``
(border-statistics chroma keying + largest connected component), the
backend the JAX package uses when no weights are given.  The learned
backends (ISNet, BiRefNet, ONNX, transformers) are not ported yet:
:func:`build_background_remover` raises ``NotImplementedError`` when a
weights root is passed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from PIL import Image


class BackgroundRemover:
    """Callable: PIL RGB image -> PIL 'L' alpha matte."""

    def __call__(self, image: Image.Image) -> Image.Image:  # pragma: no cover
        raise NotImplementedError


class SaliencyRemover(BackgroundRemover):
    """Heuristic matting: model the background color from the image border,
    classify pixels by color distance, keep the dominant foreground blob,
    and feather the edge."""

    def __init__(self, border: int = 8, k_sigma: float = 3.0):
        self.border = border
        self.k_sigma = k_sigma

    def __call__(self, image: Image.Image) -> Image.Image:
        rgb = np.asarray(image.convert("RGB"), np.float32)
        b = self.border
        edge = np.concatenate(
            [
                rgb[:b].reshape(-1, 3),
                rgb[-b:].reshape(-1, 3),
                rgb[:, :b].reshape(-1, 3),
                rgb[:, -b:].reshape(-1, 3),
            ]
        )
        mean = edge.mean(axis=0)
        std = edge.std(axis=0) + 4.0
        dist = np.sqrt((((rgb - mean) / std) ** 2).sum(axis=-1))
        fg = dist > self.k_sigma
        fg = self._largest_component(fg)
        # feather: soft alpha from distance
        alpha = np.clip((dist - self.k_sigma * 0.7) / (self.k_sigma * 0.6), 0, 1)
        alpha = np.where(fg, np.maximum(alpha, 0.9), np.minimum(alpha, 0.1))
        return Image.fromarray((alpha * 255).astype(np.uint8), mode="L")

    @staticmethod
    def _largest_component(mask: np.ndarray) -> np.ndarray:
        from scipy import ndimage

        labels, n = ndimage.label(mask)
        if n == 0:
            return mask
        sizes = ndimage.sum(mask, labels, range(1, n + 1))
        keep = int(np.argmax(sizes)) + 1
        return labels == keep


def build_background_remover(
    pretrain_root: Optional[str] = None,
) -> BackgroundRemover:
    """The heuristic backend.  Learned matting from ``pretrain_root``
    weights is not ported yet and raises."""
    if pretrain_root:
        raise NotImplementedError(
            "learned background removal (ISNet/BiRefNet/ONNX) is not ported")
    return SaliencyRemover()
