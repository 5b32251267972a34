"""Reference-image preprocessing: crop to the alpha bbox, recenter on a
colored square canvas (reference texturetools/image/
process_image.py:31-74 and pipeline.py:182-196): scale 0.95 on 1024², grey
background, saved as ``rembg_image.png`` + 512² ``processed_image.png``."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageOps

from ..utils.color import color_to_uint8


def get_alpha_bbox(alpha: np.ndarray, threshold: int = 0) -> Tuple[int, int, int, int]:
    """(x1, y1, x2, y2) bbox of alpha > threshold."""
    ys, xs = np.nonzero(alpha > threshold)
    if len(ys) == 0:
        return 0, 0, alpha.shape[1], alpha.shape[0]
    return int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1


def preprocess_reference_image(
    image: Image.Image,
    alpha: Optional[Image.Image] = None,
    H: int = 1024,
    W: int = 1024,
    scale: float = 0.95,
    color="grey",
    background_remover=None,
) -> Image.Image:
    """Returns an RGBA image with the subject recentered and rescaled so its
    bbox occupies ``scale`` of the canvas, composited on ``color``."""
    image = ImageOps.exif_transpose(image)
    rgb = image.convert("RGB")
    if alpha is None:
        a_np = None
        if image.mode == "RGBA":
            a = np.array(image.getchannel("A"))
            # reference only trusts an alpha that actually masks something
            if (a > 0).sum() < image.size[0] * image.size[1] - 8:
                a_np = a
        if a_np is None:
            if background_remover is not None:
                a_np = np.array(background_remover(rgb))
            else:
                a_np = np.full((image.size[1], image.size[0]), 255, np.uint8)
        alpha = Image.fromarray(a_np, mode="L")

    x1, y1, x2, y2 = get_alpha_bbox(np.array(alpha))
    dy, dx = y2 - y1, x2 - x1
    s = min(H * scale / dy, W * scale / dx)
    Ht, Wt = int(dy * s), int(dx * s)
    ox, oy = (W - Wt) // 2, (H - Ht) // 2

    rgbc = rgb.crop((x1, y1, x2, y2)).resize((Wt, Ht))
    alphac = alpha.crop((x1, y1, x2, y2)).resize((Wt, Ht))
    alphat = Image.new("L", (W, H))
    alphat.paste(alphac, (ox, oy))

    bg = color_to_uint8(color)
    out = Image.new("RGBA", (W, H), bg + (255,))
    out.paste(rgbc, (ox, oy), alphac)
    out.putalpha(alphat)
    return out


def postprocess_reference_image(
    processed: Image.Image,
    original_size: Tuple[int, int],
    bbox: Tuple[int, int, int, int],
    scale: float = 0.95,
) -> Image.Image:
    """Inverse of :func:`preprocess_reference_image`: map the centered
    square back into the original frame at ``bbox`` (the reference's
    ``postprocess``, process_image.py:79+ — used by the reprojection
    toolkit to paste generated content back onto source photos)."""
    W0, H0 = original_size
    x1, y1, x2, y2 = bbox
    dy, dx = y2 - y1, x2 - x1
    H, W = processed.size[1], processed.size[0]
    s = min(H * scale / dy, W * scale / dx)
    Ht, Wt = int(dy * s), int(dx * s)
    ox, oy = (W - Wt) // 2, (H - Ht) // 2
    crop = processed.crop((ox, oy, ox + Wt, oy + Ht)).resize((dx, dy))
    out = Image.new(processed.mode, (W0, H0))
    out.paste(crop, (x1, y1))
    return out
