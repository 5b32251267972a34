"""Color-spec parsing (the reference's utils/parse_color.py): named colors
from the full PIL colormap, a bare float (broadcastable single channel), or
a 3-sequence of floats — returned as float32 arrays in [0, 1]."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np

try:  # the full named-color table (X11/CSS names, '#rrggbb' values)
    from PIL.ImageColor import colormap as _pil_colormap
except Exception:  # pragma: no cover - PIL is a baked-in dependency
    _pil_colormap = {}

COLOR_DICT = {
    k: np.array(
        [int(v[1:3], 16), int(v[3:5], 16), int(v[5:7], 16)], dtype=np.float32
    )
    / 255.0
    for k, v in _pil_colormap.items()
    if isinstance(v, str) and v.startswith("#") and len(v) == 7
}
# the reference pipeline's background is PIL-parsed 'grey' = #808080
# (pipeline.py:183 color='grey' straight into Image.new)
COLOR_DICT.setdefault("grey", np.array([128, 128, 128], np.float32) / 255.0)
COLOR_DICT.setdefault("gray", COLOR_DICT["grey"])


def parse_color(
    color: Optional[Union[str, float, Tuple[float, ...], List[float]]] = None,
) -> Optional[np.ndarray]:
    """None -> None; name -> [3] float32 in [0,1]; float -> [1]
    (broadcastable); 3-sequence of floats -> [3].  Raises on anything else
    (the reference raises NotImplementedError, utils/parse_color.py)."""
    if color is None:
        return None
    if isinstance(color, str):
        key = color.lower()
        if key in COLOR_DICT:
            return COLOR_DICT[key].copy()
        if key.startswith("#") and len(key) == 7:
            return (
                np.array(
                    [int(key[1:3], 16), int(key[3:5], 16), int(key[5:7], 16)],
                    dtype=np.float32,
                )
                / 255.0
            )
        raise NotImplementedError(f"unknown color name {color!r}")
    if isinstance(color, (int, float)) and not isinstance(color, bool):
        return np.array([float(color)], np.float32)
    if (
        isinstance(color, (tuple, list))
        and len(color) == 3
        and all(isinstance(c, (int, float)) and not isinstance(c, bool) for c in color)
    ):
        return np.asarray(color, np.float32)
    raise NotImplementedError(f"unsupported color spec {color!r}")


def color_to_uint8(color, default: str = "grey") -> Tuple[int, int, int]:
    """Parse a spec and return an 8-bit RGB triple (single floats broadcast)."""
    c = parse_color(color if color is not None else default)
    c = np.broadcast_to(c, (3,))
    return tuple(int(round(float(x) * 255.0)) for x in np.clip(c, 0.0, 1.0))
