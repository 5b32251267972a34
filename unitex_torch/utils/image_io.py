"""PIL <-> array helpers (renderer_utils.image_to_tensor/tensor_to_image)."""

from __future__ import annotations

import io

import numpy as np
from PIL import Image


def imfrombytes(content: bytes, mode: str = "RGB") -> np.ndarray:
    """Encoded image bytes -> [H, W, C] float32 in [0, 1]
    (basicsr img_util.imfrombytes, RGB instead of cv2's BGR)."""
    img = Image.open(io.BytesIO(content)).convert(mode)
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def imtobytes(arr, format: str = "PNG", compress_level: int = 1) -> bytes:
    """[H, W, C] float in [0, 1] -> encoded bytes (lmdb_util
    cv2.imencode counterpart)."""
    a = to_uint8(arr)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format=format, compress_level=compress_level)
    return buf.getvalue()


def crop_border(imgs, border: int):
    """Crop ``border`` pixels from each HWC image's four sides
    (basicsr img_util.crop_border)."""
    if border == 0:
        return imgs
    if isinstance(imgs, list):
        return [im[border:-border, border:-border, ...] for im in imgs]
    return imgs[border:-border, border:-border, ...]


def load_image(path: str, mode: str = "RGB") -> np.ndarray:
    """-> [H, W, C] float32 in [0, 1]."""
    img = Image.open(path).convert(mode)
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def to_uint8(arr) -> np.ndarray:
    a = np.asarray(arr)
    if a.dtype == np.uint8:  # already quantized (e.g. on-device to_uint8_jit)
        return a
    return (np.clip(a, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def to_uint8_device(arr):
    """On-device equivalent of :func:`to_uint8` for a tensor: quantize
    before the device->host copy, so a 2048² texture crosses as uint8
    instead of f32."""
    import torch

    return torch.clamp(torch.round(arr * 255.0), 0.0, 255.0).to(torch.uint8)


def from_uint8(img: np.ndarray) -> np.ndarray:
    return np.asarray(img, np.float32) / 255.0


def save_image(path: str, arr) -> None:
    """[H, W, C] float in [0,1] (C in 1/3/4) -> PNG."""
    a = to_uint8(arr)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    Image.fromarray(a).save(path)
