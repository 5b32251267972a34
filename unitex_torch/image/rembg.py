"""Background removal (the RMBG-2.0 / rembg capability,
reference pipeline.py:34-78).

Backends behind one callable protocol (image -> L-mode alpha), preferred
in this order by :func:`build_background_remover`, as in the JAX package:

* ``IsnetRemover``     -- ISNet (image/isnet.py) for RMBG-1.4 weights, on
                         the pipeline's device.
* ``BirefnetRemover``  -- BiRefNet (models/birefnet.py) for RMBG-2.0
                         weights, on the pipeline's device.
* ``OnnxRemover``      -- an RMBG/BiRefNet-style ONNX model through
                         onnxruntime (host copy).
* ``TorchRemover``     -- transformers ``AutoModelForImageSegmentation``
                         from the RMBG-2.0 directory (host copy), on the
                         given device.
* ``SaliencyRemover``  -- dependency-free fallback: border-statistics
                         chroma keying + largest connected component.
"""

from __future__ import annotations

import abc
import logging
import os
from typing import Optional

import numpy as np
import torch
from PIL import Image

from ..utils.precision import resolve_device

log = logging.getLogger(__name__)


class BackgroundRemover(abc.ABC):
    """Callable: PIL RGB image -> PIL 'L' alpha matte, computed on
    ``device`` (the host for the heuristic and ONNX backends)."""

    device = torch.device("cpu")

    @abc.abstractmethod
    def __call__(self, image: Image.Image) -> Image.Image:
        """The alpha matte of ``image``."""


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


class OnnxRemover(BackgroundRemover):
    """ONNX segmentation model (e.g. BriaAI RMBG) with ImageNet-normalized
    1024² input, the reference RMBG2's preprocessing (pipeline.py:45-49)."""

    def __init__(self, model_path: str, size: int = 1024):
        import onnxruntime as ort

        self.session = ort.InferenceSession(
            model_path, providers=["CPUExecutionProvider"]
        )
        self.size = size
        self.input_name = self.session.get_inputs()[0].name

    def __call__(self, image: Image.Image) -> Image.Image:
        rgb = image.convert("RGB")
        x = np.asarray(rgb.resize((self.size, self.size)), np.float32) / 255.0
        x = (x - [0.485, 0.456, 0.406]) / [0.229, 0.224, 0.225]
        x = x.transpose(2, 0, 1)[None].astype(np.float32)
        out = self.session.run(None, {self.input_name: x})[-1]
        pred = 1.0 / (1.0 + np.exp(-out[0].squeeze()))
        mask = Image.fromarray((pred * 255).astype(np.uint8), mode="L")
        return mask.resize(rgb.size)


class TorchRemover(BackgroundRemover):
    """transformers ``AutoModelForImageSegmentation`` (RMBG-2.0) on
    ``device``."""

    def __init__(self, ckpt: str, size: int = 1024, device="cuda"):
        from transformers import AutoModelForImageSegmentation

        self.device = torch.device(device)
        self.model = AutoModelForImageSegmentation.from_pretrained(
            ckpt, trust_remote_code=True
        ).eval().to(self.device)
        self.size = size

    def __call__(self, image: Image.Image) -> Image.Image:
        rgb = image.convert("RGB")
        x = np.asarray(rgb.resize((self.size, self.size)), np.float32) / 255.0
        x = (x - [0.485, 0.456, 0.406]) / [0.229, 0.224, 0.225]
        t = torch.from_numpy(x.transpose(2, 0, 1)[None].astype(np.float32))
        with torch.no_grad():
            pred = self.model(t.to(self.device))[-1].sigmoid()[0, 0]
        mask = Image.fromarray((pred.cpu().numpy() * 255).astype(np.uint8),
                               mode="L")
        return mask.resize(rgb.size)


def _warn_fallthrough(path: str, err: Exception) -> None:
    log.warning("background remover: %s did not load (%s: %s); trying the "
                "next backend", path, type(err).__name__, err)


def _device_fault(err: Exception) -> bool:
    """Whether ``err`` is the card's (out of memory, a CUDA error) rather
    than the checkpoint's."""
    accel = getattr(torch, "AcceleratorError", None)
    return (isinstance(err, torch.cuda.OutOfMemoryError)
            or (accel is not None and isinstance(err, accel))
            or (isinstance(err, RuntimeError) and "CUDA" in str(err)))


def _learned(model_dir: str, fnames, load, device):
    """``load(path, device)`` of the first of ``fnames`` present in
    ``model_dir``; None where none is, or where it fails to load (then
    with a warning, and no later name is tried, as in the JAX package).
    A fault of the card is raised, not fallen through."""
    for fname in fnames:
        path = os.path.join(model_dir, fname)
        if os.path.exists(path):
            device = resolve_device(device)
            try:
                return load(path, device)
            except Exception as e:  # noqa: BLE001 -- the JAX fall-through
                if _device_fault(e):
                    raise
                _warn_fallthrough(path, e)
                return None
    return None


def build_background_remover(
    pretrain_root: Optional[str] = None, device="cuda",
) -> BackgroundRemover:
    """The JAX package's choice of backend, learned models on ``device``:
    ISNet where RMBG-1.4 weights are under ``pretrain_root``, else BiRefNet
    for RMBG-2.0 weights, else the RMBG-2.0 ONNX model, else transformers
    from the RMBG-2.0 directory, else the heuristic.  A checkpoint that is
    present but fails to load falls through to the next backend, as in the
    JAX package, with a warning that names the file and the error.  Asking
    for CUDA without a card raises once a learned backend's files are
    found."""
    if pretrain_root:
        from ..models.birefnet import BirefnetRemover, load_birefnet
        from .isnet import IsnetRemover, load_isnet

        remover = _learned(
            os.path.join(pretrain_root, "briaai", "RMBG-1.4"),
            ("model.safetensors", "model.pth", "isnet.pth"),
            lambda path, dev: IsnetRemover(*load_isnet(path, device=dev)),
            device)
        rmbg_dir = os.path.join(pretrain_root, "briaai", "RMBG-2.0")
        remover = remover or _learned(
            rmbg_dir, ("model.safetensors", "pytorch_model.bin", "model.pth"),
            lambda path, dev: BirefnetRemover(*load_birefnet(path, device=dev)),
            device)
        if remover is not None:
            return remover
        onnx_path = os.path.join(rmbg_dir, "onnx", "model.onnx")
        if os.path.exists(onnx_path):
            try:
                return OnnxRemover(onnx_path)
            except ImportError as e:
                _warn_fallthrough(onnx_path, e)
        if os.path.isdir(rmbg_dir):
            device = resolve_device(device)
            try:
                return TorchRemover(rmbg_dir, device=device)
            except Exception as e:  # noqa: BLE001 -- the JAX fall-through
                _warn_fallthrough(rmbg_dir, e)
    return SaliencyRemover()
