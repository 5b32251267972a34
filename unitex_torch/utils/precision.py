"""Float32 precision of the port's f32 products on a CUDA device.

A float32 matrix product on the card runs in full float32 by default
(``torch.backends.cuda.matmul.allow_tf32`` is False), but a float32
convolution goes through cuDNN in TF32 (``torch.backends.cudnn.allow_tf32``
is True), which keeps about three decimal digits.  The geometry, camera,
bake and VAE stages are f32 and are held to the JAX package's HIGHEST
precision (the bake's depth test resolves 5e-3), so they run inside
:class:`exact_f32`, which turns both TF32 switches off and restores them
on exit.  FLUX runs in bf16, where TF32 never applies.
"""

from __future__ import annotations

import contextlib

import torch


class exact_f32(contextlib.ContextDecorator):
    """Context manager / decorator: no TF32 in f32 matmuls or convs."""

    def _recreate_cm(self):
        # a fresh instance per decorated call, so nested uses each restore
        # their own saved state
        return type(self)()

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  Asking for CUDA when no card is
    present raises; there is no fall-back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available "
            "(pass device='cpu' to run on the CPU)")
    return dev
