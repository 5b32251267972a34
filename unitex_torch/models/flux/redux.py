"""FLUX Redux image-prompt conditioning (port of
unitex_tpu/models/flux/redux.py).

The Redux projection (the FluxPriorReduxPipeline "image embedder":
Linear 1152 -> 3 · 4096, SiLU, Linear -> 4096) turns SigLIP's 729 patch
features into 729 prompt tokens that replace the T5 stream of
``run_flux_pipeline(prompt_embeds=...)``.  The SigLIP tower is the port's
own (``models/siglip.py``, on the conditioner's device); the HF
``transformers`` model on the host is the fall-back for a checkpoint the
port cannot read, and callers can always pass precomputed features.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...utils.params import init_from_spec, linear_spec
from ...utils.precision import exact_f32, resolve_device
from .layers import linear
from .loader import _materialize, iter_safetensors

log = logging.getLogger(__name__)

SIGLIP_DIM = 1152
T5_DIM = 4096
N_TOKENS = 729  # 27 x 27 SigLIP patch grid


def init_redux_params(generator: torch.Generator, siglip_dim: int = SIGLIP_DIM,
                      t5_dim: int = T5_DIM, device="cuda") -> Dict[str, Any]:
    """A seeded f32 projection of the JAX init's shapes and laws."""
    spec = {"up": linear_spec(siglip_dim, t5_dim * 3),
            "down": linear_spec(t5_dim * 3, t5_dim)}
    return init_from_spec(spec, generator, device=resolve_device(device))


@exact_f32()
def redux_project(params, siglip_features: torch.Tensor) -> torch.Tensor:
    """SigLIP patch features [B, 729, 1152] -> image-prompt embeddings
    [B, 729, 4096] (up-project, SiLU, down-project)."""
    return linear(params["down"], F.silu(linear(params["up"], siglip_features)))


def redux_image_ids(n_tokens: int = N_TOKENS, device="cuda") -> torch.Tensor:
    """Text-stream position ids of the Redux tokens (zeros, as txt_ids)."""
    return torch.zeros((n_tokens, 3), dtype=torch.float32,
                       device=resolve_device(device))


def load_redux_params(path: str, device="cuda") -> Dict[str, Any]:
    """A diffusers FluxPriorReduxPipeline ``image_embedder`` state dict (a
    safetensors file or directory; ``redux_up.*``, ``redux_down.*``) -> the
    projection on ``device`` in f32."""
    names = {k: {"kernel": (f"redux_{k}.weight", "t"),
                 "bias": (f"redux_{k}.bias", "vec")} for k in ("up", "down")}
    with iter_safetensors(path) as sd:
        return _materialize(names, sd, resolve_device(device), torch.float32)


def _load_or_warn(what: str, path: str, load):
    """``load()``, or None with a warning that names ``path`` and the
    exception where it fails; a fault of the card is raised."""
    from ...image.rembg import _device_fault

    try:
        return load()
    except Exception as e:  # noqa: BLE001 -- the JAX fall-through, told
        if _device_fault(e):
            raise
        log.warning("Redux: %s at %s did not load (%s: %s)", what, path,
                    type(e).__name__, e)
        return None


class ReduxConditioner:
    """Image -> FLUX prompt-stream embeddings on ``device``.

    Under ``pretrain_root``: the projection from ``<root>/flux/redux`` and
    the SigLIP tower from ``<root>/siglip``, read by the port
    (``self.tower``: params and config); only where that fails, HF
    ``transformers``' ``SiglipVisionModel`` on the host (``self.siglip``).
    Without a tower, call with precomputed features.  A file that is
    present but does not load is reported as a warning that names it."""

    def __init__(self, pretrain_root: Optional[str] = None, params=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.params = params
        self.tower = None       # (params, config): the port's SigLIP
        self.siglip = None      # the transformers fall-back, on the host
        self.processor = None
        if pretrain_root is None:
            return
        redux_dir = os.path.join(pretrain_root, "flux", "redux")
        if params is None and os.path.isdir(redux_dir):
            self.params = _load_or_warn(
                "the projection", redux_dir,
                lambda: load_redux_params(redux_dir, self.device))
        siglip_dir = os.path.join(pretrain_root, "siglip")
        if not os.path.isdir(siglip_dir):
            return
        from ..siglip import load_siglip

        self.tower = _load_or_warn("SigLIP", siglip_dir,
                                   lambda: load_siglip(siglip_dir, self.device))
        if self.tower is None:
            host = _load_or_warn("SigLIP (transformers)", siglip_dir,
                                 lambda: self._load_transformers(siglip_dir))
            if host is not None:
                self.processor, self.siglip = host

    @staticmethod
    def _load_transformers(siglip_dir: str):
        from transformers import SiglipImageProcessor, SiglipVisionModel

        return (SiglipImageProcessor.from_pretrained(siglip_dir),
                SiglipVisionModel.from_pretrained(siglip_dir).eval())

    @property
    def backend(self) -> Optional[str]:
        """Which SigLIP encodes an image: "port", "transformers" or None."""
        if self.tower is not None:
            return "port"
        return "transformers" if self.siglip is not None else None

    @torch.no_grad()
    def features_from_image(self, image) -> torch.Tensor:
        if self.tower is not None:
            from ..siglip import preprocess_siglip, siglip_forward

            sp, scfg = self.tower
            return siglip_forward(sp, scfg, preprocess_siglip(image, scfg, self.device))
        if self.siglip is None:
            raise RuntimeError("Redux: no SigLIP weights loaded; pass "
                               "siglip_features")
        inputs = self.processor(images=image, return_tensors="pt")
        out = self.siglip(**inputs).last_hidden_state
        return out.float().to(self.device)

    def __call__(self, image=None, siglip_features=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (prompt_embeds [B, 729, 4096], txt_ids [729, 3]) to feed
        ``run_flux_pipeline(prompt_embeds=...)``: the Redux tokens replace
        the T5 stream."""
        if self.params is None:
            raise RuntimeError("Redux: projection weights not loaded")
        if siglip_features is None:
            siglip_features = self.features_from_image(image)
        feats = torch.as_tensor(siglip_features, dtype=torch.float32).to(self.device)
        embeds = redux_project(self.params, feats)
        return embeds, redux_image_ids(embeds.shape[1], self.device)
