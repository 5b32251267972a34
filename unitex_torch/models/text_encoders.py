"""Text encoders for training-time prompt conditioning (port of
unitex_tpu/models/text_encoders.py).

Inference needs no text encoders (zero CLIP-pooled and zero T5
embeddings); training embeds the trigger prompt '[MVFLUX]' with CLIP-L
and T5-XXL.  Two backends, both reading ``<root>/flux/{tokenizer,
tokenizer_2, text_encoder, text_encoder_2}``:

- ``DeviceFluxTextEncoders``: the port's own encoders (``models/text.py``)
  on the device, the weights streamed leaf by leaf from the safetensors;
  only tokenization stays on the host;
- ``FluxTextEncoders``: the HF ``transformers`` modules on a device the
  caller names.

Tokenizers come from ``transformers``, imported when an encoder is built
and read from local files only;
without it (or without the weights) ``build_text_encoders`` returns None
and callers use ``zero_embeddings``, as the JAX package does.  Both
backends return (sequence [B, S, 4096], pooled [B, 768]) as f32 tensors
on their device.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.precision import resolve_device


def zero_embeddings(
    batch: int = 1,
    max_sequence_length: int = 512,
    t5_dim: int = 4096,
    clip_dim: int = 768,
) -> Tuple[np.ndarray, np.ndarray]:
    """(prompt_embeds [B, S, 4096], pooled [B, 768]): the null conditioning
    the released pipeline runs with."""
    return (
        np.zeros((batch, max_sequence_length, t5_dim), np.float32),
        np.zeros((batch, clip_dim), np.float32),
    )


def _prompts(prompts):
    return [prompts] if isinstance(prompts, str) else list(prompts)


def _flux_dir(pretrain_root: str) -> str:
    """``<root>/flux``, once it holds the tokenizer and text-encoder
    directories (checked before ``transformers`` is imported)."""
    flux = os.path.join(pretrain_root, "flux")
    missing = [n for n in ("tokenizer", "tokenizer_2", "text_encoder",
                           "text_encoder_2")
               if not os.path.isdir(os.path.join(flux, n))]
    if missing:
        raise FileNotFoundError(f"no {', '.join(missing)} under {flux}")
    return flux


class FluxTextEncoders:
    """CLIP-L pooled + T5 sequence embeddings through the HF modules, on
    ``device``."""

    def __init__(self, pretrain_root: str, max_sequence_length: int = 512,
                 device="cuda"):
        self.device = resolve_device(device)
        flux = _flux_dir(pretrain_root)
        from transformers import (
            CLIPTextModel,
            CLIPTokenizer,
            T5EncoderModel,
            T5TokenizerFast,
        )

        self.max_sequence_length = max_sequence_length
        self.clip_tokenizer = CLIPTokenizer.from_pretrained(
            os.path.join(flux, "tokenizer"), local_files_only=True)
        self.clip = CLIPTextModel.from_pretrained(
            os.path.join(flux, "text_encoder"),
            local_files_only=True).eval().to(self.device)
        self.t5_tokenizer = T5TokenizerFast.from_pretrained(
            os.path.join(flux, "tokenizer_2"), local_files_only=True)
        self.t5 = T5EncoderModel.from_pretrained(
            os.path.join(flux, "text_encoder_2"),
            local_files_only=True).eval().to(self.device)

    @torch.no_grad()
    def __call__(self, prompts) -> Tuple[torch.Tensor, torch.Tensor]:
        prompts = _prompts(prompts)
        clip_in = self.clip_tokenizer(
            prompts, padding="max_length", max_length=77, truncation=True,
            return_tensors="pt").to(self.device)
        pooled = self.clip(**clip_in).pooler_output.float()
        t5_in = self.t5_tokenizer(
            prompts, padding="max_length", max_length=self.max_sequence_length,
            truncation=True, return_tensors="pt")
        seq = self.t5(t5_in.input_ids.to(self.device)).last_hidden_state.float()
        return seq, pooled


class DeviceFluxTextEncoders:
    """CLIP-L pooled + T5 sequence embeddings with the port's encoders on
    ``device`` (the counterpart of the JAX package's
    ``JaxFluxTextEncoders``).  With a ``mesh`` (``parallel/mesh.Mesh``,
    every rank building the encoders together) T5 is cut over its
    ``model`` axis as it is read (``parallel/sharding.t5_shard_hook``, the
    layout of ``t5_param_shardings``) and runs tensor-parallel; CLIP-L
    stays whole on every rank, as in the JAX package.  ``device`` is then
    the mesh's."""

    def __init__(self, pretrain_root: str, max_sequence_length: int = 512,
                 mesh=None, device="cuda"):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        flux = _flux_dir(pretrain_root)
        from transformers import CLIPTokenizer, T5TokenizerFast

        from .flux.loader import iter_safetensors
        from .text import (
            clip_config_from_sd,
            convert_clip_text,
            convert_t5_encoder,
            t5_config_from_sd,
        )

        self.max_sequence_length = max_sequence_length
        self.clip_tokenizer = CLIPTokenizer.from_pretrained(
            os.path.join(flux, "tokenizer"), local_files_only=True)
        self.t5_tokenizer = T5TokenizerFast.from_pretrained(
            os.path.join(flux, "tokenizer_2"), local_files_only=True)
        with iter_safetensors(os.path.join(flux, "text_encoder")) as sd:
            self.clip_cfg = clip_config_from_sd(sd)
            self.clip_params = convert_clip_text(sd, self.clip_cfg, self.device)
        with iter_safetensors(os.path.join(flux, "text_encoder_2")) as sd:
            self.t5_cfg = t5_config_from_sd(sd)
            hook = None
            if mesh is not None:
                from ..parallel.sharding import t5_shard_hook

                n = mesh.size("model")
                if self.t5_cfg.num_heads % n:
                    raise ValueError(f"T5's {self.t5_cfg.num_heads} heads do "
                                     f"not split over model = {n}")
                hook = t5_shard_hook(mesh)
            self.t5_params = convert_t5_encoder(sd, self.t5_cfg, self.device,
                                                hook=hook)

    def _ids(self, tokenizer, prompts, length: int) -> torch.Tensor:
        ids = tokenizer(prompts, padding="max_length", max_length=length,
                        truncation=True).input_ids
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    @torch.no_grad()
    def __call__(self, prompts) -> Tuple[torch.Tensor, torch.Tensor]:
        from .text import clip_text_forward, t5_encoder_forward

        prompts = _prompts(prompts)
        clip_ids = self._ids(self.clip_tokenizer, prompts, 77)
        t5_ids = self._ids(self.t5_tokenizer, prompts, self.max_sequence_length)
        _, pooled = clip_text_forward(self.clip_params, self.clip_cfg, clip_ids)
        seq = t5_encoder_forward(
            self.t5_params, self.t5_cfg, t5_ids,
            group=None if self.mesh is None else self.mesh.group("model"))
        return seq.float(), pooled.float()


def build_text_encoders(
    pretrain_root: Optional[str],
    max_sequence_length: int = 512,
    backend: str = "device",
    device="cuda",
):
    """Text encoders when weights exist locally, else None (callers fall
    back to :func:`zero_embeddings`).  ``backend='device'`` (the default)
    runs the port's encoders on ``device`` and falls back to the HF
    modules; ``'torch'`` takes the HF modules only."""
    if pretrain_root is None:
        return None
    device = resolve_device(device)
    if backend == "device":
        try:
            return DeviceFluxTextEncoders(pretrain_root, max_sequence_length,
                                          device=device)
        except (OSError, ValueError, KeyError, ImportError) as e:
            print(f"[text] device encoders unavailable ({e}); trying torch")
    try:
        return FluxTextEncoders(pretrain_root, max_sequence_length, device=device)
    except (OSError, ValueError, ImportError) as e:
        print(f"[text] encoders unavailable ({e}); using null embeddings")
        return None
