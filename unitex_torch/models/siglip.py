"""SigLIP vision tower, the Redux image encoder's backbone (port of
unitex_tpu/models/siglip.py).

HF ``SiglipVisionTransformer`` numerics, as in the JAX package: a
valid-padding patch conv and learned position embeddings (no class
token), pre-LN blocks (LN1 -> multi-head attention -> residual, LN2 ->
``gelu_pytorch_tanh`` MLP -> residual), a final ``post_layernorm`` ->
``last_hidden_state``.  The attention-pooling head is not needed: Redux
reads ``last_hidden_state``.  Parameters keep the JAX package's tree
(linear kernels [d_in, d_out], the patch conv HWIO, blocks stacked
[L, ...]); everything is f32 without TF32.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.params import init_from_spec, linear_spec
from ..utils.precision import exact_f32, resolve_device
from .flux.layers import linear
from .flux.loader import _materialize, iter_safetensors
from .text import _act, _layer, _ln_affine, _ln_spec, _shape

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    hidden_size: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    mlp_dim: int = 4304
    patch_size: int = 14
    image_size: int = 384
    num_channels: int = 3
    hidden_act: str = "gelu_pytorch_tanh"
    layer_norm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def so400m_384() -> "SiglipVisionConfig":
        """google/siglip-so400m-patch14-384, the Redux backbone (27 x 27 =
        729 patch tokens)."""
        return SiglipVisionConfig()

    @staticmethod
    def tiny() -> "SiglipVisionConfig":
        return SiglipVisionConfig(
            hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
            patch_size=14, image_size=28,
        )


def init_siglip_params(generator: torch.Generator, cfg: SiglipVisionConfig,
                       device="cuda") -> Params:
    """A seeded f32 tree of the JAX init's shapes and laws on ``device``
    (whose generator ``generator`` must be): the patch conv N(0, 1/fan),
    positions N(0, 0.02²), linear kernels uniform(±1/sqrt(d_in)) with
    zero biases, LNs 1 and 0.  so400m is about 0.43 B parameters."""
    d, p, L = cfg.hidden_size, cfg.patch_size, (cfg.num_layers,)
    fan = p * p * cfg.num_channels
    spec = {
        "patch_embedding": {
            "w": ("normal", (p, p, cfg.num_channels, d), (1.0 / fan) ** 0.5),
            "b": ("zeros", (d,)),
        },
        "position_embedding": ("normal", (cfg.num_patches, d), 0.02),
        "blocks": {
            "ln1": _ln_spec(d, L),
            "q": linear_spec(d, d, lead=L),
            "k": linear_spec(d, d, lead=L),
            "v": linear_spec(d, d, lead=L),
            "out": linear_spec(d, d, lead=L),
            "ln2": _ln_spec(d, L),
            "fc1": linear_spec(d, cfg.mlp_dim, lead=L),
            "fc2": linear_spec(cfg.mlp_dim, d, lead=L),
        },
        "post_layernorm": _ln_spec(d),
    }
    return init_from_spec(spec, generator, device=resolve_device(device))


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(Q·Kᵀ/√D)·V over [B, S, H, D] in f32, as the JAX package's
    ``attention_reference`` computes it.  No kernel: SigLIP's S = 729 has no
    divisor that is a multiple of 128, so the JAX package's flash attention
    (``_pick_blocks``) hands this shape to its plain reference on every
    backend, and B1 has no D = 72 instance to take it here."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * q.shape[-1] ** -0.5
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@exact_f32()
def siglip_forward(params: Params, cfg: SiglipVisionConfig,
                   pixel_values: torch.Tensor) -> torch.Tensor:
    """pixel_values [B, H, W, 3] (NHWC, SigLIP-normalized: (x/255 - 0.5) /
    0.5) -> last_hidden_state [B, N, D] after ``post_layernorm``."""
    B = pixel_values.shape[0]
    eps = cfg.layer_norm_eps
    act = _act(cfg.hidden_act)
    ps = cfg.patch_size
    pe = params["patch_embedding"]
    x = F.conv2d(pixel_values.permute(0, 3, 1, 2), pe["w"].permute(3, 2, 0, 1),
                 pe["b"], stride=ps)
    x = x.permute(0, 2, 3, 1).reshape(B, -1, cfg.hidden_size)
    S = x.shape[1]
    x = x + params["position_embedding"][:S]
    for i in range(params["blocks"]["q"]["kernel"].shape[0]):
        p = _layer(params["blocks"], i)
        h = _ln_affine(p["ln1"], x, eps)
        q = linear(p["q"], h).reshape(B, S, cfg.num_heads, -1)
        k = linear(p["k"], h).reshape(B, S, cfg.num_heads, -1)
        v = linear(p["v"], h).reshape(B, S, cfg.num_heads, -1)
        x = x + linear(p["out"], _attention(q, k, v).reshape(B, S, -1))
        h = _ln_affine(p["ln2"], x, eps)
        x = x + linear(p["fc2"], act(linear(p["fc1"], h)))
    return _ln_affine(params["post_layernorm"], x, eps)


def preprocess_siglip(image, cfg: SiglipVisionConfig, device="cuda") -> torch.Tensor:
    """PIL image (or [H, W, 3] uint8 array) -> normalized pixel batch
    [1, S, S, 3] on ``device``: ``SiglipImageProcessor``'s bicubic resize
    (PIL's, so the pixels are the JAX package's), rescale 1/255,
    normalize with mean and std 0.5."""
    from PIL import Image

    if not isinstance(image, Image.Image):
        image = Image.fromarray(np.asarray(image))
    s = cfg.image_size
    arr = np.asarray(image.convert("RGB").resize((s, s), Image.BICUBIC), np.float32)
    arr = (arr / 255.0 - 0.5) / 0.5
    return torch.from_numpy(np.ascontiguousarray(arr[None])).to(resolve_device(device))


def _siglip_names(cfg: SiglipVisionConfig):
    def lin(k):
        return {"kernel": (f"vision_model.{k}.weight", "t"),
                "bias": (f"vision_model.{k}.bias", "vec")}

    def ln(k):
        return {"weight": (f"vision_model.{k}.weight", "vec"),
                "bias": (f"vision_model.{k}.bias", "vec")}

    pre = "encoder.layers.{i}"
    blocks = {
        "ln1": ln(f"{pre}.layer_norm1"),
        "q": lin(f"{pre}.self_attn.q_proj"),
        "k": lin(f"{pre}.self_attn.k_proj"),
        "v": lin(f"{pre}.self_attn.v_proj"),
        "out": lin(f"{pre}.self_attn.out_proj"),
        "ln2": ln(f"{pre}.layer_norm2"),
        "fc1": lin(f"{pre}.mlp.fc1"),
        "fc2": lin(f"{pre}.mlp.fc2"),
    }
    top = {
        "patch_embedding": {
            # torch Conv2d OIHW -> HWIO
            "w": ("vision_model.embeddings.patch_embedding.weight", "conv"),
            "b": ("vision_model.embeddings.patch_embedding.bias", "vec"),
        },
        "position_embedding": ("vision_model.embeddings.position_embedding.weight",
                               "vec"),
        "post_layernorm": ln("post_layernorm"),
    }
    return top, blocks


def convert_siglip_vision(sd, cfg: SiglipVisionConfig, device="cuda",
                          dtype: torch.dtype = torch.float32) -> Params:
    """An HF ``SiglipVisionModel`` state dict (``vision_model.*`` names,
    torch layout; tensors or numpy arrays, or the lazy
    ``flux/loader.iter_safetensors``) -> the parameter tree on ``device``."""
    device = resolve_device(device)
    top, blocks = _siglip_names(cfg)
    out = _materialize(top, sd, device, dtype)
    out["blocks"] = _materialize(blocks, sd, device, dtype, cfg.num_layers)
    return {k: out[k] for k in ("patch_embedding", "position_embedding",
                                "blocks", "post_layernorm")}


def siglip_config_from_sd(sd) -> SiglipVisionConfig:
    """The vision config of a state dict's shapes.  The head count is not
    in them: 16 at width 1152 and 1024, 12 at 768, else width / 72."""
    d, c, p, _ = _shape(sd, "vision_model.embeddings.patch_embedding.weight")
    n_pos = _shape(sd, "vision_model.embeddings.position_embedding.weight")[0]
    mlp = _shape(sd, "vision_model.encoder.layers.0.mlp.fc1.weight")[0]
    n_layers = 0
    while f"vision_model.encoder.layers.{n_layers}.layer_norm1.weight" in sd:
        n_layers += 1
    side = int(round(n_pos ** 0.5))
    heads = {1152: 16, 768: 12, 1024: 16}.get(d, max(1, d // 72))
    return SiglipVisionConfig(
        hidden_size=d, num_layers=n_layers, num_heads=heads, mlp_dim=mlp,
        patch_size=p, image_size=side * p, num_channels=c,
    )


def load_siglip(path_or_dir: str, device="cuda"):
    """SigLIP vision weights from a safetensors file or an HF model
    directory -> (params on ``device``, config).  An HF ``config.json``
    beside the weights sets the head count, the activation and eps, which
    the tensor shapes do not give."""
    device = resolve_device(device)
    if os.path.isdir(path_or_dir):
        cfg_path = os.path.join(path_or_dir, "config.json")
    else:
        cfg_path = os.path.join(os.path.dirname(path_or_dir), "config.json")
    with iter_safetensors(path_or_dir) as sd:
        cfg = siglip_config_from_sd(sd)
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                hf = json.load(f)
            hf = hf.get("vision_config", hf)
            cfg = dataclasses.replace(
                cfg,
                num_heads=int(hf.get("num_attention_heads", cfg.num_heads)),
                hidden_act=hf.get("hidden_act", cfg.hidden_act),
                layer_norm_eps=float(hf.get("layer_norm_eps", cfg.layer_norm_eps)),
            )
        return convert_siglip_vision(sd, cfg, device), cfg
