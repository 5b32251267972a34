"""SD3 MMDiT configuration, the TSD-SR backbone (port of
unitex_tpu/models/sd3/config.py: stable-diffusion-3-medium).

``seq_axis`` and ``tp_axis`` hold process groups, as FLUX's do
(``models/flux/config.py``): the token sequence cut over the first
(``model.sd3_forward_sp``), tensor parallelism over the second, with the
blocks' Megatron slices and the local head count (``model.tp_config``)."""

from __future__ import annotations

import dataclasses
from typing import Any

from ..flux.config import check_groups


@dataclasses.dataclass(frozen=True)
class SD3Config:
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096    # T5/CLIP concat hidden
    caption_projection_dim: int = 1536
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 192
    qk_norm: bool = False              # medium has no qk-norm
    mlp_ratio: float = 4.0
    dtype: str = "bfloat16"
    seq_axis: Any = None      # process group the sequence is cut over
    sp_mode: str = "auto"     # "ulysses" | "ring" | "auto"
    tp_axis: Any = None       # process group of the tensor-parallel ranks

    def __post_init__(self):
        check_groups(self)

    @property
    def hidden_size(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @classmethod
    def sd3_medium(cls) -> "SD3Config":
        return cls()

    @classmethod
    def tiny(cls) -> "SD3Config":
        return cls(
            in_channels=4,
            out_channels=4,
            num_layers=2,
            attention_head_dim=16,
            num_attention_heads=4,
            joint_attention_dim=32,
            caption_projection_dim=64,
            pooled_projection_dim=32,
            pos_embed_max_size=16,
            dtype="float32",
        )
