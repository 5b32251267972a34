"""FLUX MMDiT configuration (port of unitex_tpu/models/flux/config.py).

Architecture hyperparameters of black-forest-labs/FLUX.1-dev
(FluxTransformer2DModel).  ``tiny()`` is a scaled-down config for CPU
tests (same topology).  The fields of the parallel and int8 variants are
kept so configs carry over, but the port runs only the single-device
forward (with ``remat``): ``flux_forward`` raises ``NotImplementedError``
when ``attn_qk8``, ``seq_axis`` or ``tp_axis`` is set.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64
    num_layers: int = 19            # dual-stream blocks
    num_single_layers: int = 38     # single-stream blocks
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096   # T5 hidden
    pooled_projection_dim: int = 768  # CLIP pooled
    guidance_embeds: bool = True
    axes_dims_rope: Tuple[int, int, int] = (16, 56, 56)
    rope_theta: float = 10000.0
    mlp_ratio: float = 4.0
    dtype: str = "bfloat16"
    remat: bool = False
    attn_qk8: bool = False
    seq_axis: "str | None" = None
    sp_mode: str = "auto"
    tp_axis: "str | None" = None

    @property
    def hidden_size(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @classmethod
    def flux1_dev(cls) -> "FluxConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "FluxConfig":
        """4-head/32-dim test model: same topology, runs on CPU in tests."""
        return cls(
            in_channels=16,
            num_layers=2,
            num_single_layers=2,
            attention_head_dim=32,
            num_attention_heads=4,
            joint_attention_dim=64,
            pooled_projection_dim=32,
            axes_dims_rope=(8, 12, 12),
            dtype="float32",
        )
