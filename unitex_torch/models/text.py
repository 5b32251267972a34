"""CLIP-L and T5 text encoders on the device (port of
unitex_tpu/models/text_jax.py).

Training embeds the trigger prompt with CLIP-L (pooled) and T5-XXL
(sequence); inference runs with zero embeddings.  Both encoders follow
the HF numerics, with the JAX package's parameter trees (linear kernels
[d_in, d_out], blocks stacked [L, ...]):

- CLIP text tower: learned token and position embeddings, pre-LN blocks
  with causal attention (``flux/layers.sdpa``'s masked branch: plain
  attention, no kernel) and a quick-GELU MLP, a final LN, the pooled
  output at the first EOS token.
- T5 v1.1 encoder: the shared embedding, RMS-normed blocks with UNSCALED
  attention (T5 folds 1/sqrt(d_kv) into its weights) plus one
  relative-position bucket bias shared by every layer, a gated GELU-tanh
  (or the legacy ReLU) feed-forward, a final RMS norm; the optional
  ``attention_mask`` adds -1e9 to masked keys.

Everything is f32 without TF32.  The converters read an HF state dict (a
dict of arrays, or the lazy ``flux/loader.iter_safetensors`` of a
checkpoint directory) leaf by leaf onto the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.params import init_from_spec, linear_spec
from ..utils.precision import exact_f32
from .flux.layers import gelu_tanh, linear, rms_norm, sdpa
from .flux.loader import _materialize

Params = Dict[str, Any]


def _layer(tree, i: int):
    """Layer ``i`` of a stacked [L, ...] block tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _shape(sd, name: str) -> tuple:
    """A state-dict entry's shape, from a shard's header where the state
    dict is lazy."""
    get = getattr(sd, "shape", None)
    return tuple(get(name)) if callable(get) else tuple(sd[name].shape)


# --------------------------------------------------------------- CLIP text


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_positions: int = 77
    eos_token_id: int = 49407
    hidden_act: str = "quick_gelu"  # CLIP-L; tiny HF configs may use "gelu"
    layer_norm_eps: float = 1e-5

    @staticmethod
    def clip_l() -> "CLIPTextConfig":
        return CLIPTextConfig()


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name in ("gelu", "gelu_python"):
        return F.gelu
    if name in ("gelu_new", "gelu_pytorch_tanh"):
        return gelu_tanh
    if name == "relu":
        return F.relu
    raise ValueError(f"unsupported activation {name!r}")


def _ln_affine(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["weight"] + p["bias"]).to(x.dtype)


def _ln_spec(d: int, lead=()) -> Params:
    return {"weight": ("ones", (*lead, d)), "bias": ("zeros", (*lead, d))}


def init_clip_text_params(generator: torch.Generator, cfg: CLIPTextConfig,
                          device="cuda") -> Params:
    """A seeded f32 tree of the JAX init's shapes and laws on ``device``
    (whose generator ``generator`` must be): embeddings N(0, 0.02²),
    linear kernels uniform(±1/sqrt(d_in)) with zero biases, LNs 1 and 0."""
    d, L = cfg.hidden_size, (cfg.num_layers,)
    spec = {
        "token_embedding": ("normal", (cfg.vocab_size, d), 0.02),
        "position_embedding": ("normal", (cfg.max_positions, d), 0.02),
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
        "final_ln": _ln_spec(d),
    }
    return init_from_spec(spec, generator, device=device)


@exact_f32()
def clip_text_forward(
    params: Params, cfg: CLIPTextConfig, input_ids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """input_ids [B, S] -> (last_hidden_state [B, S, D] after the final
    LN, pooled [B, D] at the first EOS position)."""
    ids = input_ids.long()
    B, S = ids.shape
    act = _act(cfg.hidden_act)
    eps = cfg.layer_norm_eps
    x = params["token_embedding"][ids] + params["position_embedding"][:S]
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                   device=ids.device))[None, None]
    for i in range(params["blocks"]["q"]["kernel"].shape[0]):
        p = _layer(params["blocks"], i)
        h = _ln_affine(p["ln1"], x, eps)
        q = linear(p["q"], h).reshape(B, S, cfg.num_heads, -1)
        k = linear(p["k"], h).reshape(B, S, cfg.num_heads, -1)
        v = linear(p["v"], h).reshape(B, S, cfg.num_heads, -1)
        attn = sdpa(q, k, v, mask=causal).reshape(B, S, -1)
        x = x + linear(p["out"], attn)
        h = _ln_affine(p["ln2"], x, eps)
        x = x + linear(p["fc2"], act(linear(p["fc1"], h)))
    x = _ln_affine(params["final_ln"], x, eps)
    eos_pos = torch.argmax((ids == cfg.eos_token_id).to(torch.int32), dim=-1)
    pooled = x[torch.arange(B, device=ids.device), eos_pos]
    return x, pooled


def _clip_names(cfg: CLIPTextConfig):
    def lin(k):
        return {"kernel": (f"text_model.{k}.weight", "t"),
                "bias": (f"text_model.{k}.bias", "vec")}

    def ln(k):
        return {"weight": (f"text_model.{k}.weight", "vec"),
                "bias": (f"text_model.{k}.bias", "vec")}

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
        "token_embedding": ("text_model.embeddings.token_embedding.weight", "vec"),
        "position_embedding": ("text_model.embeddings.position_embedding.weight",
                               "vec"),
        "final_ln": ln("final_layer_norm"),
    }
    return top, blocks


def convert_clip_text(sd, cfg: CLIPTextConfig, device="cuda",
                      dtype: torch.dtype = torch.float32) -> Params:
    """An HF CLIPTextModel state dict (``text_model.*`` names, torch
    layout) -> the parameter tree on ``device`` in ``dtype``."""
    top, blocks = _clip_names(cfg)
    out = _materialize(top, sd, device, dtype)
    out["blocks"] = _materialize(blocks, sd, device, dtype, cfg.num_layers)
    return {k: out[k] for k in ("token_embedding", "position_embedding",
                                "blocks", "final_ln")}


def clip_config_from_sd(sd) -> CLIPTextConfig:
    """The config of a state dict's shapes (``max_positions`` stays 77, as
    in the JAX package; the forward slices the table to the ids)."""
    V, D = _shape(sd, "text_model.embeddings.token_embedding.weight")
    Fd = _shape(sd, "text_model.encoder.layers.0.mlp.fc1.weight")[0]
    n = 0
    while f"text_model.encoder.layers.{n}.layer_norm1.weight" in sd:
        n += 1
    return dataclasses.replace(
        CLIPTextConfig(), vocab_size=V, hidden_size=D, mlp_dim=Fd, num_layers=n)


# ----------------------------------------------------------------- T5 enc


@dataclasses.dataclass(frozen=True)
class T5EncoderConfig:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_buckets: int = 32
    relative_max_distance: int = 128
    gated_act: bool = True  # v1.1 gated-GELU; False = legacy ReLU
    layer_norm_eps: float = 1e-6

    @staticmethod
    def t5_v1_1_xxl() -> "T5EncoderConfig":
        return T5EncoderConfig()


def init_t5_encoder_params(generator: torch.Generator, cfg: T5EncoderConfig,
                           device="cuda") -> Params:
    """A seeded f32 tree of the JAX init's shapes and laws on ``device``:
    the embedding N(0, 1), the relative bias N(0, 0.02²), bias-free
    linear kernels uniform(±1/sqrt(d_in)), RMS weights 1.  T5-XXL is 4.7
    B parameters, about 19 GB."""
    d, inner, L = cfg.d_model, cfg.num_heads * cfg.d_kv, (cfg.num_layers,)
    blocks = {
        "ln_attn": ("ones", (*L, d)),
        "q": linear_spec(d, inner, bias=False, lead=L),
        "k": linear_spec(d, inner, bias=False, lead=L),
        "v": linear_spec(d, inner, bias=False, lead=L),
        "o": linear_spec(inner, d, bias=False, lead=L),
        "ln_ff": ("ones", (*L, d)),
        "wo": linear_spec(cfg.d_ff, d, bias=False, lead=L),
    }
    if cfg.gated_act:
        blocks["wi_0"] = linear_spec(d, cfg.d_ff, bias=False, lead=L)
        blocks["wi_1"] = linear_spec(d, cfg.d_ff, bias=False, lead=L)
    else:
        blocks["wi"] = linear_spec(d, cfg.d_ff, bias=False, lead=L)
    spec = {
        "embedding": ("normal", (cfg.vocab_size, d), 1.0),
        "relative_bias": ("normal", (cfg.relative_buckets, cfg.num_heads), 0.02),
        "blocks": blocks,
        "final_ln": ("ones", (d,)),
    }
    return init_from_spec(spec, generator, device=device)


def _t5_relative_buckets(S: int, num_buckets: int, max_distance: int,
                         device="cpu") -> torch.Tensor:
    """Bidirectional T5 relative-position bucket ids [S, S] (HF
    ``_relative_position_bucket``: a sign half, exact small distances,
    log-spaced large ones).  The log is taken in f32 on the CPU and
    truncated toward zero, as the JAX package does, so the ids are the
    same integers on every device; the result is then moved to
    ``device``."""
    pos = torch.arange(S)
    rel = pos[None, :] - pos[:, None]
    half = num_buckets // 2
    buckets = (rel > 0).to(torch.int32) * half
    rel = torch.abs(rel)
    max_exact = half // 2
    large = max_exact + (
        torch.log(torch.clamp(rel, min=1).to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (half - max_exact)
    ).to(torch.int32)
    large = torch.clamp(large, max=half - 1)
    return (buckets + torch.where(rel < max_exact, rel.to(torch.int32),
                                  large)).to(device)


@exact_f32()
def t5_encoder_forward(
    params: Params,
    cfg: T5EncoderConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """input_ids [B, S] -> last_hidden_state [B, S, d_model].

    ``attention_mask`` [B, S] (nonzero attends) is optional; the FLUX
    prompt path passes input_ids only."""
    ids = input_ids.long()
    B, S = ids.shape
    x = params["embedding"][ids]
    buckets = _t5_relative_buckets(S, cfg.relative_buckets,
                                   cfg.relative_max_distance, ids.device)
    # [S, S, H] -> [1, H, S, S], shared by every layer
    bias = params["relative_bias"][buckets.long()].permute(2, 0, 1)[None]
    if attention_mask is not None:
        bias = bias + torch.where(attention_mask.bool(), 0.0, -1e9)[:, None, None, :]
    H, Dk = cfg.num_heads, cfg.d_kv
    for i in range(params["blocks"]["q"]["kernel"].shape[0]):
        p = _layer(params["blocks"], i)
        h = rms_norm(x, p["ln_attn"], cfg.layer_norm_eps)
        q = linear(p["q"], h).reshape(B, S, H, Dk)
        k = linear(p["k"], h).reshape(B, S, H, Dk)
        v = linear(p["v"], h).reshape(B, S, H, Dk)
        # T5 attention is UNSCALED
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() + bias
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, -1)
        x = x + linear(p["o"], attn)
        h = rms_norm(x, p["ln_ff"], cfg.layer_norm_eps)
        if cfg.gated_act:
            ff = gelu_tanh(linear(p["wi_0"], h)) * linear(p["wi_1"], h)
        else:
            ff = F.relu(linear(p["wi"], h))
        x = x + linear(p["wo"], ff)
    return rms_norm(x, params["final_ln"], cfg.layer_norm_eps)


def _t5_names(cfg: T5EncoderConfig):
    pre = "encoder.block.{i}.layer"

    def lin(k):
        return {"kernel": (f"{k}.weight", "t")}

    blocks = {
        "ln_attn": (f"{pre}.0.layer_norm.weight", "vec"),
        "q": lin(f"{pre}.0.SelfAttention.q"),
        "k": lin(f"{pre}.0.SelfAttention.k"),
        "v": lin(f"{pre}.0.SelfAttention.v"),
        "o": lin(f"{pre}.0.SelfAttention.o"),
        "ln_ff": (f"{pre}.1.layer_norm.weight", "vec"),
        "wo": lin(f"{pre}.1.DenseReluDense.wo"),
    }
    if cfg.gated_act:
        blocks["wi_0"] = lin(f"{pre}.1.DenseReluDense.wi_0")
        blocks["wi_1"] = lin(f"{pre}.1.DenseReluDense.wi_1")
    else:
        blocks["wi"] = lin(f"{pre}.1.DenseReluDense.wi")
    top = {
        "embedding": ("shared.weight", "vec"),
        "relative_bias": ("encoder.block.0.layer.0.SelfAttention."
                          "relative_attention_bias.weight", "vec"),
        "final_ln": ("encoder.final_layer_norm.weight", "vec"),
    }
    return top, blocks


def convert_t5_encoder(sd, cfg: T5EncoderConfig, device="cuda",
                       dtype: torch.dtype = torch.float32) -> Params:
    """An HF T5EncoderModel state dict -> the parameter tree on ``device``
    in ``dtype``."""
    top, blocks = _t5_names(cfg)
    out = _materialize(top, sd, device, dtype)
    out["blocks"] = _materialize(blocks, sd, device, dtype, cfg.num_layers)
    return {k: out[k] for k in ("embedding", "relative_bias", "blocks",
                                "final_ln")}


def t5_config_from_sd(sd) -> T5EncoderConfig:
    V, D = _shape(sd, "shared.weight")
    n_buckets, H = _shape(
        sd, "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight")
    inner = _shape(sd, "encoder.block.0.layer.0.SelfAttention.q.weight")[0]
    gated = "encoder.block.0.layer.1.DenseReluDense.wi_0.weight" in sd
    ff_key = "wi_0" if gated else "wi"
    Fd = _shape(sd, f"encoder.block.0.layer.1.DenseReluDense.{ff_key}.weight")[0]
    n = 0
    while f"encoder.block.{n}.layer.0.layer_norm.weight" in sd:
        n += 1
    return dataclasses.replace(
        T5EncoderConfig(), vocab_size=V, d_model=D, d_kv=inner // H, d_ff=Fd,
        num_layers=n, num_heads=H, relative_buckets=n_buckets, gated_act=gated)
