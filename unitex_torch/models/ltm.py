"""LTM — a texture-function VAE, the learned inpainting field of the bake
(port of unitex_tpu/models/ltm.py).

* ``encode_geometry`` — a perceiver-style set encoder: visible surface
  points (position + colour, Fourier-featurized) are cross-attended into a
  fixed set of latent tokens, then self-attended (posterior mean/logvar).
* ``decode_field``   — query points cross-attend the latents through a
  small MLP head; with ``kernel_decode`` the base prediction is a soft
  distance-kernel regression over the visible context and the latent path
  adds a gated logit residual.
* ``make_query_field`` — the bake's ``query_field`` hook built from a tree
  and its config.

The repo's trained tree (``ltm_params.npz``, ``LTMConfig.large()``) reads
with ``utils/param_cache.load_params``; its meta holds the config.  Trees
are the JAX package's layout (``self_blocks`` and ``cross_more`` are
lists), so ``utils/params.params_from_jax`` carries a JAX tree across.
Every product is f32 without TF32: the kernel decode's
d² = |q|² - 2 q·p + |p|² is cancellation-prone.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..render.renderer_inverse import _select_masked_points
from ..utils.params import init_from_spec, linear_spec
from ..utils.precision import exact_f32
from ..utils.timer import CPUTimer
from .flux.layers import Params, gelu_tanh, layer_norm, linear


@dataclasses.dataclass(frozen=True)
class LTMConfig:
    n_latents: int = 256
    latent_dim: int = 256
    n_heads: int = 8
    n_self_layers: int = 4
    n_fourier: int = 8           # position Fourier bands
    color_dim: int = 3
    kl_latent_dim: int = 64      # bottleneck channel per latent token
    # encoder context reads: > 1 interleaves extra latent -> token
    # cross-attention reads between the self blocks
    n_cross_layers: int = 1
    # the geometry-aware decoder: softmax(-|q - p|² / tau²) regression over
    # the visible context, plus a gated latent residual in logit space
    kernel_decode: bool = False
    kernel_tau: float = 0.15     # initial kernel bandwidth (unit-box scale)

    @classmethod
    def tiny(cls) -> "LTMConfig":
        return cls(n_latents=16, latent_dim=32, n_heads=2, n_self_layers=1,
                   n_fourier=4, kl_latent_dim=8)

    @classmethod
    def large(cls) -> "LTMConfig":
        """About 4x the default capacity and the kernel decoder: the
        configuration of the repo's trained ``ltm_params.npz``."""
        return cls(n_latents=384, latent_dim=384, n_heads=8,
                   n_self_layers=6, kl_latent_dim=128, n_cross_layers=2,
                   kernel_decode=True)


def fourier_features(x: torch.Tensor, n_bands: int) -> torch.Tensor:
    """[., 3] -> [., 3 + 6 * n_bands] positional encoding."""
    freqs = 2.0 ** torch.arange(n_bands, dtype=torch.float32,
                                device=x.device) * math.pi
    ang = x[..., None] * freqs                                  # [., 3, B]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


def _mha(p, cfg: LTMConfig, q_in, kv_in, kv_mask=None):
    """Multi-head attention of ``q_in`` [Q, D] over ``kv_in`` [K, D];
    masked keys get logit -1e9 before the softmax."""
    H = cfg.n_heads

    def heads(x):
        return x.reshape(*x.shape[:-1], H, -1)

    q = heads(linear(p["q"], q_in))
    k = heads(linear(p["k"], kv_in))
    v = heads(linear(p["v"], kv_in))
    logits = torch.einsum("...qhd,...khd->...hqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    if kv_mask is not None:
        logits = torch.where(kv_mask[..., None, None, :], logits,
                             torch.full_like(logits, -1e9))
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("...hqk,...khd->...qhd", attn, v)
    return linear(p["o"], out.reshape(*q_in.shape[:-1], -1))


def _block(p, cfg: LTMConfig, x):
    x = x + _mha(p["attn"], cfg, layer_norm(x), layer_norm(x))
    return x + linear(p["ff_out"], gelu_tanh(linear(p["ff_in"], layer_norm(x))))


def _mha_spec(d):
    return {name: linear_spec(d, d) for name in ("q", "k", "v", "o")}


def init_ltm_params(generator: torch.Generator, cfg: LTMConfig,
                    device="cuda") -> Params:
    """A random tree in the JAX package's layout (f32): latents
    N(0, 0.02²), linear kernels uniform(±1/sqrt(d_in)) with zero biases,
    ``kernel_log_tau = log(kernel_tau)`` and a zero ``residual_gate`` (the
    decode is exactly the kernel regression at init).  ``generator`` must
    live on ``device``."""
    d = cfg.latent_dim
    in_dim = 3 + 6 * cfg.n_fourier + cfg.color_dim
    spec = {
        "latents": ("normal", (cfg.n_latents, d), 0.02),
        "point_embed": linear_spec(in_dim, d),
        "query_embed": linear_spec(in_dim - cfg.color_dim, d),
        "cross_in": _mha_spec(d),
        "to_mean": linear_spec(d, cfg.kl_latent_dim),
        "to_logvar": linear_spec(d, cfg.kl_latent_dim),
        "from_latent": linear_spec(cfg.kl_latent_dim, d),
        "cross_out": _mha_spec(d),
        "head_in": linear_spec(d, d),
        "head_out": linear_spec(d, cfg.color_dim),
        "self_blocks": [{"attn": _mha_spec(d), "ff_in": linear_spec(d, 4 * d),
                         "ff_out": linear_spec(4 * d, d)}
                        for _ in range(cfg.n_self_layers)],
    }
    if cfg.n_cross_layers > 1:
        spec["cross_more"] = [_mha_spec(d) for _ in range(cfg.n_cross_layers - 1)]
    params = init_from_spec(spec, generator, device=device)
    if cfg.kernel_decode:
        params["kernel_log_tau"] = torch.log(
            torch.tensor(cfg.kernel_tau, dtype=torch.float32, device=device))
        params["residual_gate"] = torch.zeros((), dtype=torch.float32, device=device)
    return params


@exact_f32()
def encode_geometry(
    params: Params, cfg: LTMConfig, points: torch.Tensor, colors: torch.Tensor,
    valid: torch.Tensor, noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Visible coloured surface points -> latent tokens.

    points [N, 3], colors [N, C], valid [N] -> (latents [L, D_kl], mean,
    logvar).  The latents are the mean, or with ``noise`` (a standard
    normal draw [L, D_kl]) the reparameterized sample."""
    feats = torch.cat([fourier_features(points, cfg.n_fourier), colors], -1)
    tokens_n = layer_norm(linear(params["point_embed"], feats))
    lat = params["latents"]
    crosses = [params["cross_in"]] + list(params.get("cross_more", []))
    blocks = list(params["self_blocks"])
    per = max(1, len(blocks) // len(crosses))
    for ci, cp in enumerate(crosses):
        lat = lat + _mha(cp, cfg, layer_norm(lat), tokens_n, valid)
        hi = len(blocks) if ci == len(crosses) - 1 else (ci + 1) * per
        for blk in blocks[ci * per:hi]:
            lat = _block(blk, cfg, lat)
    mean = linear(params["to_mean"], layer_norm(lat))
    logvar = torch.clamp(linear(params["to_logvar"], layer_norm(lat)), -30.0, 20.0)
    z = mean if noise is None else mean + torch.exp(0.5 * logvar) * noise
    return z, mean, logvar


@exact_f32()
def decode_field(
    params: Params, cfg: LTMConfig, z: torch.Tensor, queries: torch.Tensor,
    ctx: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Latents [L, D_kl] + query points [M, 3] -> colours [M, C].

    With ``cfg.kernel_decode`` and ``ctx = (points [N, 3], colors [N, C],
    valid [N])``: softmax(-|q - p|² / tau²) over the valid context, clipped
    to (1e-4, 1 - 1e-4), plus the latent path's logit residual scaled by
    ``residual_gate``.  Without ctx the latent path alone decodes."""
    lat = linear(params["from_latent"], z)
    q = linear(params["query_embed"], fourier_features(queries, cfg.n_fourier))
    h = q + _mha(params["cross_out"], cfg, layer_norm(q), layer_norm(lat))
    res = linear(params["head_out"], gelu_tanh(linear(params["head_in"], layer_norm(h))))
    if not (cfg.kernel_decode and ctx is not None):
        return torch.sigmoid(res)
    pts, cols, val = ctx
    tau2 = torch.exp(2.0 * params["kernel_log_tau"])
    d2 = (torch.sum(queries ** 2, -1, keepdim=True) - 2.0 * queries @ pts.T
          + torch.sum(pts ** 2, -1)[None])                     # [M, N]
    logits = torch.where(val[None], -d2 / torch.clamp(tau2, min=1e-6),
                         torch.full_like(d2, -1e9))
    base = torch.clamp(torch.softmax(logits, dim=-1) @ cols, 1e-4, 1.0 - 1e-4)
    return torch.sigmoid(torch.log(base / (1.0 - base))
                         + params["residual_gate"] * res)


def _subsample_context(points, colors, mask, max_ref: int):
    """Up to ``max_ref`` valid points spread over the set: the golden-ratio
    hash order of the bake's ``_select_masked_points`` (valid first, a
    stable sort of int64 keys); the whole set when it is no larger."""
    if points.shape[0] <= max_ref:
        return points, colors, mask
    return _select_masked_points(points, colors, mask, max_ref)


def make_query_field(params: Params, cfg: LTMConfig, chunk: int = 65536,
                     max_ref: int = 16384):
    """The bake's ``query_field`` hook: encode the visible coloured points
    once (subsampled to ``max_ref``), decode colours at the query points in
    ``chunk``-row slices (with ``kernel_decode`` the slice holds a
    [chunk, max_ref] kernel matrix, so the chunk shrinks to 80 MiB of it:
    5120 rows at max_ref 16384).

    With ``query_mask`` only those queries are decoded (each row's decode
    depends on no other row) and the rest of the returned [M, C] is zero;
    the bake keeps only the masked rows.  The encode and decode times are
    recorded under ``CPUTimer`` as "ltm_encode" and "ltm_decode"."""
    if cfg.kernel_decode:
        chunk = min(chunk, max(1, (80 << 20) // max(1, max_ref)))

    @torch.no_grad()
    def query_field(vertices_visible, colors_visible, vertices_query,
                    visible_mask=None, query_mask=None):
        if visible_mask is None:
            visible_mask = torch.ones(vertices_visible.shape[0], dtype=torch.bool,
                                      device=vertices_visible.device)
        with CPUTimer("ltm_encode", verbose=False):
            pts, cols, val = _subsample_context(
                vertices_visible, colors_visible, visible_mask, max_ref)
            z, _, _ = encode_geometry(params, cfg, pts, cols, val)
        ctx = (pts, cols, val)
        with CPUTimer("ltm_decode", verbose=False):
            rows = None
            queries = vertices_query
            if query_mask is not None:
                rows = torch.nonzero(query_mask).reshape(-1)   # host sync
                queries = vertices_query[rows]
            out = torch.empty((queries.shape[0], cfg.color_dim),
                              dtype=torch.float32, device=queries.device)
            for q0 in range(0, queries.shape[0], chunk):
                out[q0:q0 + chunk] = decode_field(params, cfg, z,
                                                  queries[q0:q0 + chunk], ctx=ctx)
            if rows is not None:
                dense = torch.zeros((vertices_query.shape[0], cfg.color_dim),
                                    dtype=out.dtype, device=out.device)
                out = dense.index_copy_(0, rows, out)
        return out

    return query_field


@exact_f32()
def ltm_vae_loss(
    params: Params, cfg: LTMConfig, points: torch.Tensor, colors: torch.Tensor,
    valid: torch.Tensor, query_points: torch.Tensor,
    query_colors: torch.Tensor, noise: Optional[torch.Tensor] = None,
    kl_weight: float = 1e-4,
) -> torch.Tensor:
    """Reconstruction + KL training objective of the texture-function VAE;
    ``noise`` is the encoder's standard normal draw (None: the mean)."""
    z, mean, logvar = encode_geometry(params, cfg, points, colors, valid, noise)
    pred = decode_field(params, cfg, z, query_points, ctx=(points, colors, valid))
    rec = torch.mean((pred - query_colors) ** 2)
    kl = -0.5 * torch.mean(1 + logvar - mean ** 2 - torch.exp(logvar))
    return rec + kl_weight * kl
