"""LTM (texture-function VAE) training (port of unitex_tpu/training/ltm.py).

The model is ``models/ltm.py``.  Batches are coloured surface samplings,
split into an encoder ("visible") set and a supervision ("query") set;
the objective is the masked-field reconstruction plus KL of
``models/ltm.ltm_vae_loss``.  The procedural data of
``scripts/train_ltm.py`` lives on the device: a bank of surface points
built once on the host (``build_point_bank``), and per step a random
smooth colour field (``random_field_colors``) with contiguous occlusion
holes (``occlusion_split``).

The optimizer is optax's ``chain(clip_by_global_norm, adamw)`` with
adamw's defaults, as ``training/flux_lora.ClippedAdamW`` computes it.
Every function that draws takes its draws as an argument or draws them
from a ``torch.Generator`` (``field_draws``, ``occlusion_draws``), so a
test can feed it the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..geometry.io.mesh_io import HostMesh
from ..models.ltm import LTMConfig, init_ltm_params, ltm_vae_loss
from ..utils.precision import exact_f32
from .flux_lora import ClippedAdamW, _backward, _grads, _leaves, _zero_grads

Draws = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LTMTrainConfig:
    learning_rate: float = 1e-4
    kl_weight: float = 1e-4
    max_grad_norm: float = 1.0
    n_visible: int = 4096
    n_query: int = 2048


@dataclasses.dataclass
class LTMTrainState:
    """The step count, the parameter tree (f32 leaves with
    ``requires_grad``) and the optimizer state; ``ltm_train_step`` updates
    it in place."""

    step: int
    params: Dict[str, Any]
    opt_state: Dict[str, Any]


def create_ltm_state(
    generator: torch.Generator, cfg: LTMConfig, tcfg: LTMTrainConfig,
    schedule: Optional[Callable[[int], float]] = None, device="cuda",
) -> Tuple[LTMTrainState, ClippedAdamW]:
    """A seeded tree (``init_ltm_params`` on ``device``, whose generator
    ``generator`` must live there) and the clipped AdamW with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4); the learning
    rate is ``tcfg.learning_rate`` or ``schedule(count)``."""
    params = init_ltm_params(generator, cfg, device=device)
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    lr = schedule or (lambda count: tcfg.learning_rate)
    tx = ClippedAdamW(lr, 0.9, 0.999, 1e-8, 1e-4, tcfg.max_grad_norm)
    return LTMTrainState(step=0, params=params, opt_state=tx.init(params)), tx


def ltm_train_step(
    state: LTMTrainState,
    batch: Dict[str, torch.Tensor],
    cfg: LTMConfig,
    tcfg: LTMTrainConfig,
    tx: ClippedAdamW,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[LTMTrainState, torch.Tensor]:
    """One optimizer step; returns (state, loss).  batch: 'points' [N, 3],
    'colors' [N, C], 'valid' [N] (the encoder set), 'query_points' [M, 3],
    'query_colors' [M, C].  ``noise`` is the encoder's standard normal
    draw [n_latents, kl_latent_dim], drawn from ``generator`` when not
    given.  No host sync."""
    if noise is None:
        noise = torch.randn((cfg.n_latents, cfg.kl_latent_dim),
                            generator=generator, device=batch["points"].device)
    _zero_grads(state.params)
    loss = ltm_vae_loss(
        state.params, cfg, batch["points"], batch["colors"], batch["valid"],
        batch["query_points"], batch["query_colors"], noise,
        kl_weight=tcfg.kl_weight)
    _backward(loss)
    tx.step(state.params, _grads(state.params), state.opt_state)
    _zero_grads(state.params)
    state.step += 1
    return state, loss.detach()


@dataclasses.dataclass(frozen=True)
class LTMCurriculum:
    """Field family and occlusion-hole parameters of the procedural
    training and evaluation data.

    The defaults keep every feature's length scale above the largest hole
    diameter, so the hidden colours can be inferred from the visible
    context; ``r04()`` puts much of the field's energy at or below the
    hole scale (the flat-curve settings, kept for A/B diagnosis)."""

    n_fourier: int = 10
    max_freq: float = 1.2        # |freq|·r_max < ~1 rad: inferable
    n_rbf: int = 6
    sig_min: float = 0.35        # blob radius >= hole radius
    sig_max: float = 0.8
    n_holes: int = 6
    r_min: float = 0.08
    r_max: float = 0.25

    @classmethod
    def r04(cls) -> "LTMCurriculum":
        """The flat-curve settings, kept for A/B diagnosis."""
        return cls(max_freq=2.5, sig_min=0.15, sig_max=0.6, r_max=0.35)

    @classmethod
    def affine_only(cls) -> "LTMCurriculum":
        """Pure affine fields: the can-it-learn-at-all diagnostic."""
        return cls(n_fourier=0, n_rbf=0)


def _uniform(shape, lo, hi, generator, device):
    return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo


def field_draws(generator: Optional[torch.Generator], cur: LTMCurriculum,
                device="cuda") -> Draws:
    """The draws of one random field: the affine matrix ``A`` [3, 3] (N(0,
    0.8²)), ``freqs`` [F, 3] (uniform ±max_freq), ``phase`` [F] (uniform
    [0, 2π)), ``w`` [F, 3] (N(0, 1/F)), RBF centres ``mu`` [R, 3] (uniform
    ±1), ``sig`` [R] (uniform [sig_min, sig_max)), ``amp`` [R, 3] (N(0,
    0.7²)); the Fourier and RBF draws only where the curriculum has them."""
    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    d = {"A": normal((3, 3), 0.8)}
    if cur.n_fourier:
        F = cur.n_fourier
        d["freqs"] = _uniform((F, 3), -cur.max_freq, cur.max_freq,
                              generator, device)
        d["phase"] = _uniform((F,), 0.0, 2 * math.pi, generator, device)
        d["w"] = normal((F, 3), 1.0 / math.sqrt(F))
    if cur.n_rbf:
        R = cur.n_rbf
        d["mu"] = _uniform((R, 3), -1.0, 1.0, generator, device)
        d["sig"] = _uniform((R,), cur.sig_min, cur.sig_max, generator, device)
        d["amp"] = normal((R, 3), 0.7)
    return d


def random_field_colors(
    points: torch.Tensor,
    cur: LTMCurriculum = LTMCurriculum(),
    draws: Optional[Draws] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """A random smooth RGB field at ``points`` [N, 3] -> [N, 3] in [0.05,
    0.95]: an affine field, low-frequency Fourier components and RBF
    blobs (``draws``, or ``field_draws`` from ``generator``), normalized
    per channel to a fixed range that keeps the sigmoid decode head
    responsive."""
    d = draws if draws is not None else field_draws(generator, cur, points.device)
    with exact_f32():
        g = points @ d["A"].T
        if cur.n_fourier:
            ang = points @ d["freqs"].T + d["phase"]                 # [N, F]
            g = g + torch.sin(ang) @ d["w"]
        if cur.n_rbf:
            d2 = torch.sum((points[:, None, :] - d["mu"][None]) ** 2, -1)
            g = g + torch.exp(-d2 / (2 * d["sig"] ** 2)) @ d["amp"]
    lo = torch.amin(g, dim=0, keepdim=True)
    hi = torch.amax(g, dim=0, keepdim=True)
    return 0.05 + 0.9 * (g - lo) / torch.clamp(hi - lo, min=1e-6)


def occlusion_draws(generator: Optional[torch.Generator], n_points: int,
                    cur: LTMCurriculum, device="cuda") -> Draws:
    """The draws of one occlusion split: hole ``centers`` [n_holes] (point
    indices), ``radii`` [n_holes] (uniform [r_min, r_max)) and the query
    ``shuffle`` [N] (uniform [0, 1))."""
    return {
        "centers": torch.randint(0, n_points, (cur.n_holes,),
                                 generator=generator, device=device),
        "radii": _uniform((cur.n_holes,), cur.r_min, cur.r_max, generator,
                          device),
        "shuffle": torch.rand((n_points,), generator=generator, device=device),
    }


def occlusion_split(
    points: torch.Tensor,
    colors: torch.Tensor,
    n_query: int,
    cur: LTMCurriculum = LTMCurriculum(),
    draws: Optional[Draws] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """An occlusion-shaped batch: contiguous spherical holes around random
    surface points are hidden from the encoder (valid=False) and
    supervised as queries, as occluded texels form contiguous patches at
    inference.  The encoder keeps all N points with a validity mask; the
    queries are the hole points first (shuffled), topped up with visible
    points; ``query_in_hole`` marks the occluded ones, which the holdout
    metric scores."""
    N = points.shape[0]
    d = draws if draws is not None else occlusion_draws(generator, N, cur,
                                                        points.device)
    centers = points[d["centers"]]
    d2 = torch.sum((points[:, None, :] - centers[None]) ** 2, -1)
    in_hole = torch.any(d2 < d["radii"][None] ** 2, dim=-1)
    key = torch.where(in_hole, d["shuffle"], 1.0 + d["shuffle"])
    qidx = torch.argsort(key, stable=True)[:n_query]
    return {
        "points": points,
        "colors": colors,
        "valid": ~in_hole,
        "query_points": points[qidx],
        "query_colors": colors[qidx],
        "query_in_hole": in_hole[qidx],
    }


def sample_device_batch(
    points: torch.Tensor, n_query: int, cur: LTMCurriculum = LTMCurriculum(),
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """One data step on the device: a fresh random field and fresh
    occlusion holes on a surface point set of the bank, drawn from
    ``generator`` (the field first)."""
    colors = random_field_colors(points, cur, generator=generator)
    return occlusion_split(points, colors, n_query, cur, generator=generator)


@torch.no_grad()
def idw_fill_baseline(
    points: torch.Tensor,
    colors: torch.Tensor,
    valid: torch.Tensor,
    queries: torch.Tensor,
    k: int = 8,
) -> torch.Tensor:
    """The k-NN inverse-distance-weighted fill (the bake's default
    ``_fill_invisible_knn`` math) on a point batch: the bar the LTM must
    beat, computed on the same batches."""
    d2 = torch.sum((queries[:, None, :] - points[None]) ** 2, -1)   # [M, N]
    d2 = torch.where(valid[None], d2, torch.full_like(d2, float("inf")))
    neg, idx = torch.topk(-d2, k, dim=-1)                          # [M, k]
    w = 1.0 / torch.clamp(-neg, min=1e-12)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return torch.einsum("mk,mkc->mc", w, colors[idx])


def build_point_bank(n_meshes: int, n_points: int, seed: int = 0) -> np.ndarray:
    """On the host, once: area-weighted surface samples of randomized
    primitives (icospheres, tori, trefoils, compounds and cups with
    jittered parameters) -> [n_meshes, n_points, 3], each scaled to a
    largest coordinate of 0.85; bit for bit the JAX package's bank."""
    from ..geometry.primitives import (
        make_compound, make_cup, make_icosphere, make_torus, make_trefoil,
    )
    from ..geometry.sampling import sample_surface

    rng = np.random.default_rng(seed)
    bank = np.empty((n_meshes, n_points, 3), np.float32)
    for i in range(n_meshes):
        kind = i % 5
        if kind == 0:
            m = make_icosphere(3, radius=float(rng.uniform(0.6, 1.0)))
        elif kind == 1:
            m = make_torus(
                major_radius=float(rng.uniform(0.5, 0.8)),
                minor_radius=float(rng.uniform(0.15, 0.35)),
                n_major=64, n_minor=32,
            )
        elif kind == 2:
            m = make_trefoil(
                tube_radius=float(rng.uniform(0.15, 0.3)),
                n_major=128, n_minor=24,
            )
        elif kind == 3:
            m = make_compound(subdivisions=3, n_major=64, n_minor=24)
        else:
            m = make_cup(
                radius=float(rng.uniform(0.4, 0.6)),
                wall=float(rng.uniform(0.06, 0.12)),
                n_theta=64,
                tilt_deg=float(rng.uniform(0.0, 50.0)),
            )
        pts, _ = sample_surface(m, n_points, seed=int(rng.integers(1 << 31)))
        bank[i] = 0.85 * pts / max(1e-6, np.abs(pts).max())
    return bank


def sample_ltm_batch(
    mesh: HostMesh, tcfg: LTMTrainConfig, seed: int = 0, device="cuda",
) -> Dict[str, torch.Tensor]:
    """A batch from a textured mesh: coloured area-weighted surface samples
    (host), split into encoder and query sets, on ``device``."""
    from ..texture.remapping import _sample_source_colors

    n = tcfg.n_visible + tcfg.n_query
    pts, cols = _sample_source_colors(mesh, n, seed)
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(n)
    vis, qry = perm[: tcfg.n_visible], perm[tcfg.n_visible:]

    def t(x):
        return torch.as_tensor(x, device=device)

    return {
        "points": t(pts[vis]),
        "colors": t(cols[vis]),
        "valid": torch.ones((tcfg.n_visible,), dtype=torch.bool, device=device),
        "query_points": t(pts[qry]),
        "query_colors": t(cols[qry]),
    }
