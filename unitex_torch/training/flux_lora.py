"""LoRA training for the FLUX MMDiT: the flow-matching objective (port of
unitex_tpu/training/flux_lora.py).

Logit-normal or uniform timestep sampling, the flow-match interpolation
z_t = (1−σ)x + σε with shift 3, packed-token conditioning identical to
inference, optional random token dropping with the loss on the kept
tokens, the velocity target ε − x, sigma-based loss weighting and prior
preservation.  Only the LoRA tree receives gradients; the base tree is
frozen.  The LoRA of each block is merged inside the block
(``flux_forward(..., lora=...)``), under ``remat`` inside its checkpoint,
so at most one layer's merged kernels are alive; attention gradients go
through kernels B2a/B2b on the card.

The optimizer is AdamW or Prodigy behind a global-norm clip with optax's
semantics (``optax.chain(clip_by_global_norm, adamw |
contrib.prodigy)``), updating the LoRA tree in place.  The
preconditioning pixel loss decodes the x0 prediction through the frozen
VAE under autograd (``vae_decode_with_grad``, its blocks checkpointed)
and adds a weighted MSE against the target pixels.  Randomness comes from
a ``torch.Generator``; ``flow_match_loss`` also takes the draws
themselves (``u``, ``noise``, ``keep_idx``), so a test can feed it the
JAX package's.

Across ranks (``parallel/mesh.py``), as the JAX package's GSPMD step
computes the logical one: under tensor parallelism the base and adapter
trees are this rank's slices (``parallel/sharding.shard_flux_params``)
and ``cfg`` is ``tp_config``'s; with ``data_axis`` the global batch, drawn
whole, is cut over the data ranks inside the forward and the prediction
gathered (``parallel/collectives.gather_from``), so every rank computes
the logical loss; with ``pipe_axis`` the block stacks run the GPipe
schedule of ``models/flux/pp.flux_forward_pp`` (the batch cut over
``pipe_data_axis``).  ``train_step`` then sums each rank's adapter
gradients into the logical tree's (``collectives.reduce_grads``), and the
optimizers take the global norm and Prodigy's sums over the logical tree
(``collectives.tree_sum``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..models.flux.config import FluxConfig
from ..models.flux.lora import init_lora_params
from ..models.flux.model import flux_forward
from ..models.flux.pipeline import latent_image_ids, pack_latents, unpack_latents
from ..models.flux.vae import vae_decode_with_grad
from ..utils.precision import exact_f32
from .checkpoint import _detached, _like


@dataclasses.dataclass(frozen=True)
class FluxLoraTrainConfig:
    rank: int = 16
    learning_rate: float = 1e-4
    weight_decay: float = 1e-2
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    optimizer: str = "adamw"             # adamw | prodigy
    lr_scheduler: str = "constant"       # constant | constant_with_warmup |
                                         # cosine | linear
    warmup_steps: int = 0
    max_train_steps: int = 10_000
    weighting_scheme: str = "none"       # none | sigma_sqrt | logit_normal | cosmap
    logit_mean: float = 0.0
    logit_std: float = 1.0
    guidance_scale: float = 1.0          # guidance embed value during training
    drop_rate: float = 0.0               # random noise-token dropping
    num_train_timesteps: int = 1000
    # the batch carries [instance; prior] halves along B
    prior_preservation: bool = False
    prior_loss_weight: float = 1.0
    # a pixel-space MSE of the VAE-decoded x0 prediction
    preconditioning_loss: bool = False
    preconditioning_loss_weight: float = 1.0
    # pipeline parallelism: the block stacks staged over this process
    # group (Mesh.group("pipe")), the batch in pipe_n_micro microbatches,
    # each cut over pipe_data_axis (Mesh.group("data"), DP x PP)
    pipe_axis: Any = None
    pipe_n_micro: int = 1
    pipe_data_axis: Any = None

    def __post_init__(self):
        for field in ("pipe_axis", "pipe_data_axis"):
            if isinstance(getattr(self, field), str):
                raise TypeError(f"{field} holds a process group, not the "
                                f"name {getattr(self, field)!r}: pass "
                                f"mesh.group(name)")


@dataclasses.dataclass
class TrainState:
    """The step count, the LoRA tree (f32 leaves with ``requires_grad``)
    and the optimizer state; ``train_step`` updates it in place."""

    step: int
    lora: Dict[str, Any]
    opt_state: Dict[str, Any]


def _leaves(tree) -> List[torch.Tensor]:
    """The leaves of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts and lists)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_map(fn, *(t[i] for t in trees)) for i in range(len(trees[0]))]
    return fn(*trees)


def sample_timestep_density(
    generator: Optional[torch.Generator], batch: int, scheme: str,
    logit_mean: float, logit_std: float, device="cuda",
) -> torch.Tensor:
    """u in (0, 1): diffusers ``compute_density_for_timestep_sampling``."""
    if scheme == "logit_normal":
        z = torch.randn((batch,), generator=generator, device=device)
        return torch.sigmoid(z * logit_std + logit_mean)
    return torch.rand((batch,), generator=generator, device=device)


def loss_weighting(scheme: str, sigmas: torch.Tensor) -> torch.Tensor:
    """diffusers ``compute_loss_weighting_for_sd3``."""
    if scheme == "sigma_sqrt":
        return (sigmas ** -2.0).float()
    if scheme == "cosmap":
        bot = 1.0 - 2.0 * sigmas + 2.0 * sigmas ** 2
        return 2.0 / (math.pi * bot)
    return torch.ones_like(sigmas)


def flow_match_loss(
    lora: Optional[Dict[str, Any]],
    base_params: Dict[str, Any],
    cfg: FluxConfig,
    tcfg: FluxLoraTrainConfig,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    u=None,
    noise=None,
    keep_idx=None,
    vae_params: Optional[Dict[str, Any]] = None,
    vae_cfg=None,
    data_axis=None,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """One flow-matching loss evaluation (a scalar f32 tensor).

    batch: 'latents' [B, H, W, C] clean VAE latents of the target;
    optional 'cond_tokens' [B, S_c, C*4] with 'cond_ids' [S_c, 3];
    'prompt_embeds' [B, S_t, D]; 'pooled_embeds' [B, D_p]; 'pixel_values'
    [B, Hp, Wp, 3] in [0, 1], read only under ``preconditioning_loss``
    (with the frozen ``vae_params``/``vae_cfg``).  The timestep draw ``u``
    [B], the noise [B, H, W, C] and the kept token indices ``keep_idx``
    are drawn from ``generator`` unless given.  ``lora=None`` trains the
    base tree itself (``training/full_finetune.py``), its f32 leaves cast
    to ``compute_dtype`` as they are used when that is given.
    ``data_axis``: the process group the batch is cut over in the forward
    (not with ``tcfg.pipe_axis``, whose forward cuts over
    ``tcfg.pipe_data_axis``)."""
    if tcfg.preconditioning_loss and (vae_params is None or vae_cfg is None):
        raise ValueError("preconditioning_loss needs the frozen VAE "
                         "(vae_params, vae_cfg)")
    x = batch["latents"]
    dev = x.device
    B, H, W, C = x.shape

    if u is None:
        u = sample_timestep_density(generator, B, tcfg.weighting_scheme,
                                    tcfg.logit_mean, tcfg.logit_std, dev)
    u = torch.as_tensor(u, dtype=torch.float32, device=dev)
    # shift 3.0 (the FLUX training default): sigma = shift*u / (1 + (shift-1)*u)
    shift = 3.0
    sigmas = shift * u / (1.0 + (shift - 1.0) * u)
    timesteps = sigmas  # the transformer takes t in [0, 1]

    if noise is None:
        noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                            device=dev)
    noise = torch.as_tensor(noise, dtype=x.dtype, device=dev)
    sig = sigmas[:, None, None, None]
    zt = (1.0 - sig) * x + sig * noise

    tokens = pack_latents(zt)
    noise_ids = latent_image_ids(H // 2, W // 2, device=dev)
    S_noise = S_full = tokens.shape[1]
    target = pack_latents(noise - x)

    if tcfg.drop_rate > 0.0:
        # a fixed-size random subset of the noise tokens enters the
        # sequence (condition and text tokens are kept); the loss is taken
        # on the kept tokens only
        n_keep = max(1, int(S_noise * (1.0 - tcfg.drop_rate)))
        if keep_idx is None:
            perm = torch.randperm(S_noise, generator=generator, device=dev)
            keep_idx = torch.sort(perm[:n_keep]).values
        keep_idx = torch.as_tensor(keep_idx, dtype=torch.int64, device=dev)
        tokens = tokens[:, keep_idx]
        noise_ids = noise_ids[keep_idx]
        target = target[:, keep_idx]
        S_noise = int(keep_idx.shape[0])

    img_ids = noise_ids
    hidden = tokens
    if batch.get("cond_tokens") is not None:
        hidden = torch.cat([tokens, batch["cond_tokens"]], dim=1)
        img_ids = torch.cat([noise_ids, batch["cond_ids"]], dim=0)

    guidance = (torch.full((B,), tcfg.guidance_scale, dtype=torch.float32,
                           device=dev) if cfg.guidance_embeds else None)
    txt_ids = torch.zeros((batch["prompt_embeds"].shape[1], 3),
                          dtype=torch.float32, device=dev)
    args = (hidden, batch["prompt_embeds"], timesteps, batch["pooled_embeds"])
    if tcfg.pipe_axis is not None:
        from ..models.flux.pp import flux_forward_pp

        pred = flux_forward_pp(
            base_params, cfg, *args, img_ids, txt_ids, guidance,
            n_micro=tcfg.pipe_n_micro, pipe_axis=tcfg.pipe_axis,
            data_axis=tcfg.pipe_data_axis, lora=lora,
            compute_dtype=compute_dtype)
    else:
        def forward(h, c, t, pooled, g):
            return flux_forward(base_params, cfg, h, c, t, pooled, img_ids,
                                txt_ids, guidance=g, lora=lora,
                                compute_dtype=compute_dtype)

        pred = _data_parallel(forward, data_axis, *args, guidance)
    pred_noise = pred[:, :S_noise]

    w = loss_weighting(tcfg.weighting_scheme, sigmas)[:, None, None]
    err = (pred_noise.float() - target.float()) ** 2
    if tcfg.prior_preservation:
        if B % 2 != 0:
            raise ValueError(
                "prior_preservation needs an even batch laid out as "
                f"[instance; prior] halves, got batch size {B}")
        e_main, e_prior = torch.chunk(err, 2, dim=0)
        w_main, w_prior = torch.chunk(w, 2, dim=0)
        loss = torch.mean(w_main * e_main) + tcfg.prior_loss_weight * torch.mean(
            w_prior * e_prior)
    else:
        loss = torch.mean(w * err)

    if tcfg.preconditioning_loss:
        if keep_idx is not None:
            # kept predictions back on the full grid; dropped positions
            # predict zero velocity (x0 falls back to zt there)
            pred_noise = torch.zeros(
                (B, S_full, pred_noise.shape[-1]), dtype=pred_noise.dtype,
                device=dev).index_copy(1, keep_idx, pred_noise)
        # the x0 prediction zt − σ·v, in the scaled latent space the
        # decoder takes
        latents_pred = zt - sig * unpack_latents(pred_noise, H, W)
        img_pred = vae_decode_with_grad(vae_params, vae_cfg,
                                        latents_pred) * 0.5 + 0.5
        pix = batch["pixel_values"].float()
        loss = loss + tcfg.preconditioning_loss_weight * torch.mean(
            (img_pred.float() - pix) ** 2)
    return loss


def _data_parallel(forward, data_axis, *batched):
    """``forward`` on this data rank's slice of each batched argument (None
    passes), the ranks' predictions gathered; ``data_axis=None`` is
    ``forward`` on the whole batch."""
    if data_axis is None:
        return forward(*batched)
    from ..parallel.collectives import gather_from

    n, i = dist.get_world_size(data_axis), dist.get_rank(data_axis)
    B = batched[0].shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split over data={n}")
    k = B // n
    local = [None if a is None else a[i * k:(i + 1) * k] for a in batched]
    return gather_from(forward(*local), data_axis, dim=0)


# ------------------------------------------------------------ optimizer


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule``: constant ``init`` when steps <= 0."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int,
            alpha: float = 0.0) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule`` with exponent 1: the decay falls
    from 1 to ``alpha``."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        count = min(count, decay_steps)
        decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * decay + alpha)

    return schedule


def _join(schedules, boundaries) -> Callable[[int], float]:
    """optax ``join_schedules``: past each boundary the next schedule runs
    on the steps counted from that boundary."""

    def schedule(count):
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = s(count - boundary)
        return out

    return schedule


def warmup_cosine_decay_schedule(init: float, peak: float, warmup_steps: int,
                                 decay_steps: int,
                                 end: float = 0.0) -> Callable[[int], float]:
    """optax ``warmup_cosine_decay_schedule`` with exponent 1: linear from
    ``init`` to ``peak`` over ``warmup_steps``, then a cosine to ``end`` at
    ``decay_steps`` (counted from 0, the warmup included)."""
    alpha = 0.0 if peak == 0.0 else end / peak
    return _join([_linear(init, peak, warmup_steps),
                  _cosine(peak, decay_steps - warmup_steps, alpha)],
                 [warmup_steps])


def make_lr_schedule(tcfg: FluxLoraTrainConfig) -> Callable[[int], float]:
    """The learning rate of each update (counted from 0), as the JAX
    package's optax schedule gives it.  Note that
    ``constant_with_warmup`` gives lr 0 at the first update."""
    lr, w = tcfg.learning_rate, tcfg.warmup_steps
    if tcfg.lr_scheduler == "constant":
        return lambda count: lr
    if tcfg.lr_scheduler == "constant_with_warmup":
        return _linear(0.0, lr, w)
    if tcfg.lr_scheduler == "cosine":
        return _join([_linear(0.0, lr, w), _cosine(lr, tcfg.max_train_steps - w)], [w])
    if tcfg.lr_scheduler == "linear":
        return _join([_linear(0.0, lr, max(w, 1)),
                      _linear(lr, 0.0, max(tcfg.max_train_steps - w, 1))], [w])
    raise ValueError(f"unknown lr_scheduler {tcfg.lr_scheduler!r}")


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _tree_sum(values: List[torch.Tensor], axes) -> torch.Tensor:
    """The sum of per-leaf scalars over the logical tree: ``axes[i]`` the
    process groups leaf ``i`` is cut over (``collectives.tree_sum``), or
    ``axes=None`` for a tree on one rank."""
    if axes is None:
        return sum(values)
    from ..parallel.collectives import tree_sum

    return tree_sum(values, axes)


def _clipped(g_leaves: List[torch.Tensor], max_norm: float,
             axes=None) -> List[torch.Tensor]:
    """optax ``clip_by_global_norm``: g · max_norm / ‖g‖ (as ``(g / ‖g‖) ·
    max_norm``) when ‖g‖ >= max_norm, with no epsilon; ‖g‖ over the
    logical tree (``axes``: see :func:`_tree_sum`).  The choice is made
    on the device, so a step makes no host sync."""
    g_norm = torch.sqrt(_tree_sum([torch.sum(g.float() ** 2)
                                   for g in g_leaves], axes))
    keep = g_norm < max_norm
    return [torch.where(keep, g, (g / g_norm) * max_norm) for g in g_leaves]


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(...))`` on a tree
    of f32 tensors, updating the parameters in place.

    AdamW: bias-corrected moments, ``m̂ / (√v̂ + eps)``, plus the decoupled
    weight decay of the old parameter, times −lr(count).  With
    ``max_grad_norm=None`` and ``weight_decay=0`` it is ``optax.adam``."""

    def __init__(self, lr: Callable[[int], float], b1: float, b2: float,
                 eps: float, weight_decay: float,
                 max_grad_norm: Optional[float]):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm

    def init(self, params) -> Dict[str, Any]:
        return {"count": 0, "mu": _map(torch.zeros_like, params),
                "nu": _map(torch.zeros_like, params)}

    @torch.no_grad()
    def step(self, params, grads, state: Dict[str, Any], axes=None) -> None:
        """One update of ``params`` (and ``state``) in place from ``grads``;
        ``axes``: each leaf's process groups, for the global norm of a
        tree cut across ranks (:func:`_tree_sum`)."""
        g_leaves = _leaves(grads)
        if self.max_grad_norm is not None:
            g_leaves = _clipped(g_leaves, self.max_grad_norm, axes)
        count = state["count"]
        # the bias corrections and the step size are f32 numbers, as optax
        # computes them; each is exact as a Python float
        c1 = float(1 - _f32(self.b1) ** (count + 1))
        c2 = float(1 - _f32(self.b2) ** (count + 1))
        lr = float(_f32(-self.lr(count)))
        for p, g, m, v in zip(_leaves(params), g_leaves, _leaves(state["mu"]),
                              _leaves(state["nu"])):
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_(g ** 2 * (1 - self.b2))
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            p.add_(lr * (u + self.weight_decay * p))
        state["count"] = count + 1


class ClippedProdigy:
    """``optax.chain(clip_by_global_norm(max_norm), contrib.prodigy(lr,
    betas=(b1, b2), eps=eps, weight_decay=weight_decay))`` on a tree of f32
    tensors, updating the parameters in place (Mishchenko and Defazio
    2023: D-Adapted AdamW whose step size d grows from ``D0``).

    Per update, with d the estimate before it and s = lr(count):
      bc = √(1 − b2^(n+1)) / (1 − b1^(n+1));  dlr = d·s·bc
      m ← b1·m + (1 − b1)·d·g;  v ← b2·v + (1 − b2)·(d·g)²
      r ← b3·r + dlr·d·g / d0;  N ← b3·N + (d / d0)·dlr·⟨g, x0 − x⟩
      d ← max(d, coef · N / Σ|r|)
      x ← x − wd·dlr·x − dlr·m / (√v + d·eps)   (the new d)
    with b3 = √b2, d0 = 1e-6 and coef = 1 (optax's defaults, which the
    JAX package keeps), as optax's update computes it in f32."""

    D0 = 1e-6     # optax's estim_lr0: the first d
    COEF = 1.0    # optax's estim_lr_coef

    def __init__(self, lr: Callable[[int], float], b1: float, b2: float,
                 eps: float, weight_decay: float, max_grad_norm: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.b3 = b2 ** 0.5
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm

    def init(self, params) -> Dict[str, Any]:
        dev = _leaves(params)[0].device
        return {"count": 0, "exp_avg": _map(torch.zeros_like, params),
                "exp_avg_sq": _map(torch.zeros_like, params),
                "grad_sum": _map(torch.zeros_like, params),
                "params0": _map(lambda p: p.detach().clone(), params),
                "estim_lr": _f32(self.D0).to(dev),
                "numerator_weighted": torch.zeros((), device=dev)}

    @torch.no_grad()
    def step(self, params, grads, state: Dict[str, Any], axes=None) -> None:
        """One update of ``params`` (and ``state``) in place from ``grads``;
        ``axes`` as :meth:`ClippedAdamW.step`'s (the norm and both sums
        over the logical tree)."""
        g_leaves = _clipped(_leaves(grads), self.max_grad_norm, axes)
        p_leaves = _leaves(params)
        count = state["count"]
        b1, b2, b3, d0 = self.b1, self.b2, self.b3, self.D0
        bc = float((1 - _f32(b2) ** (count + 1)) ** 0.5
                   / (1 - _f32(b1) ** (count + 1)))
        d = state["estim_lr"]
        dlr = d * float(_f32(self.lr(count))) * bc
        numerator = _tree_sum([torch.sum(g * (p0 - p)) for g, p0, p in zip(
            g_leaves, _leaves(state["params0"]), p_leaves)], axes)
        r_sums = []
        for g, m, v, r in zip(g_leaves, _leaves(state["exp_avg"]),
                              _leaves(state["exp_avg_sq"]),
                              _leaves(state["grad_sum"])):
            dg = d * g
            m.mul_(b1).add_((1 - b1) * dg)
            v.mul_(b2).add_((1 - b2) * dg * dg)
            r.mul_(b3).add_(dlr * dg / d0)
            r_sums.append(torch.sum(torch.abs(r)))
        denominator = _tree_sum(r_sums, axes)
        nw = b3 * state["numerator_weighted"] + (d / d0) * dlr * numerator
        d_new = torch.maximum(d, self.COEF * nw / denominator)
        for p, m, v in zip(p_leaves, _leaves(state["exp_avg"]),
                           _leaves(state["exp_avg_sq"])):
            p.add_(-self.weight_decay * dlr * p
                   - dlr * m / (torch.sqrt(v) + d_new * self.eps))
        state.update(count=count + 1, estim_lr=d_new, numerator_weighted=nw)


def make_optimizer(tcfg: FluxLoraTrainConfig):
    """The clipped AdamW or Prodigy of ``tcfg.optimizer``."""
    if tcfg.optimizer == "prodigy":
        return ClippedProdigy(make_lr_schedule(tcfg), tcfg.adam_b1,
                              tcfg.adam_b2, tcfg.adam_eps, tcfg.weight_decay,
                              tcfg.max_grad_norm)
    if tcfg.optimizer != "adamw":
        raise ValueError(f"unknown optimizer {tcfg.optimizer!r}")
    return ClippedAdamW(make_lr_schedule(tcfg), tcfg.adam_b1, tcfg.adam_b2,
                        tcfg.adam_eps, tcfg.weight_decay, tcfg.max_grad_norm)


def create_train_state(
    generator: torch.Generator,
    base_params: Dict[str, Any],
    tcfg: FluxLoraTrainConfig,
    device="cuda",
) -> Tuple[TrainState, Any]:
    """A fresh LoRA tree (a ~ N(0, 1/r), b = 0) on ``device`` with its
    optimizer state."""
    lora = init_lora_params(generator, base_params, rank=tcfg.rank, device=device)
    for leaf in _leaves(lora):
        leaf.requires_grad_(True)
    tx = make_optimizer(tcfg)
    return TrainState(step=0, lora=lora, opt_state=tx.init(lora)), tx


def _grads(lora) -> Dict[str, Any]:
    return _map(lambda p: p.grad, lora)


def grad_axes(tree, cfg: FluxConfig, tcfg: FluxLoraTrainConfig,
              data_axis=None):
    """(the process groups to sum each leaf's gradient over, each leaf's
    process groups it is cut over) for a tree trained across ranks: the
    arguments of ``collectives.reduce_grads`` and the optimizers' ``axes``
    (None and None on one rank).  The data axis is the one that cut the
    batch (``tcfg.pipe_data_axis`` under pipeline parallelism); a
    tree's block stacks are cut over ``tcfg.pipe_axis``."""
    from ..parallel.collectives import CUT, leaf_role, named_leaves

    pipe = tcfg.pipe_axis
    data = tcfg.pipe_data_axis if pipe is not None else data_axis
    model = cfg.tp_axis
    if pipe is None and data is None and model is None:
        return None, None
    roles, axes = [], []
    for path, _ in named_leaves(tree):
        role = leaf_role(path) if model is not None else None
        roles.append(role)
        ax = []
        if pipe is not None and path[0] in ("dual_blocks", "single_blocks"):
            ax.append(pipe)
        if role == CUT:
            ax.append(model)
        axes.append(tuple(ax))
    return (roles, model, data), axes


def logical_grads(tree, reduce) -> List[torch.Tensor]:
    """The gradients of ``tree``'s leaves (zero where the forward did not
    reach one: a padded pipeline layer), summed across ranks into the
    logical tree's by ``reduce`` (:func:`grad_axes`'s first part)."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in _leaves(tree)]
    if reduce is not None:
        from ..parallel.collectives import reduce_grads

        roles, model, data = reduce
        reduce_grads(grads, roles, model, data)
    return grads


def _zero_grads(lora) -> None:
    for leaf in _leaves(lora):
        leaf.grad = None


def _backward(loss: torch.Tensor) -> None:
    """``loss.backward()`` without TF32: the preconditioning loss's f32
    VAE decode takes its gradients at the forward's precision (the bf16
    transformer is unaffected)."""
    with exact_f32():
        loss.backward()


def train_step(
    state: TrainState,
    base_params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    cfg: FluxConfig,
    tcfg: FluxLoraTrainConfig,
    tx,
    draws: Optional[Dict[str, Any]] = None,
    vae_params: Optional[Dict[str, Any]] = None,
    vae_cfg=None,
    data_axis=None,
) -> Tuple[TrainState, torch.Tensor]:
    """One optimizer step on one batch; returns (state, loss).  ``draws``
    passes ``u``/``noise``/``keep_idx`` to ``flow_match_loss``; the frozen
    VAE feeds the preconditioning loss.  Across ranks (the module
    docstring): ``data_axis`` (``Mesh.group("data")``) cuts the batch, and
    every rank calls it with the whole batch and the same draws."""
    reduce, axes = grad_axes(state.lora, cfg, tcfg, data_axis)
    _zero_grads(state.lora)
    loss = flow_match_loss(state.lora, base_params, cfg, tcfg, batch,
                           generator, **(draws or {}), vae_params=vae_params,
                           vae_cfg=vae_cfg, data_axis=data_axis)
    _backward(loss)
    tx.step(state.lora, logical_grads(state.lora, reduce), state.opt_state,
            axes)
    _zero_grads(state.lora)
    state.step += 1
    return state, loss.detach()


def train_step_accum(
    state: TrainState,
    base_params: Dict[str, Any],
    batches: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    cfg: FluxConfig,
    tcfg: FluxLoraTrainConfig,
    tx,
    draws: Optional[List[Dict[str, Any]]] = None,
    vae_params: Optional[Dict[str, Any]] = None,
    vae_cfg=None,
    data_axis=None,
) -> Tuple[TrainState, torch.Tensor]:
    """Gradient-accumulated step: ``batches`` leaves carry a leading
    microbatch axis [A, B, ...]; the A gradients are summed in order and
    divided by A, one microbatch's activations alive at a time.  ``draws``
    is one dict per microbatch; ``data_axis`` as :func:`train_step`'s."""
    reduce, axes = grad_axes(state.lora, cfg, tcfg, data_axis)
    A = next(iter(batches.values())).shape[0]
    _zero_grads(state.lora)
    loss_sum = 0.0
    for a in range(A):
        mb = {k: v[a] for k, v in batches.items()}
        loss = flow_match_loss(state.lora, base_params, cfg, tcfg, mb,
                               generator, **(draws[a] if draws else {}),
                               vae_params=vae_params, vae_cfg=vae_cfg,
                               data_axis=data_axis)
        _backward(loss)  # sums into .grad
        loss_sum = loss_sum + loss.detach()
    grads = [g / A for g in logical_grads(state.lora, reduce)]
    tx.step(state.lora, grads, state.opt_state, axes)
    _zero_grads(state.lora)
    state.step += 1
    return state, loss_sum / A


# ------------------------------------------------------- checkpointing


def _as_dict(state: TrainState) -> Dict[str, Any]:
    return {"step": state.step, "lora": state.lora, "opt_state": state.opt_state}


def save_checkpoint(path: str, state: TrainState) -> None:
    """The whole train state in one ``torch.save`` file (the JAX package
    writes an orbax checkpoint; reading those is deferred)."""
    torch.save(_detached(_as_dict(state)), path)


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    restored = _like(loaded, _as_dict(template))
    for leaf in _leaves(restored["lora"]):
        leaf.requires_grad_(True)
    return TrainState(**restored)
