"""TSD-SR training: target score distillation of a one-step SD3 SR
student (port of unitex_tpu/training/tsdsr.py).

Three networks share the frozen SD3 backbone:

* the student: the base with the student LoRA, one step at t = 1000;
* the teacher: the base alone, with classifier-free guidance;
* the regularizer: the base with the regularizer LoRA, trained by flow
  matching on the student's outputs.

Per step:
  latent_stu = z_lr − σ(1000)·v_student(z_lr)
  TSD grad   = λ·(v_teacher(ẑ) − v_reg(ẑ))·σ² +
               (1−λ)·(v_teacher(ẑ) − v_teacher(z_hr))·σ²
  tsd_loss   = ½‖latent_stu − sg(latent_stu − grad)‖²
  data_loss  = MSE(latent_stu, z_hr) + a perceptual term
  reg_loss   = flow matching of v_reg toward the student's samples

The perceptual term is the gradient-domain L1 proxy unless a
``perceptual_fn`` is given (``make_lpips_perceptual_fn``: LPIPS on the
decoded images).  Both adapters are merged into each block inside the
block (``sd3_forward(..., lora=...)``), so only the LoRA trees take
gradients; attention gradients go through kernels B2a/B2b at D = 64 on
the card.  The teacher and regularizer CFG forwards run under
``torch.no_grad()`` (the JAX ``stop_gradient``).

Randomness is injected: the teacher timestep ``t`` and the ``noise`` of
each phase are drawn from a ``torch.Generator`` unless given, so a test
can feed both packages the same draws.  The optimizers are
``training/flux_lora.ClippedAdamW`` with optax ``adamw``'s defaults (b1
0.9, b2 0.999, eps 1e-8, weight decay 1e-4) behind a global-norm clip.
The step's stages are timed by ``utils/timer.CPUTimer`` (``tsd_*``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models.sd3.config import SD3Config
from ..models.sd3.lora import init_sd3_lora
from ..models.sd3.model import sd3_forward
from ..utils.timer import CPUTimer
from .flux_lora import ClippedAdamW, _grads, _leaves, _zero_grads


@dataclasses.dataclass(frozen=True)
class TSDTrainConfig:
    rank: int = 64
    learning_rate: float = 1e-5
    reg_learning_rate: float = 1e-5
    guidance_scale: float = 7.5
    lambda_tsd: float = 0.7
    max_grad_norm: float = 1.0
    num_train_timesteps: int = 1000
    shift: float = 3.0
    t_min: int = 50
    t_max: int = 950


def _sigma(t: torch.Tensor, shift: float = 3.0) -> torch.Tensor:
    """Flow-match sigma of timestep t in [0, 1000] with SD3's shift."""
    u = t / 1000.0
    return shift * u / (1.0 + (shift - 1.0) * u)


def _timer(name: str) -> CPUTimer:
    return CPUTimer(name, verbose=False)


def make_lpips_perceptual_fn(lpips_params, decode_fn: Callable) -> Callable:
    """A ``perceptual_fn`` for :func:`tsd_student_loss`: LPIPS between the
    decoded student image and the decoded HR latent (no gradient through
    the latter); ``decode_fn(latents) -> [B, H, W, 3]`` in [0, 1]."""
    from ..utils.lpips import lpips_image01

    def perceptual(latent_stu, latent_hr):
        img_stu = decode_fn(latent_stu)
        with torch.no_grad():
            img_hr = decode_fn(latent_hr)
        return lpips_image01(lpips_params, img_stu, img_hr).mean()

    return perceptual


def gradient_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Gradient-domain L1 of [B, H, W, C] tensors, the perceptual proxy."""
    def grads(x):
        return x[:, 1:] - x[:, :-1], x[:, :, 1:] - x[:, :, :-1]

    ay, ax = grads(a)
    by, bx = grads(b)
    return (ay - by).abs().mean() + (ax - bx).abs().mean()


def _cfg_forward(params, cfg, z, t, prompt, pooled, prompt_null, pooled_null,
                 scale, lora=None):
    """Classifier-free guided velocity: one batch of [uncond; cond]."""
    out = sd3_forward(params, cfg, torch.cat([z, z]), torch.cat([prompt_null,
                      prompt]), torch.cat([t, t]),
                      torch.cat([pooled_null, pooled]), lora=lora)
    uncond, cond = torch.chunk(out, 2, dim=0)
    return uncond + scale * (cond - uncond)


def _draw(generator, tcfg: TSDTrainConfig, like: torch.Tensor, t, noise):
    """The phase's timestep [B] (f32) and noise, drawn unless given."""
    B, dev = like.shape[0], like.device
    if t is None:
        t = torch.randint(tcfg.t_min, tcfg.t_max, (B,), generator=generator,
                          device=dev)
    if noise is None:
        noise = torch.randn(like.shape, generator=generator, device=dev)
    return (torch.as_tensor(t, device=dev).float(),
            torch.as_tensor(noise, dtype=torch.float32, device=dev))


def tsd_student_loss(
    student_lora: Dict[str, Any],
    reg_lora: Dict[str, Any],
    base_params: Dict[str, Any],
    cfg: SD3Config,
    tcfg: TSDTrainConfig,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    perceptual_fn: Optional[Callable] = None,
    t=None,
    noise=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Student phase: TSD + data loss, differentiable in ``student_lora``.
    batch: 'latent_lr', 'latent_hr' [B, h, w, C], 'prompt_embeds',
    'pooled_embeds' and their '_null' variants.  ``t`` [B] and ``noise``
    (latent-shaped) are the teacher comparison's draws.  Returns (loss,
    {'tsd_loss', 'data_loss', 'latent_stu' (detached)})."""
    z_lr = batch["latent_lr"]
    z_hr = batch["latent_hr"]
    B = z_lr.shape[0]
    t_tea, noise = _draw(generator, tcfg, z_lr, t, noise)

    with _timer("tsd_student_forward"):
        t_stu = torch.full((B,), 1000.0, device=z_lr.device)
        v_stu = sd3_forward(base_params, cfg, z_lr, batch["prompt_embeds"],
                            t_stu, batch["pooled_embeds"], lora=student_lora)
        sigma_stu = _sigma(t_stu, tcfg.shift)[:, None, None, None]
        latent_stu = z_lr - sigma_stu * v_stu

    sigma_tea = _sigma(t_tea, tcfg.shift)[:, None, None, None]
    args = (batch["prompt_embeds"], batch["pooled_embeds"],
            batch["prompt_embeds_null"], batch["pooled_embeds_null"],
            tcfg.guidance_scale)
    with _timer("tsd_teacher_reg_forwards"), torch.no_grad():
        stu = latent_stu.detach()
        noisy_stu = sigma_tea * noise + (1.0 - sigma_tea) * stu
        noisy_hr = sigma_tea * noise + (1.0 - sigma_tea) * z_hr
        v_tea = _cfg_forward(base_params, cfg, noisy_stu, t_tea, *args)
        v_tea_hr = _cfg_forward(base_params, cfg, noisy_hr, t_tea, *args)
        v_reg = _cfg_forward(base_params, cfg, noisy_stu, t_tea, *args,
                             lora=reg_lora)
        grad_vsd = (v_tea - v_reg) * sigma_tea ** 2
        grad_tsm = (v_tea - v_tea_hr) * sigma_tea ** 2
        grad = tcfg.lambda_tsd * grad_vsd + (1.0 - tcfg.lambda_tsd) * grad_tsm
        target = stu - torch.nan_to_num(grad)

    tsd_loss = 0.5 * torch.mean((latent_stu - target) ** 2)
    mse_loss = torch.mean((latent_stu - z_hr.detach()) ** 2)
    if perceptual_fn is not None:
        perc = perceptual_fn(latent_stu, z_hr)
    else:
        perc = gradient_l1(latent_stu, z_hr)
    data_loss = mse_loss + perc
    loss = tsd_loss + data_loss
    return loss, {"tsd_loss": tsd_loss.detach(),
                  "data_loss": data_loss.detach(),
                  "latent_stu": latent_stu.detach()}


def tsd_regularizer_loss(
    reg_lora: Dict[str, Any],
    base_params: Dict[str, Any],
    cfg: SD3Config,
    tcfg: TSDTrainConfig,
    latent_stu: torch.Tensor,
    prompt: torch.Tensor,
    pooled: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    t=None,
    noise=None,
) -> torch.Tensor:
    """Regularizer phase: flow matching of v_reg toward the (frozen)
    student samples, differentiable in ``reg_lora``; ``t`` and ``noise``
    as in :func:`tsd_student_loss`."""
    latent_stu = latent_stu.detach()
    t, noise = _draw(generator, tcfg, latent_stu, t, noise)
    sigma = _sigma(t, tcfg.shift)[:, None, None, None]
    noisy = sigma * noise + (1.0 - sigma) * latent_stu
    v = sd3_forward(base_params, cfg, noisy, prompt, t, pooled, lora=reg_lora)
    pred_x0 = noisy - sigma * v
    return 0.5 * torch.mean((pred_x0 - latent_stu) ** 2)


@dataclasses.dataclass
class TSDTrainState:
    """The step count, both LoRA trees (f32 leaves with ``requires_grad``)
    and their optimizer states; :func:`tsd_train_step` updates it in
    place."""

    step: int
    student_lora: Dict[str, Any]
    reg_lora: Dict[str, Any]
    opt_state_student: Dict[str, Any]
    opt_state_reg: Dict[str, Any]


def _adamw(lr: float, max_grad_norm: float) -> ClippedAdamW:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(lr))``."""
    return ClippedAdamW(lambda count: lr, 0.9, 0.999, 1e-8, 1e-4,
                        max_grad_norm)


def create_tsd_state(
    generator: torch.Generator, base_params: Dict[str, Any],
    tcfg: TSDTrainConfig, device="cuda",
) -> Tuple[TSDTrainState, ClippedAdamW, ClippedAdamW]:
    """Fresh student and regularizer adapters (a ~ N(0, 1/r), b = 0), in
    that order from ``generator``, with their optimizers."""
    student = init_sd3_lora(generator, base_params, rank=tcfg.rank,
                            device=device)
    reg = init_sd3_lora(generator, base_params, rank=tcfg.rank, device=device)
    for leaf in _leaves(student) + _leaves(reg):
        leaf.requires_grad_(True)
    tx_s = _adamw(tcfg.learning_rate, tcfg.max_grad_norm)
    tx_r = _adamw(tcfg.reg_learning_rate, tcfg.max_grad_norm)
    state = TSDTrainState(0, student, reg, tx_s.init(student), tx_r.init(reg))
    return state, tx_s, tx_r


def tsd_train_step(
    state: TSDTrainState,
    base_params: Dict[str, Any],
    cfg: SD3Config,
    tcfg: TSDTrainConfig,
    batch: Dict[str, torch.Tensor],
    tx_s: ClippedAdamW,
    tx_r: ClippedAdamW,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, Dict[str, Any]]] = None,
    perceptual_fn: Optional[Callable] = None,
) -> Tuple[TSDTrainState, Dict[str, torch.Tensor]]:
    """Both phases of one iteration, student then regularizer, each
    followed by its optimizer step.  ``draws`` = {"student": {"t",
    "noise"}, "reg": {"t", "noise"}} passes the draws in; returns (state,
    {'loss', 'tsd_loss', 'data_loss', 'reg_loss'})."""
    draws = draws or {}
    _zero_grads(state.student_lora)
    loss_s, aux = tsd_student_loss(
        state.student_lora, state.reg_lora, base_params, cfg, tcfg, batch,
        generator, perceptual_fn, **draws.get("student", {}))
    with _timer("tsd_student_backward"):
        loss_s.backward()
    with _timer("tsd_optimizer_student"):
        tx_s.step(state.student_lora, _grads(state.student_lora),
                  state.opt_state_student)
        _zero_grads(state.student_lora)

    _zero_grads(state.reg_lora)
    with _timer("tsd_reg_forward"):
        loss_r = tsd_regularizer_loss(
            state.reg_lora, base_params, cfg, tcfg, aux["latent_stu"],
            batch["prompt_embeds"], batch["pooled_embeds"], generator,
            **draws.get("reg", {}))
    with _timer("tsd_reg_backward"):
        loss_r.backward()
    with _timer("tsd_optimizer_reg"):
        tx_r.step(state.reg_lora, _grads(state.reg_lora), state.opt_state_reg)
        _zero_grads(state.reg_lora)
    state.step += 1
    return state, {"loss": loss_s.detach(), "tsd_loss": aux["tsd_loss"],
                   "data_loss": aux["data_loss"], "reg_loss": loss_r.detach()}
