"""Differentiable texture and camera-pose refinement (port of
unitex_tpu/texture/refine.py).

The rasterization (triangle ids, barycentrics, UVs, world positions) is
taken once per view, without gradient; the loops then differentiate only
what follows it:

- texture: the per-pixel UVs -> bilinear :func:`sample_texture` of a
  sigmoid-parameterized atlas -> a masked photometric loss against the
  target views (plus a total-variation prior);
- pose: the per-pixel world positions are re-projected through the
  current pose estimate (a 6D rotation and a translation per view) into
  the target image, which is sampled bilinearly and compared with the
  mesh's own colours.

Each step is one autograd pass and one Adam update with optax's
arithmetic (``training/flux_lora.ClippedAdamW`` without clipping or
decay).  Both return the loss of every step as a [steps] tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..camera.conversion import c2w_to_w2c, intr_to_proj
from ..camera.rotation import matrix_to_rotation_6d, rotation_6d_to_matrix
from ..geometry.mesh import Mesh
from ..ops.grid_sample import grid_sample, sample_texture
from ..render.renderer import render_views
from ..training.flux_lora import ClippedAdamW
from ..utils.precision import exact_f32


@dataclasses.dataclass(frozen=True)
class TextureRefineConfig:
    texture_size: int = 512
    steps: int = 200
    lr: float = 5e-2
    tv_weight: float = 1e-4  # total-variation prior over the atlas
    loss: str = "l2"  # or "l1"


def _photo_loss(pred, target, alpha, kind):
    diff = (pred - target) * alpha
    per = torch.abs(diff) if kind == "l1" else diff * diff
    return per.sum() / torch.clamp(alpha.sum() * pred.shape[-1], min=1.0)


def _adam(lr: float) -> ClippedAdamW:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8."""
    return ClippedAdamW(lambda count: lr, 0.9, 0.999, 1e-8, 0.0, None)


def _optimize(params, loss_fn, lr: float, steps: int) -> torch.Tensor:
    """``steps`` Adam updates of the leaves of ``params`` in place; the
    loss before each update, as a [steps] tensor."""
    opt = _adam(lr)
    state = opt.init(params)
    leaves = [p.requires_grad_(True) for p in params.values()]
    losses = []
    for _ in range(steps):
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, leaves)
        opt.step(params, dict(zip(params, grads)), state)
        losses.append(loss.detach())
    for p in leaves:
        p.requires_grad_(False)
    return torch.stack(losses)


@exact_f32()
def refine_texture(
    mesh: Mesh,
    c2ws: torch.Tensor,
    intrinsics: torch.Tensor,
    target_images: torch.Tensor,
    perspective: bool = False,
    init_texture: Optional[torch.Tensor] = None,
    cfg: TextureRefineConfig = TextureRefineConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimize a UV texture so the rendered mesh matches target views.

    ``mesh`` carries uv / faces_uv; target_images [M, H, W, C] in [0, 1].
    Returns (texture [T, T, C] in [0, 1], losses [steps])."""
    M, H, W, C = target_images.shape
    with torch.no_grad():
        outs = render_views(mesh, c2ws, intrinsics, (H, W),
                            perspective=perspective, render_uv=True)
    uv01 = (outs.uv + 1.0) * 0.5       # ndc [-1, 1], v up -> [0, 1]
    alpha = outs.alpha
    if init_texture is None:
        logits = target_images.new_zeros((cfg.texture_size, cfg.texture_size, C))
    else:
        t0 = torch.clamp(init_texture.float(), 1e-4, 1.0 - 1e-4)
        logits = torch.log(t0) - torch.log1p(-t0)

    def loss_fn(p):
        tex = torch.sigmoid(p["logits"])
        loss = _photo_loss(sample_texture(tex, uv01), target_images, alpha,
                           cfg.loss)
        if cfg.tv_weight > 0:
            tv = (torch.mean((tex[1:] - tex[:-1]) ** 2)
                  + torch.mean((tex[:, 1:] - tex[:, :-1]) ** 2))
            loss = loss + cfg.tv_weight * tv
        return loss

    params = {"logits": logits.clone()}
    losses = _optimize(params, loss_fn, cfg.lr, cfg.steps)
    return torch.sigmoid(params["logits"]), losses


@dataclasses.dataclass(frozen=True)
class PoseRefineConfig:
    steps: int = 100
    lr: float = 3e-3
    loss: str = "l2"


@exact_f32()
def refine_poses(
    mesh: Mesh,
    c2ws: torch.Tensor,
    intrinsics: torch.Tensor,
    target_images: torch.Tensor,
    texture: torch.Tensor,
    perspective: bool = False,
    cfg: PoseRefineConfig = PoseRefineConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Photometric camera-pose refinement against target views.

    c2ws [M, 4, 4] are the initial estimates; ``texture`` gives the mesh's
    surface colours.  Returns (refined c2ws [M, 4, 4], losses [steps])."""
    M, H, W, C = target_images.shape
    if intrinsics.dim() == 2:
        intrinsics = intrinsics.expand(M, 3, 3)
    with torch.no_grad():
        outs = render_views(mesh, c2ws, intrinsics, (H, W),
                            perspective=perspective, render_uv=True,
                            render_world_position=True)
        surf_rgb = sample_texture(texture, (outs.uv + 1.0) * 0.5)
    alpha, wpos = outs.alpha, outs.world_position
    projs = intr_to_proj(intrinsics, perspective=perspective)
    bottom = c2ws.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(M, 1, 4)

    def build_c2ws(p):
        top = torch.cat([rotation_6d_to_matrix(p["rot6d"]),
                         p["trans"][:, :, None]], dim=-1)
        return torch.cat([top, bottom], dim=1)

    def loss_fn(p):
        w2cs = c2w_to_w2c(build_c2ws(p))
        cam = (torch.einsum("mhwc,mdc->mhwd", wpos, w2cs[:, :, :3])
               + w2cs[:, None, None, :, 3])
        clip = (torch.einsum("mhwc,mdc->mhwd", cam[..., :3], projs[:, :, :3])
                + cam[..., 3:4] * projs[:, None, None, :, 3])
        w = clip[..., 3:4]
        ndc = clip[..., :2] / torch.clamp(torch.abs(w), min=1e-8) * torch.sign(w)
        # the rasterizer's ndc y = -1 is the top row, as grid_sample's
        sampled = torch.stack([grid_sample(img, g, padding_mode="border")
                               for img, g in zip(target_images, ndc)])
        return _photo_loss(sampled, surf_rgb, alpha, cfg.loss)

    params = {"rot6d": matrix_to_rotation_6d(c2ws[:, :3, :3]).clone(),
              "trans": c2ws[:, :3, 3].clone()}
    losses = _optimize(params, loss_fn, cfg.lr, cfg.steps)
    return build_c2ws(params), losses
