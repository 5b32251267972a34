"""End-to-end texture generation pipeline (port of unitex_tpu/pipeline.py,
bf16 serving without super-resolution).

One RGB reference image + an untextured mesh -> a textured GLB:

  step_1_1        mesh preprocess -> reference-image matting -> 6-view
                  geometry conditioning renders -> FLUX texture pass ->
                  FLUX delight pass
  step_2_ablition multi-view back-projection bake -> textured_mesh.glb

Artifact names match the JAX package, so its tooling (for example
scripts/compare_golden.py) reads both: ``processed_mesh.obj``,
``rembg_image.png``, ``processed_image.png``, ``mv_alpha/ccm/normal.png``,
``camera_info.npz``, ``mv_rgb_w_light.png``, ``mv_rgb.png``,
``textured_mesh.glb``, ``visable_uv_mask.png``, ``valid_uv_mask.png``,
``completed_uv.png``.

Every device stage runs on ``device`` (default ``"cuda"``; asking for CUDA
without a card raises).  Ported: ``random_weights=True`` (a full-size
random FLUX tree made on the device), or parameter trees set by the
caller (for example carried from the JAX package by ``params_from_jax``).
Deferred (``NotImplementedError``): loading checkpoints
(``pretrain_models``), the weightless stand-in, int8 serving and
parameter caches, TSD-SR super-resolution, ``async_io``, the LTM pipeline
and video export.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import DEFAULT_CONFIG, PipelineConfig
from .geometry.io.mesh_io import HostMesh, load_mesh, save_mesh, save_obj
from .geometry.mesh import Mesh, pad_mesh_to_bucket
from .geometry.uv_atlas import preprocess_blank_mesh
from .image.process_image import preprocess_reference_image
from .image.rembg import build_background_remover
from .models.flux.config import FluxConfig
from .models.flux.lora import init_lora_params, merge_lora
from .models.flux.model import init_flux_params
from .models.flux.pipeline import (
    FluxPipelineConfig,
    run_flux_pipeline,
    torch_reference_rng,
)
from .models.flux.vae import VAEConfig, init_vae_params
from .render.conditioning import (
    grid_to_strip,
    grid_to_views,
    render_geometry_condition,
    strip_to_grid,
)
from .render.renderer_inverse import bake_texture
from .utils.image_io import save_image, to_uint8_device
from .utils.precision import exact_f32, resolve_device
from .utils.timer import CPUTimer


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _tri_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of ``jax.image.resize(..., "bilinear")`` along
    one axis: a triangle kernel widened by the downscale factor
    (antialiased when shrinking), columns normalized, samples outside the
    input zeroed — the same construction as JAX's scale_and_translate."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) * np.float32(inv) - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / np.float32(kscale)
    w = np.maximum(0.0, 1.0 - x).astype(np.float32)
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


@exact_f32()
def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[H, W, C] -> [out_h, out_w, C], the ``jax.image.resize`` bilinear
    convention (antialiased downsampling), as two f32 weight products."""
    H, W = img.shape[:2]
    wh = torch.from_numpy(_tri_weights(H, out_h)).to(img.device)
    ww = torch.from_numpy(_tri_weights(W, out_w)).to(img.device)
    return torch.einsum("hwc,hy,wx->yxc", img.float(), wh, ww)


class RGBTextureFullPipelineBase:
    """Owns the models and runs the stages."""

    def __init__(
        self,
        pretrain_models: Optional[str] = None,
        super_resolutions: bool = False,
        seed: int = 63,
        config: PipelineConfig = DEFAULT_CONFIG,
        require_weights: bool = False,
        save_artifacts: bool = True,
        int8_serving: bool | str = False,
        async_io: bool = False,
        random_weights: bool = False,
        params_cache: Optional[str] = None,
        device="cuda",
    ):
        if pretrain_models is not None or require_weights:
            raise NotImplementedError("loading checkpoints is not ported")
        if super_resolutions or config.super_resolution:
            raise NotImplementedError("TSD-SR super-resolution is not ported")
        if int8_serving or params_cache:
            raise NotImplementedError(
                "int8 serving and parameter caches are not ported")
        if async_io:
            raise NotImplementedError("async_io is not ported")
        self.device = resolve_device(device)
        self.config = config
        self.seed = seed
        self.save_artifacts = save_artifacts
        self.rembg = build_background_remover(None)
        self.flux_cfg = FluxConfig.flux1_dev()
        self.vae_cfg = VAEConfig.flux()
        self._flux_loaded = False
        self.transformer_params = None
        self.vae_params = None
        self.texture_lora = None
        self.delight_lora = None
        if random_weights:
            self._init_random_weights()

    def _init_random_weights(self) -> None:
        """Random-init the serving tree at full size, directly on the
        device in bf16 (the VAE and LoRA in f32, as the JAX package serves
        them).  Outputs are meaningless images; every shape, kernel launch
        and memory footprint is the real one."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        self.transformer_params = init_flux_params(
            gen, self.flux_cfg, device=self.device, dtype=torch.bfloat16)
        self.texture_lora = init_lora_params(
            gen.manual_seed(1), self.transformer_params, rank=16,
            device=self.device)
        self.delight_lora = init_lora_params(
            gen.manual_seed(2), self.transformer_params, rank=16,
            device=self.device)
        self.vae_params = init_vae_params(gen.manual_seed(3), self.vae_cfg,
                                          device=self.device)
        self._flux_loaded = True

    def _generator(self) -> torch.Generator:
        """A fresh device generator seeded with the job seed: each FLUX
        pass draws its noise from the same seed, as the JAX package passes
        both passes the same key."""
        return torch.Generator(device=self.device).manual_seed(self.seed)

    # ------------------------------------------------------------ stages

    def preprocess_job(self, save_dir: str, image_path: str, mesh_path: str):
        """All host-side preprocessing of one job (mesh normalize/decimate/
        unwrap + reference-image matting).  Returns the ``preprocessed``
        tuple accepted by ``__call__``."""
        cache = os.path.join(save_dir, "cache")
        os.makedirs(cache, exist_ok=True)
        mesh = self.preprocess_blank_mesh_stage(cache, mesh_path)
        ref = self.preprocess_reference_image_stage(cache, image_path)
        return mesh, ref

    @CPUTimer("preprocess_blank_mesh")
    def preprocess_blank_mesh_stage(self, save_dir: str, mesh_path: str) -> HostMesh:
        mesh = load_mesh(mesh_path)
        mesh = preprocess_blank_mesh(
            mesh,
            min_faces=self.config.mesh.min_faces,
            max_faces=self.config.mesh.max_faces,
            uv_size=self.config.mesh.uv_size,
            gutter=self.config.mesh.uv_gutter,
        )
        save_obj(os.path.join(save_dir, "processed_mesh.obj"), mesh)
        return mesh

    @CPUTimer("preprocess_reference_image")
    def preprocess_reference_image_stage(self, save_dir: str, image_path: str):
        from PIL import Image

        img = Image.open(image_path).convert("RGB").resize((1024, 1024))
        out = preprocess_reference_image(
            img, H=1024, W=1024, scale=0.95, color="grey",
            background_remover=self.rembg,
        )
        out.save(os.path.join(save_dir, "rembg_image.png"))
        small = out.convert("RGB").resize((512, 512))
        small.save(os.path.join(save_dir, "processed_image.png"))
        return np.asarray(small, np.float32) / 255.0

    @CPUTimer("render_geometry_images")
    def render_geometry_images_stage(
        self, save_dir: str, mesh: HostMesh
    ) -> Dict[str, torch.Tensor]:
        cam = self.config.camera
        dev = self.device
        device_mesh = Mesh(
            torch.from_numpy(np.ascontiguousarray(
                mesh.vertices * self.config.mesh.scale_to)).to(dev),
            torch.from_numpy(np.asarray(mesh.faces, np.int64)).to(dev),
            uv=None if mesh.uv is None else torch.from_numpy(
                np.ascontiguousarray(mesh.uv, np.float32)).to(dev),
            faces_uv=None if mesh.faces_uv is None else torch.from_numpy(
                np.asarray(mesh.faces_uv, np.int64)).to(dev),
        )
        device_mesh = pad_mesh_to_bucket(device_mesh, self.config.mesh.shape_bucket)
        out = render_geometry_condition(
            device_mesh,
            view_size=cam.view_size,
            radius=cam.radius,
            ortho_scale=cam.ortho_scale,
            background=0.5,
            rows=cam.rows,
            cols=cam.cols,
        )
        if self.save_artifacts:
            save_image(os.path.join(save_dir, "mv_alpha.png"), _host(out["alpha"]))
            save_image(os.path.join(save_dir, "mv_ccm.png"), _host(out["ccm"]))
            save_image(os.path.join(save_dir, "mv_normal.png"), _host(out["normal"]))
        np.savez(
            os.path.join(save_dir, "camera_info.npz"),
            c2ws=_host(out["c2ws"]),
            intrinsics=_host(out["intrinsics"]),
            perspective=np.asarray(cam.perspective),
        )
        out["mesh"] = device_mesh
        return out

    @CPUTimer("infer_mv")
    def infer_mv_stage(
        self,
        save_dir: str,
        reference_image: np.ndarray,
        condition: Dict[str, torch.Tensor],
    ) -> torch.Tensor:
        """Texture + delight FLUX passes over the 1x6 strip.  Returns the
        delighted 2x3 grid in [0, 1]."""
        if not self._flux_loaded:
            raise NotImplementedError(
                "the weightless stand-in is not ported: pass random_weights=True "
                "or set the parameter trees")
        dcfg = self.config.diffusion
        if dcfg.velocity_reuse:
            raise NotImplementedError("velocity reuse is not ported")
        control_grid = 0.5 * condition["normal"] + 0.5 * condition["ccm"]
        control_strip = grid_to_strip(control_grid)

        pipe_cfg = FluxPipelineConfig(
            height=dcfg.height,
            width=dcfg.width,
            num_inference_steps=dcfg.num_inference_steps,
            guidance_scale=dcfg.guidance_scale,
            max_sequence_length=dcfg.max_sequence_length,
        )
        plan_tex = plan_del = {}
        if dcfg.torch_rng_parity:
            # seed-exact replay of the reference's torch.Generator
            # stream across both passes (noise -> dual -> control)
            host_gen = torch.Generator().manual_seed(self.seed)
            vs = self.vae_cfg.downscale
            hl, wl = dcfg.height // vs, dcfg.width // vs
            dl = dcfg.dual_size // vs
            C = self.vae_cfg.latent_channels
            p = torch_reference_rng(host_gen, (hl, wl), dual_hw=(dl, dl),
                                    control_hw=(hl, wl), latent_channels=C)
            plan_tex = {k: p[k] for k in ("noise", "dual_eps", "control_eps")}
            p = torch_reference_rng(host_gen, (hl, wl), control_hw=(hl, wl),
                                    latent_channels=C)
            plan_del = {"noise": p["noise"], "control_eps": p["control_eps"]}

        # dual conditioning at the configured resolution
        dual = torch.from_numpy(np.asarray(reference_image, np.float32)).to(
            self.device)
        ds = dcfg.dual_size
        if tuple(dual.shape[:2]) != (ds, ds):
            dual = resize_bilinear(dual, ds, ds)
        # texture pass: adapters [1, 0]; the merged kernels are fresh
        # copies, dropped right after the pass
        params = merge_lora(
            self.transformer_params,
            [(self.texture_lora, 1.0), (self.delight_lora, 0.0)],
        )
        strip_w_light = run_flux_pipeline(
            params, self.flux_cfg, self.vae_params, self.vae_cfg,
            self._generator(), pipe_cfg, control_image=control_strip,
            dual_image=dual,
            device=self.device, **plan_tex,
        )
        del params
        if self.save_artifacts:
            save_image(os.path.join(save_dir, "mv_rgb_w_light.png"),
                       _host(strip_w_light))
        # delight pass: adapters [0, 1], control = stage-1 output, no dual
        params = merge_lora(self.transformer_params,
                            [(self.delight_lora, 1.0)])
        strip_delight = run_flux_pipeline(
            params, self.flux_cfg, self.vae_params, self.vae_cfg,
            self._generator(), pipe_cfg, control_image=strip_w_light,
            device=self.device, **plan_del,
        )
        del params

        mv_rgb = strip_to_grid(strip_delight)
        if self.save_artifacts:
            save_image(os.path.join(save_dir, "mv_rgb.png"), _host(mv_rgb))
        return mv_rgb

    @CPUTimer("reproject_and_query_field")
    def reproject_stage(
        self,
        save_dir: str,
        mesh: Mesh,
        mv_rgb_grid: torch.Tensor,
        condition: Dict[str, torch.Tensor],
        processed_mesh: HostMesh,
    ) -> str:
        bcfg = self.config.bake
        cam = self.config.camera
        views = grid_to_views(mv_rgb_grid.float(), cam.rows, cam.cols)
        out = bake_texture(
            mesh, views, condition["c2ws"], condition["intrinsics"],
            uv_size=bcfg.uv_size,
            perspective=cam.perspective,
            method="reproject",
            grad_norm_threshold=bcfg.grad_norm_threshold,
            ray_normal_angle_threshold=bcfg.ray_normal_angle_threshold,
            depth_eps=bcfg.depth_eps,
        )
        # the f32 texture of the last bake, for callers that check it
        self.last_texture = out["texture"]
        tex_u8 = _host(to_uint8_device(out["texture"]))
        if self.save_artifacts:
            save_image(os.path.join(save_dir, "visable_uv_mask.png"),
                       _host(to_uint8_device(out["mask_visible_any"].float())))
            save_image(os.path.join(save_dir, "valid_uv_mask.png"),
                       _host(to_uint8_device(out["mask_2d"].float())))
            save_image(os.path.join(save_dir, "completed_uv.png"), tex_u8)
        glb_path = os.path.join(save_dir, "textured_mesh.glb")
        save_mesh(glb_path, HostMesh(
            processed_mesh.vertices, processed_mesh.faces,
            uv=processed_mesh.uv, faces_uv=processed_mesh.faces_uv,
            texture=tex_u8,
        ))
        return glb_path


class CustomRGBTextureFullPipeline(RGBTextureFullPipelineBase):
    """The shipped entry point: step_1_1 + step_2_ablition (no-LTM bake)."""

    def __call__(
        self,
        save_dir: str,
        image_path: str,
        mesh_path: str,
        clear_cache: bool = False,
        export_video: bool = False,
        preprocessed=None,
    ) -> Tuple[str, str]:
        if export_video:
            raise NotImplementedError("video export is not ported")
        cache = os.path.join(save_dir, "cache")
        os.makedirs(cache, exist_ok=True)
        if preprocessed is None:
            preprocessed = self.preprocess_job(save_dir, image_path, mesh_path)
        processed_mesh, ref_image = preprocessed
        condition = self.render_geometry_images_stage(cache, processed_mesh)
        mv_rgb = self.infer_mv_stage(cache, ref_image, condition)
        glb_path = self.reproject_stage(
            cache, condition["mesh"], mv_rgb, condition, processed_mesh)
        rembg_out = os.path.join(save_dir, "rembg_image.png")
        glb_out = os.path.join(save_dir, "textured_mesh.glb")
        shutil.copy(os.path.join(cache, "rembg_image.png"), rembg_out)
        shutil.copy(glb_path, glb_out)
        if clear_cache:
            shutil.rmtree(cache)
        return rembg_out, glb_out
