"""Central typed configuration.

The reference scatters its operating constants across the code base
(view orders, camera radius 2.8, ortho scale 1.0, thresholds 0.15/100,
UV 2048, diffusion 28 steps / cfg 3.5 — see reference pipeline.py:120,
199-228, 312-360 and TextureTools camera/generator.py:153).  Here they all
live in one frozen dataclass tree so that every stage is reproducible and
jit-friendly (configs are static Python values, never traced).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Six orthographic box views in a 2x3 grid (reference pipeline.py:199-228)."""

    n_views: int = 6
    rows: int = 2
    cols: int = 3
    view_size: int = 512          # pixels per view (square)
    radius: float = 2.8           # camera distance (generator.py:153)
    ortho_scale: float = 1.0      # orthographic scale (pipeline.py:212)
    perspective: bool = False
    near: float = 0.01
    far: float = 1000.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh preprocessing budget (reference pipeline.py:170-179, uv_atlas.py:12-201)."""

    min_faces: int = 20_000
    max_faces: int = 200_000
    scale_to: float = 0.95        # bbox scale before render (pipeline.py:176)
    uv_size: int = 2048
    uv_gutter: int = 4
    merge_eps: float = 1e-8
    # device-side shape bucketing: pad faces/vertices up to the next
    # power of two (floored here) so meshes with different sizes share the
    # same device shapes — ~4 shapes over the whole face budget.  Padding
    # is degenerate (v0,v0,v0) faces — zero-area, culled by every kernel —
    # and never reaches exported artifacts.  0 disables.
    shape_bucket: int = 4096


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """FLUX multi-view texture/delight synthesis (pipeline.py:231-289)."""

    num_inference_steps: int = 28
    guidance_scale: float = 3.5
    height: int = 512
    width: int = 3072             # 6 views of 512 side by side
    dual_size: int = 512          # reference-image conditioning resolution
    max_sequence_length: int = 512
    seed: int = 63                # run.py:5
    # timestep-shift parameters (diffusers FLUX defaults; texturing/pipeline.py:59-69)
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096
    base_shift: float = 0.5
    max_shift: float = 1.15
    # steps served by velocity extrapolation instead of a transformer
    # evaluation (training-free acceleration, models/flux/pipeline.py
    # make_reuse_mask; 0 = the reference's exact 28-evaluation schedule)
    velocity_reuse: int = 0
    # replay the CUDA reference's torch.Generator stream for the initial
    # noise and the condition-encode posterior draws, threaded across the
    # texture+delight passes (models/flux/pipeline.torch_reference_rng) —
    # seed-exact randomness vs the reference
    torch_rng_parity: bool = False


@dataclasses.dataclass(frozen=True)
class BakeConfig:
    """Stage-2 multi-view -> UV texture baking (pipeline.py:312-360)."""

    uv_size: int = 2048
    grad_norm_threshold: float = 0.15        # screen-space gradient filter
    ray_normal_angle_threshold: float = 100.0  # degrees
    knn_k_visible: int = 8
    knn_k_invisible: int = 4
    depth_eps: float = 5e-3                  # visibility depth-test tolerance
    # per-view paste priority for reproject_blur bake: frtbld -> fblrtd
    # (renderer_inverse.py:44)
    view_priority: Tuple[int, ...] = (0, 3, 4, 1, 2, 5)
    blur_kernel: int = 21


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Point-cloud sampling budgets (pipeline.py:363-407)."""

    n_samples: int = 200_000
    n_fps: int = 32_768
    sharp_angle_deg: float = 15.0
    timeout_s: float = 60.0


@dataclasses.dataclass(frozen=True)
class SRConfig:
    """TSD-SR one-step SD3 x4 super-resolution (TSD_SR/sr_pipeline.py)."""

    upscale: int = 4
    latent_tile: int = 64
    latent_overlap: int = 8
    vae_tile: int = 1024
    timestep: float = 1000.0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout.  data axis = views/batch, model axis = TP over
    attention heads + MLP.  A pipeline whose process group spans more than
    one rank builds ``make_mesh(data=data_size, model=-1)``
    (``parallel/mesh.py``)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_size: int = 1
    model_size: int = 1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    camera: CameraConfig = CameraConfig()
    mesh: MeshConfig = MeshConfig()
    diffusion: DiffusionConfig = DiffusionConfig()
    bake: BakeConfig = BakeConfig()
    sampling: SamplingConfig = SamplingConfig()
    sr: SRConfig = SRConfig()
    parallel: ParallelConfig = ParallelConfig()
    super_resolution: bool = False
    orbit_frames: int = 120
    orbit_size: int = 1024
    orbit_fps: int = 15


DEFAULT_CONFIG = PipelineConfig()
