"""Training data (port of unitex_tpu/training/data.py).

* ``SyntheticTextureDataset`` renders (control, target) training pairs on
  the fly from procedural meshes and procedural textures, through the
  port's geometry and render stack on ``device``.
* ``DirectoryTextureDataset`` reads pre-rendered multi-view pairs from
  disk (the pipeline's own stage artifacts).

Both yield host-side numpy examples ``{"target", "control"[, "dual"]}`` in
[0, 1], as the JAX package's do, so the launcher batches them the same
way.  ``iterate_host_sharded`` batches a stream into this data rank's
slices of each global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..utils.precision import resolve_device


@dataclasses.dataclass
class SyntheticTextureDataset:
    """Procedural (control grid, textured target grid) pairs at toy or full
    resolution, rendered on ``device``."""

    view_size: int = 64
    rows: int = 2
    cols: int = 3
    seed: int = 0
    device: str = "cuda"

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        from ..geometry.mesh import Mesh
        from ..geometry.primitives import make_icosphere, make_torus
        from ..geometry.uv_atlas import unwrap_atlas
        from ..render.conditioning import render_geometry_condition, views_to_grid
        from ..render.renderer import render_views
        from ..render.renderer_inverse import uv_render

        dev = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        makers = [lambda: make_icosphere(3), make_torus]

        def put(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        while True:
            host = unwrap_atlas(
                makers[int(rng.integers(len(makers)))](), size=128, gutter=2
            )
            mesh = Mesh(
                put(host.vertices * 0.9),
                put(host.faces, torch.int64),
                uv=put(host.uv),
                faces_uv=put(host.faces_uv, torch.int64),
            )
            cond = render_geometry_condition(
                mesh, view_size=self.view_size, rows=self.rows, cols=self.cols
            )
            # procedural "ground-truth" texture: random low-frequency color
            # field of 3D position
            w = rng.normal(size=(3, 3)).astype(np.float32)
            uv_out = uv_render(mesh, 128, pixel_tile=0)
            pos = uv_out["position"].cpu().numpy()
            tex = 0.5 + 0.4 * np.tanh(pos @ w.T)
            tex = put(np.where(uv_out["mask"].cpu().numpy(), tex, 0.0))
            target = render_views(
                mesh, cond["c2ws"], cond["intrinsics"],
                (self.view_size, self.view_size),
                map_attr=tex, render_uv=True, render_map_attr=True,
            )
            target_grid = views_to_grid(target.map_attr, self.rows, self.cols)
            control_grid = 0.5 * cond["normal"] + 0.5 * cond["ccm"]
            yield {
                "target": target_grid.cpu().numpy(),
                "control": control_grid.cpu().numpy(),
            }


@dataclasses.dataclass
class DirectoryTextureDataset:
    """Pre-rendered multi-view training pairs from disk.

    One subdirectory per asset (or its ``cache/``) holding:

      ``mv_normal.png`` + ``mv_ccm.png``  -> texture-mode control
                                             (the 0.5/0.5 mix of infer_mv)
      ``mv_rgb_w_light.png``              -> texture-mode target and
                                             delight-mode control
      ``mv_rgb.png``                      -> delight-mode target (albedo)
      ``processed_image.png``             -> dual/reference image
                                             (texture mode only)

    Everything is converted to the 1x6 FLUX strip layout through the
    pipeline's own grid->strip permutation (render/conditioning.py):
    mv_normal/ccm/rgb are stored as 2x3 grids (mv_rgb possibly SR-upscaled,
    resized back to the control resolution as ``jax.image.resize`` does),
    while mv_rgb_w_light is already the strip.

    Yields ``{"target", "control"[, "dual"]}`` float arrays in [0, 1],
    shuffled per epoch.
    """

    root: str
    mode: str = "texture"  # or "delight"
    seed: int = 0
    with_dual: bool = True

    def _required(self) -> tuple:
        if self.mode == "texture":
            return ("mv_normal.png", "mv_ccm.png", "mv_rgb_w_light.png")
        if self.mode == "delight":
            return ("mv_rgb_w_light.png", "mv_rgb.png")
        raise ValueError(f"mode {self.mode!r} (texture | delight)")

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        import glob
        import os

        from ..pipeline import resize_bilinear
        from ..render.conditioning import grid_to_strip
        from ..utils.image_io import load_image

        need = self._required()

        def resolve(d):
            # artifacts either at the sample root or under its cache/
            # subdir (raw pipeline output dirs work as they are)
            for base in (d, os.path.join(d, "cache")):
                if all(os.path.exists(os.path.join(base, f)) for f in need):
                    return base
            return None

        samples = sorted(
            base
            for d in glob.glob(os.path.join(self.root, "*"))
            if os.path.isdir(d) and (base := resolve(d)) is not None
        )
        if not samples:
            raise FileNotFoundError(
                f"no sample dirs with {need} under {self.root!r}"
            )

        def strip(grid):
            return grid_to_strip(torch.from_numpy(np.asarray(grid, np.float32)))

        rng = np.random.default_rng(self.seed)
        while True:
            for i in rng.permutation(len(samples)):
                d = samples[i]

                def get(f):
                    return load_image(os.path.join(d, f))

                if self.mode == "texture":
                    grid = 0.5 * get("mv_normal.png") + 0.5 * get("mv_ccm.png")
                    control = strip(grid).numpy()
                    target = get("mv_rgb_w_light.png")  # saved as the strip
                else:
                    control = get("mv_rgb_w_light.png")
                    tgt = strip(get("mv_rgb.png"))
                    if tuple(tgt.shape[:2]) != control.shape[:2]:
                        # SR-upscaled albedo: bring back to control res
                        tgt = resize_bilinear(tgt, *control.shape[:2])
                    target = tgt.numpy()
                ex = {"target": target, "control": control}
                dual_path = os.path.join(d, "processed_image.png")
                if (
                    self.with_dual
                    and self.mode == "texture"  # delight serves without dual
                    and os.path.exists(dual_path)
                ):
                    ex["dual"] = load_image(dual_path)
                yield ex


def iterate_host_sharded(
    iterator: Iterator[Dict[str, np.ndarray]],
    global_batch: int,
    mesh: Optional[object] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Batch an example stream, yielding this rank's slice of each global
    batch (the per-host sharding the reference gets from accelerate's
    DistributedSampler): the slice of this rank's index on the ``data``
    axis of ``mesh`` (``parallel/mesh.Mesh``), of ``global_batch / data``
    examples; the whole batch without a mesh."""
    n = mesh.size("data") if mesh is not None else 1
    i = mesh.index("data") if mesh is not None else 0
    per_rank = global_batch // max(n, 1)
    buf: list = []
    for ex in iterator:
        buf.append(ex)
        if len(buf) == global_batch:
            sl = buf[i * per_rank:(i + 1) * per_rank]
            yield {k: np.stack([e[k] for e in sl]) for k in sl[0].keys()}
            buf = []
