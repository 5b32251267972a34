"""End-to-end texture generation pipeline (port of unitex_tpu/pipeline.py).

One RGB reference image + an untextured mesh -> a textured GLB:

  step_1_1        mesh preprocess -> reference-image matting -> 6-view
                  geometry conditioning renders -> FLUX texture pass ->
                  FLUX delight pass -> with ``super_resolutions=True``
                  the TSD-SR x4 stage (models/sd3/sr_pipeline.py)
  step_2_ablition multi-view back-projection bake -> textured_mesh.glb

Artifact names match the JAX package, so its tooling (for example
scripts/compare_golden.py) reads both: ``processed_mesh.obj``,
``rembg_image.png``, ``processed_image.png``, ``mv_alpha/ccm/normal.png``,
``camera_info.npz``, ``mv_rgb_w_light.png``, ``mv_rgb_lr.png`` (the grid
before super-resolution), ``mv_rgb.png``,
``textured_mesh.glb``, ``visable_uv_mask.png``, ``valid_uv_mask.png``,
``completed_uv.png``, and with ``export_video=True`` the orbit video
``textured_mesh.mp4`` (``.gif`` without an mp4 writer).

Every device stage runs on ``device`` (default ``"cuda"``; asking for CUDA
without a card raises).  Weights: ``pretrain_models`` names a root with
``flux/transformer`` and ``flux/vae`` (diffusers safetensors) and the two
adapters ``texture_lora.safetensors`` / ``delight_lora.safetensors``,
streamed straight onto the device; without them (and with
``require_weights=False``) the control strip stands in for both FLUX
passes, so the geometry and bake stages still run.  Or
``random_weights=True`` (a full-size random FLUX tree made on the
device), or parameter trees set by the caller (for example carried from
the JAX package by ``params_from_jax``).  int8 serving
(``int8_serving=True``: W8A8 projections; ``"max_memory"``: plus
weight-only int8 for the other block kernels), with the LoRA adapters
attached at run time instead of merged; ``attn_qk8`` set on
``pipe.flux_cfg`` (the int8-QK attention kernel B3); and the serving-tree
cache (``params_cache``, optionally int4-packed with
``params_cache_int4``), whose files either package reads.
``RGBTextureFullPipeline`` bakes with the learned LTM fill
(``ltm_params``, such as the repo's trained ``ltm_params.npz``; step_2_2).
``super_resolutions=True`` adds TSD-SR (SD3-medium and its VAE from
``<pretrain_models>/sd3``; without them the bicubic x4 upscale, as in
the JAX package), whole grid, or per view under ``"max_memory"``.
Reference-image matting is the JAX package's choice of backend
(``image/rembg.py``): ISNet for ``<root>/briaai/RMBG-1.4`` weights,
BiRefNet for ``<root>/briaai/RMBG-2.0``, on ``device``; else the
heuristic.  ``async_io=True`` puts the GLB encode and the copies after it
on one writer thread, in order, so they overlap the next job's device
work; ``flush_io()`` waits for them.

Across GPUs (one process each, under ``torchrun``): when the default
process group spans more than one rank (or ``WORLD_SIZE`` says it will),
or when a ``mesh`` is given, the pipeline serves on a ``(data, model)``
mesh (``parallel/mesh.make_mesh(data=config.parallel.data_size,
model=-1)``): the FLUX tree and its adapters are cut to each rank's
tensor-parallel slices (``parallel/sharding.py``) and the SR stage runs
tensor-parallel over ``model`` with its tile batches over ``data``.  Rank
0 does the job's host work (preprocess, matting, the condition renders,
every file, the bake and the GLB) and broadcasts what the others need:
each FLUX pass's noise, condition latents and prompt embeddings, and the
grid the SR stage starts from.  The other ranks run the FLUX passes and
the SR stage in step with it, then wait for rank 0's end of the job
(``parallel/mesh.end_job``); none redoes host work, so no rank's inputs
can differ by a bit.  Rank 0 announces each job (a job, ``prewarm``, and
outside a job ``infer_mv_stage`` or ``_apply_sr``) before its part
starts; the other ranks call the same entry point or :meth:`follow`,
which runs every job rank 0 announces until :meth:`release_followers`.
A job whose part on rank 0 fails at a host-side point (the preprocess,
the renders, a pass's inputs or decode, the bake, a file) ends with that
failure for every rank, at the broadcast where the others wait
(``JobAborted``), and the next job starts in step.  A failure inside the
collectives every rank runs together (the broadcast's tensors, the
denoise, the SR stage) ends the process instead
(``parallel/mesh.collective_section``), and the launcher ends the other
ranks.  int8 serving quantizes each whole node before it is cut
(``models/flux/quantize.quantize_hook``), as the JAX package quantizes
the whole tree before it shards it.  The serving-tree cache stays the
one-card file: rank 0 writes it from the whole nodes gathered from the
ranks' slices while the others wait at a barrier; on a hit every rank
reads and validates it and keeps its slices, node by node (an
int4-packed node is unpacked before the cut).  ``prewarm`` runs its
synthetic job on every rank in step, as a job does.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .config import DEFAULT_CONFIG, PipelineConfig
from .geometry.io.mesh_io import HostMesh, load_mesh, save_mesh, save_obj
from .geometry.mesh import Mesh, pad_mesh_to_bucket
from .geometry.uv_atlas import preprocess_blank_mesh
from .image.process_image import preprocess_reference_image
from .image.rembg import build_background_remover
from .models.flux.config import FluxConfig
from .models.flux.loader import load_flux_transformer, load_vae
from .models.flux.lora import (
    attach_lora,
    init_lora_params,
    load_lora_safetensors,
    merge_lora,
)
from .models.flux.model import flux_param_spec, init_flux_params, tp_config
from .models.flux.quantize import quantize_flux_params, quantize_hook
from .models.flux.pipeline import (
    FluxPipelineConfig,
    flux_decode,
    flux_denoise,
    flux_inputs,
    run_flux_pipeline,
    torch_reference_rng,
)
from .models.flux.vae import VAEConfig, init_vae_params
from .ops.quant import gemm_layout, pack_int4_tree, unpack_int4_tree
from .parallel.mesh import Mesh as RankMesh
from .parallel.mesh import (
    JobAborted,
    broadcast_tensors,
    collective_section,
    end_job,
    make_mesh,
    next_job,
    start_job,
    wait_job,
    world_size_from_env,
)
from .parallel.sharding import (
    is_linear,
    shard_flux_params,
    shard_hook,
    shard_tree,
    unshard_node,
)
from .render.conditioning import (
    grid_to_strip,
    grid_to_views,
    render_geometry_condition,
    strip_to_grid,
)
from .render.renderer_inverse import bake_texture
from .render.video import export_orbit_video
from .utils.image_io import save_image, to_uint8_device
from .utils.param_cache import load_meta, load_params, save_params
from .utils.params import tree_to
from .utils.precision import resolve_device
from .utils.resize import resize_bilinear
from .utils.timer import CPUTimer


# int8_serving mode -> the cache file's mode name (the JAX package's)
_CACHE_MODES = {False: "bf16", True: "int8", "max_memory": "int8wo"}
_INT8_KERNELS = ("kernel_int8", "kernel_int8_wo")
_INT4_KERNELS = ("kernel_int4", "kernel_int4_wo")


def _meta_tree(tree):
    """A spec tree (``utils/params``: leaves are tuples, bf16) or a tensor
    tree as tensors on the ``meta`` device: shapes and dtypes only."""
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return torch.empty(tree[1], dtype=torch.bfloat16, device="meta")
    return torch.empty_like(tree, device="meta")


def _leaf_types(tree, prefix="") -> Dict[str, tuple]:
    """{"a/b/c": (shape, dtype)} of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_leaf_types(v, path))
        else:
            out[path] = (tuple(v.shape), v.dtype)
    return out


def _gathered_to_host(tree, mesh, transform):
    """The whole serving tree on rank 0's host from the ``model`` ranks'
    slices, gathered node by node and each whole node passed through
    ``transform`` on the device (every rank calls it; the others get None
    in place of each linear node), so a rank holds one whole node beyond
    its slices at a time."""
    group = mesh.group("model")

    def node(path, part):
        whole = transform(unshard_node(path, part, group))
        return tree_to(whole, "cpu") if mesh.is_root else None

    return shard_tree(tree, node)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


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
        params_cache_int4: bool = False,
        device="cuda",
        mesh: Optional[RankMesh] = None,
    ):
        if int8_serving not in _CACHE_MODES:
            raise ValueError(f"int8_serving must be False, True or "
                             f"'max_memory', got {int8_serving!r}")
        if mesh is None and (world_size_from_env() > 1 or (
                dist.is_initialized() and dist.get_world_size() > 1)):
            mesh = make_mesh(data=config.parallel.data_size, model=-1,
                             device=device)
        # the (data, model) mesh of a multi-rank job, or None on one device
        self.device_mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.config = config
        self.seed = seed
        self.pretrain_models = pretrain_models
        self.save_artifacts = save_artifacts
        # int8_serving: False (bf16) | True (W8A8) | "max_memory" (W8A8 +
        # weight-only int8 for the rest of the block kernels); the LoRA
        # adapters are then attached at run time (lora.attach_lora)
        self.int8_serving = int8_serving
        # params_cache: a directory for the post-quantization serving tree
        # (utils/param_cache.py), one file per kind and mode;
        # params_cache_int4 stores its int8 kernels int4-packed (lossy,
        # opt-in, int8 modes only) and unpacks them on the device
        self.params_cache = params_cache
        self.params_cache_int4 = params_cache_int4 and bool(int8_serving)
        # kinds whose cache failed validation: the rebuilt tree overwrites
        self._stale_caches: set = set()
        # async_io: the GLB encode and write and the copies after it run on
        # one writer thread, which keeps their order; flush_io() joins them
        self._io_pool = None
        self._io_pending = []
        if async_io:
            from concurrent.futures import ThreadPoolExecutor

            self._io_pool = ThreadPoolExecutor(max_workers=1)
        # matting is host work: rank 0's alone
        self.rembg = (build_background_remover(pretrain_models,
                                               device=self.device)
                      if self._is_root else None)
        self.flux_cfg = FluxConfig.flux1_dev()
        self.vae_cfg = VAEConfig.flux()
        self._flux_loaded = False
        self.transformer_params = None
        self.vae_params = None
        self.texture_lora = None
        self.delight_lora = None
        self.sr_pipeline = None
        if pretrain_models is not None:
            self._try_load_weights(require_weights)
        elif random_weights:
            self._init_random_weights()
        elif require_weights:
            raise FileNotFoundError("pretrain_models is required")
        if super_resolutions:
            from .models.sd3.sr_pipeline import TSDSRPipeline

            # SD3 and its VAE from <root>/sd3; without them the SR stage is
            # the bicubic upscale, as in the JAX package
            self.sr_pipeline = TSDSRPipeline(pretrain_models,
                                             mesh=self.device_mesh,
                                             device=self.device)

    # bump when the serving tree's layout or the file encoding changes
    _PARAMS_CACHE_VERSION = 1
    # the mesh the pipeline serves on (set by ``__init__``), and rank 0
    # inside a job on it (:meth:`_mesh_job`)
    device_mesh: Optional[RankMesh] = None
    _in_job = False
    # the kind of the port's random tree: another generator than the JAX
    # package's ``flux_random_s0``, so another tree
    RANDOM_KIND = "flux_random_torch_s0"

    @property
    def _is_root(self) -> bool:
        return self.device_mesh is None or self.device_mesh.is_root

    def _shard(self, tree):
        """This rank's slices of a FLUX or adapter tree on a mesh."""
        if self.device_mesh is None or tree is None:
            return tree
        return shard_flux_params(tree, self.device_mesh)

    def set_flux_trees(self, transformer, vae, texture_lora=None,
                       delight_lora=None) -> None:
        """Serve the given whole trees (on a mesh: this rank's slices of
        the transformer and adapters; the caller's tree stays whole)."""
        self.transformer_params = self._shard(transformer)
        self.texture_lora = self._shard(texture_lora)
        self.delight_lora = self._shard(delight_lora)
        self.vae_params = vae
        self._flux_loaded = True

    def _init_random_weights(self) -> None:
        """Random-init the serving tree at full size, directly on the
        device in bf16 (the VAE and LoRA in f32, as the JAX package serves
        them), each linear node quantized for int8 serving as soon as it
        is drawn; or read it from ``params_cache``.  On a mesh every rank
        draws the same tree and keeps its slices, each linear node
        (quantized whole first) cut as soon as it is drawn.  Outputs are
        meaningless images; every shape, kernel launch and memory
        footprint is the real one."""
        gen = torch.Generator(device=self.device)
        cached = self._load_cached_tree(self.RANDOM_KIND)
        if cached is not None:
            self.transformer_params = self._place_flux_params(*cached)
        else:
            mesh = self.device_mesh
            params = init_flux_params(
                gen.manual_seed(0), self.flux_cfg, device=self.device,
                dtype=torch.bfloat16, hook=quantize_hook(
                    self.int8_serving,
                    None if mesh is None else shard_hook(mesh)))
            self.transformer_params = params
            self._store_cached_tree(self.RANDOM_KIND, params)
        # the adapters take the whole tree's shapes (a cut tree's differ)
        shapes = self.transformer_params
        if self.device_mesh is not None:
            shapes = _meta_tree(flux_param_spec(self.flux_cfg))
        self.texture_lora = self._shard(init_lora_params(
            gen.manual_seed(1), shapes, rank=16, device=self.device))
        self.delight_lora = self._shard(init_lora_params(
            gen.manual_seed(2), shapes, rank=16, device=self.device))
        self.vae_params = init_vae_params(gen.manual_seed(3), self.vae_cfg,
                                          device=self.device)
        self._flux_loaded = True

    @CPUTimer("load_weights")
    def _try_load_weights(self, require: bool) -> None:
        """The serving tree, VAE and adapters of ``pretrain_models``
        (``flux/transformer``, ``flux/vae`` and the adapter files
        ``texture_lora.safetensors`` / ``delight_lora.safetensors``, either
        of which may be missing), or the serving tree from
        ``params_cache``.  Everything is read straight onto the
        device: the transformer in bf16, each node quantized for int8
        serving as it is read (and on a mesh then cut); the VAE and the
        adapters in f32, as random init makes them.  A missing file raises
        ``FileNotFoundError`` under ``require``; otherwise the pipeline
        runs weightless."""
        root = self.pretrain_models
        try:
            cached = self._load_cached_tree("flux")
            if cached is not None:
                params = self._place_flux_params(*cached)
            else:
                params = load_flux_transformer(
                    os.path.join(root, "flux", "transformer"), self.flux_cfg,
                    device=self.device, dtype=torch.bfloat16,
                    mesh=self.device_mesh, int8_serving=self.int8_serving)
            vae = load_vae(os.path.join(root, "flux", "vae"), self.vae_cfg,
                           device=self.device, dtype=torch.float32)
            loras = {}
            for name in ("texture", "delight"):
                path = os.path.join(root, f"{name}_lora.safetensors")
                if os.path.exists(path):
                    loras[name] = self._shard(load_lora_safetensors(
                        path, self.flux_cfg.num_layers,
                        self.flux_cfg.num_single_layers, device=self.device))
            if cached is None:
                self._store_cached_tree("flux", params)
        except OSError as e:  # FileNotFoundError among them
            if require:
                raise
            print(f"[pipeline] FLUX weights not found ({e}); running weightless")
            return
        self.transformer_params, self.vae_params = params, vae
        self.texture_lora = loras.get("texture")
        self.delight_lora = loras.get("delight")
        self._flux_loaded = True

    # ------------------------------------------------------- params cache

    def _cache_path(self, kind: str) -> Optional[str]:
        if not self.params_cache:
            return None
        mode = _CACHE_MODES[self.int8_serving]
        if self.params_cache_int4:
            mode += "4"
        return os.path.join(self.params_cache, f"{kind}_{mode}.npz")

    def _cache_meta(self, kind: str) -> Dict[str, object]:
        """The cache's fingerprint: the format version and the tree's
        source, the JAX package's: a checkpoint's transformer directory
        and its mtime, or a random tree's kind (which names its generator
        and seed)."""
        src = kind
        if self.pretrain_models:
            src = os.path.join(self.pretrain_models, "flux", "transformer")
            try:
                src = f"{src}:{os.path.getmtime(src):.0f}"
            except OSError:
                pass
        return {"version": self._PARAMS_CACHE_VERSION, "source": src}

    def _expected_serving_tree(self):
        """The serving tree of ``flux_cfg`` and the int8 mode, as tensors on
        the ``meta`` device (shapes and dtypes only), from the spec tree."""
        tree = _meta_tree(flux_param_spec(self.flux_cfg))
        if self.int8_serving:
            tree = quantize_flux_params(
                tree, weight_only_rest=self.int8_serving == "max_memory")
        return tree

    def _validate_cached_tree(self, tree) -> Optional[str]:
        """A mismatch of leaf paths, shapes or dtypes against
        :meth:`_expected_serving_tree`, or None."""
        want = _leaf_types(self._expected_serving_tree())
        got = _leaf_types(tree)
        for path in sorted(set(want) | set(got)):
            if want.get(path) != got.get(path):
                return (f"{path}: {got.get(path, 'missing')} != expected "
                        f"{want.get(path, 'none')}")
        return None

    def _load_cached_tree(self, kind: str):
        """(host tree, whether it is int4-packed) from the cache, or None
        when there is no file or it fails its fingerprint or layout check
        (the kind is then marked stale, so the rebuilt tree overwrites
        it)."""
        path = self._cache_path(kind)
        if not (path and os.path.exists(path)):
            return None
        meta = load_meta(path)
        if meta is not None and meta != self._cache_meta(kind):
            print(f"[pipeline] params cache STALE {path}: fingerprint {meta} "
                  f"!= {self._cache_meta(kind)}; rebuilding")
            self._stale_caches.add(kind)
            return None
        t0 = time.perf_counter()
        tree = load_params(path)
        if self.params_cache_int4:
            try:
                err = self._validate_cached_tree(
                    unpack_int4_tree(_meta_tree(tree)))
            except Exception as e:  # a malformed pack is a stale cache
                err = f"int4 unpack failed: {e}"
        else:
            err = self._validate_cached_tree(tree)
        if err is not None:
            print(f"[pipeline] params cache STALE {path}: {err}; rebuilding")
            self._stale_caches.add(kind)
            return None
        print(f"[pipeline] params cache hit {path} "
              f"({time.perf_counter() - t0:.1f}s)")
        return tree, self.params_cache_int4

    def _store_cached_tree(self, kind: str, tree) -> None:
        """Write the serving tree to the cache when it has no valid file
        (int4-packed on the device with ``params_cache_int4``).  On a mesh
        the file is the one-card file: the whole nodes are gathered from
        the ranks' slices and packed on the device as one card packs them
        (:func:`_gathered_to_host`), rank 0 writes them, and the other
        ranks wait at a barrier."""
        path = self._cache_path(kind)
        if not path or (os.path.exists(path) and kind not in self._stale_caches):
            return
        mesh = self.device_mesh
        pack = pack_int4_tree if self.params_cache_int4 else (lambda t: t)
        t0 = time.perf_counter()
        tree = pack(tree) if mesh is None else _gathered_to_host(tree, mesh,
                                                                  pack)
        if self._is_root:
            save_params(path, tree, meta=self._cache_meta(kind))
            print(f"[pipeline] params cache write {path} "
                  f"({time.perf_counter() - t0:.1f}s)")
        self._stale_caches.discard(kind)
        if mesh is not None:
            dist.barrier()

    def _place_flux_params(self, tree, packed: bool):
        """A host serving tree on the device, one linear node at a time:
        an int4-packed node is unpacked there, its packed leaves dropped
        once unpacked, so the packed and the unpacked kernels are never
        both whole; int8 kernels take the GEMM's layout; on a mesh each
        node is then cut to this rank's slices, so a rank holds its
        slices and one whole node."""
        mesh = self.device_mesh
        hook = None if mesh is None else shard_hook(mesh)

        def place(node, path=()):
            if not isinstance(node, dict):
                node = node.to(self.device)
                return gemm_layout(node) if path[-1] in _INT8_KERNELS else node
            if packed and any(k in node for k in _INT4_KERNELS):
                node = unpack_int4_tree(node, consume=True, device=self.device)
            out = {k: place(v, path + (k,)) for k, v in node.items()}
            return hook(path, out) if hook and is_linear(out) else out

        return place(tree)

    def _generator(self) -> torch.Generator:
        """A fresh device generator seeded with the job seed: each FLUX
        pass draws its noise from the same seed, as the JAX package passes
        both passes the same key."""
        return torch.Generator(device=self.device).manual_seed(self.seed)

    # ------------------------------------------------------------ stages

    def _submit_io(self, fn, *args) -> None:
        """Run ``fn(*args)`` now, or with ``async_io`` enqueue it on the
        ordered one-thread writer pool."""
        if self._io_pool is None:
            fn(*args)
        else:
            # a long-lived server never flushes: drop the writes that ended
            # well, keep the failures for flush_io to raise
            self._io_pending = [f for f in self._io_pending
                                if not f.done() or f.exception() is not None]
            self._io_pending.append(self._io_pool.submit(fn, *args))

    def flush_io(self) -> None:
        """Wait for every pending write, re-raising the first failure."""
        pending, self._io_pending = self._io_pending, []
        for f in pending:
            f.result()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prewarm(self, n_faces_hint: int = 20_000) -> Dict[str, float]:
        """Run every device stage once on a synthetic asset (an icosphere
        at the face budget's default bucket and a flat 256² image) before
        the first real job, so a server's first job does not pay the
        kernels' builds and the allocator's growth; returns the seconds of
        each stage.  The job server calls it on its device thread.  On a
        mesh every rank calls it together (or the other ranks
        :meth:`follow`): they run their part of the job, as in
        :meth:`_run`, and return the seconds of theirs."""
        import tempfile

        if not self._is_root:
            t0 = time.perf_counter()
            self._follow_one("prewarm")
            return {"infer_mv": round(time.perf_counter() - t0, 2)}

        from PIL import Image

        from .geometry.primitives import make_icosphere

        timings: Dict[str, float] = {}
        with tempfile.TemporaryDirectory(prefix="prewarm_") as d, \
                self._mesh_job("prewarm"):
            subdiv, faces = 2, 320
            while faces * 4 <= max(n_faces_hint, 1280):
                subdiv, faces = subdiv + 1, faces * 4
            mesh_path = os.path.join(d, "prewarm.obj")
            save_mesh(mesh_path, make_icosphere(subdiv))
            img = np.full((256, 256, 3), 255, np.uint8)
            img[64:192, 64:192] = [180, 80, 40]
            img_path = os.path.join(d, "prewarm.png")
            Image.fromarray(img).save(img_path)

            t0 = time.perf_counter()
            processed, ref_image = self.preprocess_job(d, img_path, mesh_path)
            timings["host_preprocess"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            condition = self.render_geometry_images_stage(d, processed)
            self._sync()
            timings["render_geometry"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            mv_rgb = self.infer_mv_stage(d, ref_image, condition)
            self._sync()
            timings["infer_mv"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            self.reproject_stage(d, condition["mesh"], mv_rgb, condition,
                                 processed)
            self.flush_io()
            timings["reproject"] = time.perf_counter() - t0
        return {k: round(v, 2) for k, v in timings.items()}

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
        low_memory = self.int8_serving == "max_memory" and self._flux_loaded
        out = render_geometry_condition(
            device_mesh,
            view_size=cam.view_size,
            radius=cam.radius,
            ortho_scale=cam.ortho_scale,
            background=0.5,
            rows=cam.rows,
            cols=cam.cols,
            # max_memory serving: slab the per-pixel tail and bound the
            # binned rasterizer's batch, as the JAX package does
            row_chunk=64 if low_memory else None,
            tile_batch=8 if low_memory else 64,
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
        apply_sr: bool = True,
    ) -> torch.Tensor:
        """Texture + delight FLUX passes over the 1x6 strip.  Returns the
        delighted 2x3 grid in [0, 1], super-resolved when the pipeline has
        an SR stage (a uint8 grid on the host under ``"max_memory"``).
        Without FLUX weights the control strip (geometry-shaded) stands in
        for both passes.  ``apply_sr=False`` leaves the SR stage to the
        caller (:meth:`_apply_sr`), as batch scripts do.  On a mesh,
        outside a job, it is a job of its own: the other ranks run their
        part of it (:meth:`follow`, or their own call) and return None."""
        if not self._is_root:
            self._follow_one("infer_mv")
            return None
        with self._mesh_job("infer_mv", apply_sr=apply_sr):
            return self._infer_mv(save_dir, reference_image, condition,
                                  apply_sr)

    def _infer_mv(self, save_dir, reference_image, condition, apply_sr):
        """Rank 0's (or the one device's) :meth:`infer_mv_stage`."""
        control_grid = 0.5 * condition["normal"] + 0.5 * condition["ccm"]
        control_strip = grid_to_strip(control_grid)
        if self._flux_loaded:
            strip_delight = self._flux_passes(save_dir, reference_image,
                                              control_strip)
        else:
            if self.save_artifacts:
                save_image(os.path.join(save_dir, "mv_rgb_w_light.png"),
                           _host(control_strip))
            strip_delight = control_strip
        mv_rgb = strip_to_grid(strip_delight)
        if apply_sr:
            mv_rgb = self._apply_sr(mv_rgb, save_dir)
        if self.save_artifacts and (apply_sr or self.sr_pipeline is None):
            # timed: the SR grid is 4096 x 6144, encoded on the host
            with CPUTimer("save_mv_rgb"):
                save_image(os.path.join(save_dir, "mv_rgb.png"), _host(mv_rgb))
        return mv_rgb

    def _apply_sr(self, mv_rgb: torch.Tensor, save_dir: Optional[str] = None):
        """TSD-SR on the delighted grid: the whole grid at once, or with
        ``int8_serving="max_memory"`` and FLUX loaded one view at a time
        inside one ``staged()`` window, each view quantized to uint8 on the
        device and assembled into a uint8 grid on the host.  There the
        AdaIN colour fix, whose statistics are per grid, runs as one
        grid-level affine on the host over views super-resolved without a
        colour fix; the wavelet fix stays per view.  On a mesh, outside a
        job, it is a job of its own, as :meth:`infer_mv_stage` is."""
        if self.sr_pipeline is None:
            return mv_rgb
        if not self._is_root:
            self._follow_one("sr")
            return None
        with self._mesh_job("sr"):
            if self.save_artifacts and save_dir is not None:
                save_image(os.path.join(save_dir, "mv_rgb_lr.png"),
                           _host(mv_rgb))
            with CPUTimer("super_resolution"):
                if not self._sr_per_view():
                    return self.sr_pipeline(mv_rgb)
                return self._apply_sr_per_view(mv_rgb)

    def _sr_per_view(self) -> bool:
        return self.int8_serving == "max_memory" and self._flux_loaded

    def _follow_sr(self) -> None:
        """A rank other than 0: its part of :meth:`_apply_sr`, one SR call
        for each of rank 0's (one a view in the per-view branch)."""
        if self.sr_pipeline is None:
            return
        cam = self.config.camera
        n = cam.rows * cam.cols if self._sr_per_view() else 1
        with self.sr_pipeline.staged():
            for _ in range(n):
                self.sr_pipeline(None)

    def _apply_sr_per_view(self, mv_rgb: torch.Tensor) -> torch.Tensor:
        """:meth:`_apply_sr`'s ``"max_memory"`` branch: the uint8 grid."""
        from .models.sd3.sr_pipeline import upscale_clip

        cam = self.config.camera
        views = grid_to_views(mv_rgb, cam.rows, cam.cols)
        sr_cfg = self.sr_pipeline.cfg
        align = sr_cfg.align_method
        grid_adain = align == "adain"
        if grid_adain:
            sr_cfg.align_method = "nofix"
        try:
            with self.sr_pipeline.staged():
                sr_views = [_host(to_uint8_device(self.sr_pipeline(v)))
                            for v in views]
                if grid_adain:
                    # the AdaIN source is the bicubic upscale
                    ups = [_host(to_uint8_device(
                        upscale_clip(v, sr_cfg.upscale))) for v in views]
        finally:
            sr_cfg.align_method = align
        if grid_adain:
            t = np.stack(sr_views).astype(np.float32) / 255.0
            s = np.stack(ups).astype(np.float32) / 255.0
            ax = (0, 1, 2)
            a = (s.std(axis=ax) + 1e-5) / (t.std(axis=ax) + 1e-5)
            b = s.mean(axis=ax) - a * t.mean(axis=ax)
            sr_views = [(np.clip(a * v + b, 0.0, 1.0) * 255.0 + 0.5)
                        .astype(np.uint8) for v in t]
        return torch.from_numpy(np.concatenate(
            [np.concatenate(sr_views[r * cam.cols:(r + 1) * cam.cols], axis=1)
             for r in range(cam.rows)], axis=0))

    def _flux_pass(self, params, pipe_cfg: FluxPipelineConfig, control,
                   dual, plan) -> Optional[torch.Tensor]:
        """One FLUX pass -> [H, W, 3].  On a mesh rank 0 makes the inputs
        (noise, condition latents, prompt embeddings) and broadcasts them,
        every rank denoises on its slices, and rank 0 decodes; the other
        ranks return None."""
        mesh = self.device_mesh
        if mesh is None:
            return run_flux_pipeline(
                params, self.flux_cfg, self.vae_params, self.vae_cfg,
                self._generator(), pipe_cfg, control_image=control,
                dual_image=dual, device=self.device, **plan)
        inputs = None
        if mesh.is_root:
            inputs = flux_inputs(
                self.flux_cfg, self.vae_params, self.vae_cfg,
                self._generator(), pipe_cfg, control_image=control,
                dual_image=dual, device=self.device, **plan)
        inputs = broadcast_tensors(inputs, mesh)
        with collective_section():
            tokens = flux_denoise(
                params, tp_config(self.flux_cfg, mesh.group("model")), inputs,
                pipe_cfg)
        if not mesh.is_root:
            return None
        return flux_decode(self.vae_params, self.vae_cfg, tokens, pipe_cfg)

    def _flux_passes(self, save_dir: str, reference_image: np.ndarray,
                     control_strip: torch.Tensor) -> torch.Tensor:
        """The texture pass (dual image, adapters [1, 0]) and the delight
        pass on its output (adapters [0, 1]); returns the delighted
        strip (None on a rank other than 0 of a mesh, which passes None
        for the images)."""
        root = self._is_root
        dcfg = self.config.diffusion
        pipe_cfg = FluxPipelineConfig(
            height=dcfg.height,
            width=dcfg.width,
            num_inference_steps=dcfg.num_inference_steps,
            guidance_scale=dcfg.guidance_scale,
            max_sequence_length=dcfg.max_sequence_length,
            velocity_reuse=dcfg.velocity_reuse,
        )
        plan_tex = plan_del = {}
        if dcfg.torch_rng_parity and root:
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
        dual = None
        if root:
            dual = torch.from_numpy(np.asarray(reference_image, np.float32)
                                    ).to(self.device)
            ds = dcfg.dual_size
            if tuple(dual.shape[:2]) != (ds, ds):
                dual = resize_bilinear(dual, ds, ds)
        # texture pass: adapters [1, 0]; merged kernels (bf16) or attached
        # low-rank leaves (int8 kernels cannot be merged) are fresh
        # tensors, dropped right after the pass
        apply_lora = attach_lora if self.int8_serving else merge_lora
        params = apply_lora(
            self.transformer_params,
            [(self.texture_lora, 1.0), (self.delight_lora, 0.0)],
        )
        strip_w_light = self._flux_pass(params, pipe_cfg, control_strip, dual,
                                        plan_tex)
        del params
        if self.save_artifacts and root:
            save_image(os.path.join(save_dir, "mv_rgb_w_light.png"),
                       _host(strip_w_light))
        # delight pass: adapters [0, 1], control = stage-1 output, no dual
        params = apply_lora(self.transformer_params,
                            [(self.delight_lora, 1.0)])
        strip_delight = self._flux_pass(params, pipe_cfg, strip_w_light, None,
                                        plan_del)
        del params
        return strip_delight

    def _bake(self, mesh: Mesh, views: torch.Tensor,
              condition: Dict[str, torch.Tensor], **bake_kwargs):
        """``bake_texture(method="reproject")`` of the views with the
        config's bake settings; with ``int8_serving="max_memory"`` and FLUX
        weights held, the JAX package's low-memory bake (views pasted one
        at a time in row slabs, a smaller KNN chunk)."""
        bcfg = self.config.bake
        if self._max_memory_bake():
            bake_kwargs.update(low_hbm=True, knn_chunk=1024)
        return bake_texture(
            mesh, views, condition["c2ws"], condition["intrinsics"],
            uv_size=bcfg.uv_size,
            perspective=self.config.camera.perspective,
            method="reproject",
            grad_norm_threshold=bcfg.grad_norm_threshold,
            ray_normal_angle_threshold=bcfg.ray_normal_angle_threshold,
            depth_eps=bcfg.depth_eps,
            **bake_kwargs,
        )

    def _max_memory_bake(self) -> bool:
        return self.int8_serving == "max_memory" and self._flux_loaded

    def _views(self, mv_rgb_grid: torch.Tensor) -> torch.Tensor:
        """The grid's views in f32 on the device; a uint8 grid (the
        per-view SR's) is converted there."""
        cam = self.config.camera
        grid = mv_rgb_grid.to(self.device)
        grid = grid.float() / 255.0 if grid.dtype == torch.uint8 else grid.float()
        return grid_to_views(grid, cam.rows, cam.cols)

    def _write_textured(self, save_dir: str, texture: torch.Tensor,
                        processed_mesh: HostMesh, save_uv: bool) -> str:
        """The GLB of the baked texture (written through :meth:`_submit_io`),
        and ``completed_uv.png`` with ``save_uv``; keeps the f32 texture as
        ``last_texture`` for callers that check it.  The texture comes to
        the host here, so only the calling thread touches the device."""
        self.last_texture = texture
        tex_u8 = _host(to_uint8_device(texture))
        if save_uv:
            save_image(os.path.join(save_dir, "completed_uv.png"), tex_u8)
        glb_path = os.path.join(save_dir, "textured_mesh.glb")
        self._submit_io(save_mesh, glb_path, HostMesh(
            processed_mesh.vertices, processed_mesh.faces,
            uv=processed_mesh.uv, faces_uv=processed_mesh.faces_uv,
            texture=tex_u8,
        ))
        return glb_path

    @CPUTimer("reproject_and_query_field")
    def reproject_stage(
        self,
        save_dir: str,
        mesh: Mesh,
        mv_rgb_grid: torch.Tensor,
        condition: Dict[str, torch.Tensor],
        processed_mesh: HostMesh,
    ) -> str:
        views = self._views(mv_rgb_grid)
        size = self.config.camera.view_size
        extra = {}
        if self._max_memory_bake() and views.shape[1] > size:
            # views larger than the camera's (super-resolved): the geometry
            # at the camera's size, the colour sampled at the views'
            extra = dict(low_hbm_row_chunk=64, geometry_size=(size, size))
        out = self._bake(mesh, views, condition, **extra)
        if self.save_artifacts:
            save_image(os.path.join(save_dir, "visable_uv_mask.png"),
                       _host(to_uint8_device(out["mask_visible_any"].float())))
            save_image(os.path.join(save_dir, "valid_uv_mask.png"),
                       _host(to_uint8_device(out["mask_2d"].float())))
        return self._write_textured(save_dir, out["texture"], processed_mesh,
                                    save_uv=self.save_artifacts)

    def _run(self, save_dir: str, image_path: str, mesh_path: str, bake_stage,
             clear_cache: bool = False, export_video: bool = False,
             preprocessed=None) -> Tuple[str, str]:
        """One job through step_1_1 and ``bake_stage``; returns the matted
        reference image's and the GLB's paths under ``save_dir``.  On a
        mesh, a rank other than 0 runs its part of the FLUX passes and the
        SR stage, waits for rank 0's end of the job and returns (None,
        None); where rank 0's part fails at a host-side point, it raises
        ``JobAborted``."""
        if not self._is_root:
            self._follow_one("job")
            return None, None
        with self._mesh_job("job"):
            cache = os.path.join(save_dir, "cache")
            os.makedirs(cache, exist_ok=True)
            if preprocessed is None:
                preprocessed = self.preprocess_job(save_dir, image_path,
                                                   mesh_path)
            processed_mesh, ref_image = preprocessed
            condition = self.render_geometry_images_stage(cache,
                                                          processed_mesh)
            mv_rgb = self.infer_mv_stage(cache, ref_image, condition)
            glb_path = bake_stage(cache, condition["mesh"], mv_rgb, condition,
                                  processed_mesh)
            if export_video:
                self.flush_io()  # the exporter reads the GLB back from disk
                self.export_video_stage(cache, glb_path, "textured_mesh.mp4")
            rembg_out = os.path.join(save_dir, "rembg_image.png")
            glb_out = os.path.join(save_dir, "textured_mesh.glb")
            shutil.copy(os.path.join(cache, "rembg_image.png"), rembg_out)
            # ordered behind the GLB's write on the same writer thread
            self._submit_io(shutil.copy, glb_path, glb_out)
            if clear_cache:
                self._submit_io(shutil.rmtree, cache)
            return rembg_out, glb_out

    @contextlib.contextmanager
    def _mesh_job(self, kind: str, **fields):
        """Rank 0's side of one job of ``kind`` on a mesh: announced to the
        other ranks (``parallel/mesh.start_job``), and its end sent to
        them (``parallel/mesh.end_job``), with the failure where the body
        raises at a host-side point, so they leave the job where they
        wait (a failure inside a collective ends the process:
        ``parallel/mesh.collective_section``).  Nothing on one device or
        inside a job already (a stage of :meth:`_run`)."""
        if self.device_mesh is None or self._in_job:
            yield
            return
        start_job(kind, **fields)
        self._in_job = True
        try:
            yield
        except BaseException as e:
            end_job(e)
            raise
        finally:
            self._in_job = False
        end_job()

    def _follow_part(self, msg: dict) -> None:
        """A rank other than 0: its part of the job rank 0 announced as
        ``msg`` (the FLUX passes and the SR stage), then rank 0's end of
        it (``parallel/mesh.wait_job``).  Rank 0 may wait in any of the
        job's collectives, so a failure of this rank's own ends the
        process (``collective_section``); rank 0's ``JobAborted`` is
        raised."""
        kind = msg["kind"]
        with collective_section():
            if kind in ("job", "prewarm", "infer_mv"):
                if self._flux_loaded:
                    self._flux_passes(None, None, None)
                if msg.get("apply_sr", True):
                    self._follow_sr()
            elif kind == "sr":
                self._follow_sr()
            else:
                raise ValueError(f"unknown job message {msg}")
            wait_job()

    def _follow_one(self, kind: str) -> None:
        """A rank other than 0 that calls rank 0's entry point of ``kind``
        itself: its part of the next job, which must be of that kind."""
        msg = next_job()
        if msg["kind"] != kind:
            raise RuntimeError(f"rank {dist.get_rank()} called {kind!r} where "
                               f"rank 0 announced {msg}")
        self._follow_part(msg)

    def follow(self) -> int:
        """A rank other than 0 of a mesh: its part of each job rank 0 runs
        (a job, ``prewarm``, and outside a job ``infer_mv_stage`` or
        ``_apply_sr``), in step with it, until rank 0's
        :meth:`release_followers`; returns the number of jobs followed.
        A job that rank 0 ends as failed (``JobAborted``) is reported and
        the loop goes on, as rank 0's server or batch loop goes on to the
        next job."""
        if self._is_root:
            raise RuntimeError("follow() runs on the ranks other than 0 of a "
                               "mesh; rank 0 runs the jobs")
        n = 0
        while True:
            msg = next_job()
            if msg["kind"] == "stop":
                return n
            n += 1
            try:
                self._follow_part(msg)
            except JobAborted as e:
                print(f"[rank {dist.get_rank()}] {msg['kind']} ended on rank "
                      f"0: {e}", flush=True)

    def release_followers(self) -> None:
        """Rank 0 of a mesh: end the other ranks' :meth:`follow`; nothing
        on one device."""
        if self.device_mesh is not None and self._is_root:
            start_job("stop")

    @CPUTimer("export_video")
    def export_video_stage(self, save_dir: str, glb_path: str, name: str) -> str:
        """The orbit video of the written GLB (``config.orbit_*``) as
        ``<save_dir>/<name>`` with an ``.mp4`` suffix (``.gif`` without an
        mp4 writer); returns the path written."""
        return export_orbit_video(
            glb_path,
            os.path.join(save_dir, os.path.splitext(name)[0] + ".mp4"),
            n_frames=self.config.orbit_frames,
            size=self.config.orbit_size,
            fps=self.config.orbit_fps,
            device=self.device,
        )


class RGBTextureFullPipeline(RGBTextureFullPipelineBase):
    """The LTM-enabled pipeline: step_1_1, then the bake whose invisible
    texels the texture-function VAE (``models/ltm.py``) fills instead of
    the KNN (step_2_2); without ``ltm_params`` the plain bake."""

    def __init__(self, *args, ltm_params=None, ltm_cfg=None,
                 ltm_auto: Optional[float] = 0.93, **kwargs):
        """``ltm_params``: a tree, or the path of a trained checkpoint (such
        as the repo's ``ltm_params.npz``, whose meta holds its
        ``LTMConfig``), placed on the pipeline's device.  ``ltm_auto``: the
        per-asset fill policy: a chart at least this fraction visible takes
        the k=8 inverse-distance fill and 50 relaxation passes instead of
        the field; ``None`` always takes the field."""
        super().__init__(*args, **kwargs)
        self.ltm_auto = ltm_auto
        if isinstance(ltm_params, str):
            from .models.ltm import LTMConfig

            meta = load_meta(ltm_params) or {}
            if ltm_cfg is None:
                ltm_cfg = LTMConfig(**meta.get("config", {}))
            ltm_params = load_params(ltm_params)
        if ltm_params is not None:
            ltm_params = tree_to(ltm_params, self.device)
        self.ltm_params = ltm_params
        self.ltm_cfg = ltm_cfg

    @CPUTimer("reproject_and_query_field")
    def reproject_with_field(
        self, save_dir: str, mesh: Mesh, mv_rgb_grid: torch.Tensor,
        condition: Dict[str, torch.Tensor], processed_mesh: HostMesh,
    ) -> str:
        """step_2_2: the bake with the LTM ``query_field`` as the fill of the
        invisible texels, the gradient filter on, and the k=8 + relaxation
        fill for charts at least ``ltm_auto`` visible."""
        from .models.ltm import make_query_field

        if self.ltm_params is None:
            raise ValueError("step_2_2 needs LTM weights (ltm_params)")
        out = self._bake(
            mesh, self._views(mv_rgb_grid), condition,
            filt_gradient_points=True,
            query_field=make_query_field(self.ltm_params, self.ltm_cfg),
            query_field_auto=self.ltm_auto,
            fill_k=8, fill_relax_iters=50,
        )
        # the fill the bake took and the chart's visible fraction, for
        # callers that report them
        mask_2d = out["mask_2d"]
        self.last_fill = {"branch": out["fill"], "visible_fraction": float(
            (out["mask_visible_any"] & mask_2d).sum()) / max(1, int(mask_2d.sum()))}
        return self._write_textured(save_dir, out["texture"], processed_mesh,
                                    save_uv=True)

    def __call__(
        self,
        save_dir: str,
        image_path: str,
        mesh_path: str,
        clear_cache: bool = False,
        preprocessed=None,
    ) -> Tuple[str, str]:
        stage = (self.reproject_with_field if self.ltm_params is not None
                 else self.reproject_stage)
        return self._run(save_dir, image_path, mesh_path, stage, clear_cache,
                         preprocessed=preprocessed)


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
        return self._run(save_dir, image_path, mesh_path, self.reproject_stage,
                         clear_cache, export_video, preprocessed)
