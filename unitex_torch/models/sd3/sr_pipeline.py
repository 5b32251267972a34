"""TSD-SR: one-step SD3 x4 super-resolution with tiled latents and a tiled
VAE (port of unitex_tpu/models/sd3/sr_pipeline.py).

bicubic x4 upscale -> VAE encode (512² pixel tiles, gaussian-blended) ->
ONE SD3 transformer step at t = 1000 over gaussian-weighted 64² latent
tiles (overlap 8, 8 tiles a call) -> latent = input - velocity -> tiled
VAE decode (128² latent tiles, bf16, 8 a call) -> wavelet or AdaIN colour
fix against the bicubic upscale.  The prompt is a fixed embedding read
from ``<root>/tsdsr/prompt_embeds.npz``, or zeros (154 tokens).

Timers (``utils/timer.CPUTimer``, each ending in a device synchronize):
``sr_upscale``, ``sr_encode``, ``sr_transformer``, ``sr_decode``,
``sr_color_fix``, and ``sr_stage_weights`` for a ``host_params`` window.  Tile sums are assembled in the JAX package's order
(tile by tile, in ``_tile_offsets`` order), so the blends match it to
rounding.

With a ``mesh`` (``parallel/mesh.py``) the stage runs on every rank in
step: the SD3 transformer tensor-parallel over ``model``
(``parallel/sharding.shard_sd3_params``), and the latent-tile and VAE-tile
batches split over ``data`` (padded with repeats to a multiple of the
axis, gathered and cut back: ``sharding.data_parallel``), so every rank
ends with the whole image before the colour fix.  With
``int8_serving`` the transformer is quantized whole, node by node, before
it is cut (as the JAX package quantizes, then shards).  ``host_params``
(and with it ``stage_pack_int4``) is refused on a mesh: the JAX staging
puts the whole tree on one device, which would undo the cut.  Not ported: the JAX
package's retry of a failed device put; on the card an out-of-memory
raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...ops.quant import pack_int4_tree, quantize_linears, unpack_int4_tree
from ...parallel.mesh import Mesh, broadcast_tensors, collective_section
from ...parallel.sharding import data_parallel, shard_sd3_params
from ...utils.params import tree_to
from ...utils.precision import resolve_device
from ...utils.resize import resize_bicubic
from ...utils.timer import CPUTimer
from ..flux.loader import load_vae
from ..flux.model import tp_config
from ..flux.vae import VAEConfig, vae_decode, vae_encode
from .color_fix import adain_color_fix, wavelet_color_fix
from .config import SD3Config
from .loader import load_sd3_transformer
from .model import sd3_forward

_PROMPT_TOKENS = 154  # the zero prompt's length when no embeds are given


def upscale_clip(image: torch.Tensor, upscale: int) -> torch.Tensor:
    """[H, W, C] -> the bicubic x``upscale`` image clipped to [0, 1]."""
    H, W, _ = image.shape
    return torch.clamp(resize_bicubic(image, H * upscale, W * upscale),
                       0.0, 1.0)


def _sr_finish(decoded: torch.Tensor, up: torch.Tensor,
               align: str) -> torch.Tensor:
    out = torch.clamp(decoded[0] * 0.5 + 0.5, 0.0, 1.0)
    if align == "wavelet":
        out = wavelet_color_fix(out, up)
    elif align == "adain":
        out = adain_color_fix(out, up)
    return torch.clamp(out, 0.0, 1.0)


def gaussian_tile_weights(tile: int, var: float = 0.01,
                          device="cpu") -> torch.Tensor:
    """[tile, tile] f32 gaussian blend mask, floored at 1e-6 of its
    maximum (the division by the weight sum keeps precision at tile
    borders)."""
    mid = (tile - 1) / 2.0
    x = np.arange(tile, dtype=np.float64)
    g = np.exp(-((x - mid) ** 2) / (tile * tile) / (2 * var)) \
        / np.sqrt(2 * np.pi * var)
    w = np.outer(g, g)
    w = np.maximum(w, w.max() * 1e-6)
    return torch.from_numpy(w.astype(np.float32)).to(device)


def _tile_offsets(size: int, tile: int, overlap: int):
    """Start offsets covering [0, size): stride (tile - overlap), the last
    tile clamped to the end."""
    if size <= tile:
        return [0]
    stride = tile - overlap
    offs = list(range(0, size - tile, stride))
    offs.append(size - tile)
    return offs


def _offsets_2d(H: int, W: int, tile: int, overlap: int):
    return [(oy, ox) for oy in _tile_offsets(H, tile, overlap)
            for ox in _tile_offsets(W, tile, overlap)]


def _blend(t_out: torch.Tensor, offs, H: int, W: int,
           w: torch.Tensor) -> torch.Tensor:
    """Σ tile · w over the tiles at ``offs`` (in that order), divided by
    Σ w: t_out [N, t, t, C] f32, w [t, t] -> [1, H, W, C]."""
    t = w.shape[0]
    w = w[None, :, :, None]
    out = torch.zeros((1, H, W, t_out.shape[-1]), dtype=torch.float32,
                      device=t_out.device)
    cnt = torch.zeros((1, H, W, 1), dtype=torch.float32, device=t_out.device)
    for n, (oy, ox) in enumerate(offs):
        out[:, oy:oy + t, ox:ox + t] += t_out[n:n + 1] * w
        cnt[:, oy:oy + t, ox:ox + t] += w
    return out / torch.clamp(cnt, min=1e-8)


def tiled_apply(fn, x: torch.Tensor, tile: int, overlap: int,
                out_scale: int = 1, out_channels: Optional[int] = None):
    """Apply ``fn`` ([1, t, t, C] -> [1, t·s, t·s, C']) over overlapping
    tiles of x [1, H, W, C], gaussian-blending the results."""
    _, H, W, C = x.shape
    if H <= tile and W <= tile:
        return fn(x)
    Co = out_channels if out_channels is not None else C
    s = out_scale
    out = torch.zeros((1, H * s, W * s, Co), dtype=torch.float32,
                      device=x.device)
    cnt = torch.zeros((1, H * s, W * s, 1), dtype=torch.float32,
                      device=x.device)
    w = gaussian_tile_weights(tile * s, device=x.device)[None, :, :, None]
    for oy in _tile_offsets(H, tile, overlap):
        for ox in _tile_offsets(W, tile, overlap):
            t_out = fn(x[:, oy:oy + min(tile, H), ox:ox + min(tile, W)]).float()
            th, tw = t_out.shape[1:3]
            out[:, oy * s:oy * s + th, ox * s:ox * s + tw] += t_out * w
            cnt[:, oy * s:oy * s + th, ox * s:ox * s + tw] += w
    return out / torch.clamp(cnt, min=1e-8)


def tiled_apply_batched(fn, x: torch.Tensor, tile: int, overlap: int,
                        tile_batch: int = 8,
                        out_channels: Optional[int] = None):
    """Like :func:`tiled_apply`, with the tiles stacked and ``fn`` called
    on [tile_batch, t, t, C] chunks (the last may be smaller)."""
    _, H, W, C = x.shape
    if H <= tile and W <= tile:
        return fn(x)
    offs = _offsets_2d(H, W, tile, overlap)
    tiles = torch.cat([x[:, oy:oy + tile, ox:ox + tile] for oy, ox in offs])
    t_out = torch.cat([fn(tiles[i:i + tile_batch])
                       for i in range(0, len(offs), tile_batch)]).float()
    return _blend(t_out, offs, H, W, gaussian_tile_weights(tile, device=x.device))


@dataclasses.dataclass
class TSDSRConfig:
    upscale: int = 4
    process_size: int = 512
    latent_tile: int = 64
    latent_overlap: int = 8
    vae_encoder_tile: int = 512
    vae_decoder_tile: int = 128
    timestep: float = 1000.0
    align_method: str = "wavelet"      # wavelet | adain | nofix
    tile_batch: int = 8                # latent tiles per transformer call
    vae_encode_batch: int = 8          # pixel tiles per VAE-encode call
    # latent tiles per VAE-decode call; 0 picks the largest of (8, 4, 2,
    # 1) whose estimated activations fit the card's free memory
    vae_decode_batch: int = 8
    vae_decode_dtype: str = "bfloat16"  # "float32" for full precision
    # W8A8 int8 for the transformer blocks (ops/quant.quantize_linears; q/k
    # and the AdaLN modulations stay bf16)
    int8_serving: bool = False
    # keep the SD3 and VAE trees in host memory and move them to the
    # device for each call (or each ``staged()`` window)
    host_params: bool = False
    # move the transformer int4-packed (ops/quant.pack_int4_tree, lossy,
    # opt-in) and unpack it on the device; ``stage_pack_bf16`` packs the
    # bf16 linears too (as weight-only int4)
    stage_pack_int4: bool = False
    stage_pack_bf16: bool = True


class TSDSRPipeline:
    """Callable: [H, W, 3] float image in [0, 1] -> the x4 image, a f32
    tensor on ``device``.

    ``pretrain_root`` names a root with ``sd3/transformer`` and ``sd3/vae``
    (diffusers safetensors, read straight onto the device: the transformer
    in the config's dtype, the VAE in f32) and optionally
    ``tsdsr/prompt_embeds.npz``; or the trees are given.  Without weights
    the output is the bicubic upscale.

    ``mesh``: run across its ranks, each calling with the same arguments
    (the image is rank 0's; the others may pass ``None``); the transformer
    tree, loaded or given whole, is cut to this rank's slices and
    ``device`` is ``mesh.device``."""

    def __init__(
        self,
        pretrain_root: Optional[str] = None,
        cfg: TSDSRConfig = TSDSRConfig(),
        sd3_cfg: SD3Config = SD3Config.sd3_medium(),
        transformer_params: Optional[Dict[str, Any]] = None,
        vae_params: Optional[Dict[str, Any]] = None,
        prompt_embeds=None,
        pooled_embeds=None,
        mesh: Optional[Any] = None,
        device="cuda",
    ):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if mesh is not None and (cfg.host_params or cfg.stage_pack_int4):
            raise NotImplementedError(
                "host_params / stage_pack_int4 on a mesh: the staging window "
                "moves the whole tree to one device (the JAX package's "
                "jax.devices()[0]), which undoes the tensor-parallel cut; "
                "keep the SR stage's slices resident on each rank")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.cfg = cfg
        self.sd3_cfg = sd3_cfg
        self.vae_cfg = VAEConfig.sd3()
        self.transformer_params = transformer_params
        self.vae_params = vae_params
        self.prompt_embeds = prompt_embeds
        self.pooled_embeds = pooled_embeds
        self._staged = False
        self._packed = None  # (the host tree it was packed from, packed)
        self._auto_batch = None
        if pretrain_root is not None and transformer_params is None:
            # quantized and cut node by node as it is read
            self._try_load(pretrain_root)
        elif transformer_params is not None:
            # the whole tree quantized, then cut
            if cfg.int8_serving:
                transformer_params = quantize_linears(transformer_params)
            if mesh is not None:
                transformer_params = shard_sd3_params(transformer_params, mesh)
            self.transformer_params = transformer_params
        if cfg.host_params:
            # quantized where it was loaded (the device), kept on the host
            if self.transformer_params is not None:
                self.transformer_params = tree_to(self.transformer_params, "cpu")
            if self.vae_params is not None:
                self.vae_params = tree_to(self.vae_params, "cpu")

    def _try_load(self, root: str) -> None:
        dtype = torch.bfloat16 if self.sd3_cfg.dtype == "bfloat16" \
            else torch.float32
        try:
            transformer = load_sd3_transformer(
                os.path.join(root, "sd3", "transformer"), self.sd3_cfg,
                device=self.device, dtype=dtype, mesh=self.mesh,
                int8_serving=self.cfg.int8_serving)
            vae = load_vae(os.path.join(root, "sd3", "vae"), self.vae_cfg,
                           device=self.device, dtype=torch.float32)
        except OSError as e:  # FileNotFoundError among them
            print(f"[tsdsr] SD3 weights not found ({e}); bicubic fallback")
            return
        self.transformer_params, self.vae_params = transformer, vae
        emb = os.path.join(root, "tsdsr", "prompt_embeds.npz")
        if os.path.exists(emb):
            z = np.load(emb)
            self.prompt_embeds = torch.from_numpy(z["prompt_embeds"])
            self.pooled_embeds = torch.from_numpy(z["pooled_embeds"])

    # ------------------------------------------------------------- staging

    def _pack_host_tree(self, host_t):
        """``pack_int4_tree`` of the host transformer tree, each linear
        packed on the device and brought back; kept for later windows as
        long as the host tree is the same object."""
        if self._packed is not None and self._packed[0] is host_t:
            return self._packed[1]
        bf16 = self.cfg.stage_pack_bf16

        def walk(node):
            if not isinstance(node, dict):
                return node
            if any(k in node for k in ("kernel", "kernel_int8",
                                       "kernel_int8_wo")):
                return tree_to(pack_int4_tree(tree_to(node, self.device),
                                              pack_bf16_wo=bf16), "cpu")
            return {k: walk(v) for k, v in node.items()}

        self._packed = (host_t, walk(host_t))
        return self._packed[1]

    @contextlib.contextmanager
    def staged(self):
        """``host_params``' staging window: the weight trees go to the
        device once (the transformer int4-packed and unpacked there under
        ``stage_pack_int4``), any number of calls run inside, and the host
        trees are restored on exit, so the device copies free once the
        caller drops its outputs' other references."""
        if (not self.cfg.host_params or self._staged
                or self.transformer_params is None or self.vae_params is None):
            yield
            return
        host_t, host_v = self.transformer_params, self.vae_params
        with CPUTimer("sr_stage_weights"):
            if self.cfg.stage_pack_int4:
                packed = self._pack_host_tree(host_t)
                dev_t = tree_to(unpack_int4_tree(packed, device=self.device),
                                self.device)
            else:
                dev_t = tree_to(host_t, self.device)
            self.transformer_params = dev_t
            self.vae_params = tree_to(host_v, self.device)
        self._staged = True
        try:
            yield
        finally:
            self._staged = False
            self.transformer_params, self.vae_params = host_t, host_v

    def __call__(self, image) -> torch.Tensor:
        with self.staged():
            return self._infer(image)

    # ----------------------------------------------------------------- ops

    @torch.no_grad()
    def _infer(self, image) -> torch.Tensor:
        """On a mesh, rank 0's image on every rank (the other ranks pass
        None), then the stage's collectives in a ``collective_section``."""
        mesh = self.mesh
        if mesh is None:
            return self._infer_on(image)
        image = broadcast_tensors(
            {"image": torch.as_tensor(image, dtype=torch.float32)}
            if mesh.is_root else None, mesh)["image"]
        with collective_section():
            return self._infer_on(image)

    def _infer_on(self, image) -> torch.Tensor:
        cfg = self.cfg
        mesh = self.mesh
        image = torch.as_tensor(image, dtype=torch.float32).to(self.device)
        with CPUTimer("sr_upscale"):
            up = upscale_clip(image, cfg.upscale)
        if self.transformer_params is None or self.vae_params is None:
            return up

        x = up[None] * 2.0 - 1.0
        with CPUTimer("sr_encode"):
            if max(x.shape[1:3]) > cfg.vae_encoder_tile:
                lq_latent = self._tiled_encode(x)
            else:
                lq_latent = vae_encode(self.vae_params, self.vae_cfg, x)

        prompt = self.prompt_embeds
        if prompt is None:
            prompt = torch.zeros((1, _PROMPT_TOKENS,
                                  self.sd3_cfg.joint_attention_dim))
        prompt = torch.as_tensor(prompt).to(self.device)
        if prompt.dim() == 2:
            prompt = prompt[None]
        pooled = self.pooled_embeds
        if pooled is None:
            pooled = torch.zeros((1, self.sd3_cfg.pooled_projection_dim))
        pooled = torch.as_tensor(pooled).to(self.device)
        if pooled.dim() == 1:
            pooled = pooled[None]

        sd3_cfg = self.sd3_cfg
        if mesh is not None:
            sd3_cfg = tp_config(sd3_cfg, mesh.group("model"))

        def forward(lat_tiles):
            nb = lat_tiles.shape[0]
            t = torch.full((nb,), cfg.timestep, dtype=torch.float32,
                           device=self.device)
            return sd3_forward(
                self.transformer_params, sd3_cfg, lat_tiles,
                prompt.expand(nb, *prompt.shape[1:]), t,
                pooled.expand(nb, *pooled.shape[1:]))

        def step(lat_tiles):
            if mesh is None:
                return forward(lat_tiles)
            return data_parallel(forward, lat_tiles, mesh)

        with CPUTimer("sr_transformer"):
            pred = tiled_apply_batched(
                step, lq_latent, cfg.latent_tile, cfg.latent_overlap,
                tile_batch=cfg.tile_batch,
                out_channels=self.vae_cfg.latent_channels)
            latent_stu = lq_latent - pred
        with CPUTimer("sr_decode"):
            out = self._tiled_decode(latent_stu)
        with CPUTimer("sr_color_fix"):
            return _sr_finish(out, up, cfg.align_method)

    def _run_tile_batches(self, fn, tiles: torch.Tensor, bs: int) -> torch.Tensor:
        """``fn`` over [N, t, t, C] stacked tiles in chunks of ``bs``, each
        chunk split over ``data`` on a mesh."""
        def run(chunk):
            if self.mesh is None:
                return fn(chunk)
            return data_parallel(fn, chunk, self.mesh)

        return torch.cat([run(tiles[i:i + bs])
                          for i in range(0, tiles.shape[0], bs)])

    def _tiled_encode(self, x: torch.Tensor) -> torch.Tensor:
        ds = self.vae_cfg.downscale
        tile = self.cfg.vae_encoder_tile
        _, H, W, _ = x.shape
        offs = _offsets_2d(H, W, tile, tile // 4)
        tiles = torch.cat([x[:, oy:oy + tile, ox:ox + tile] for oy, ox in offs])
        t_out = self._run_tile_batches(
            lambda b: vae_encode(self.vae_params, self.vae_cfg, b),
            tiles, self.cfg.vae_encode_batch).float()
        lt = tile // ds
        return _blend(t_out, [(oy // ds, ox // ds) for oy, ox in offs],
                      H // ds, W // ds,
                      gaussian_tile_weights(lt, device=x.device))

    def _auto_decode_batch(self) -> int:
        """``vae_decode_batch == 0``: the largest of (8, 4, 2, 1) whose
        estimated activations (1.6 GB a bf16 128² latent tile, scaled by
        the tile's area, twice that in f32) fit 80 % of the card's free
        memory, resolved once; 2 on the CPU, which reports no free
        memory."""
        if self._auto_batch is not None:
            return self._auto_batch
        per_tile = 1.6e9 * (self.cfg.vae_decoder_tile / 128.0) ** 2
        if self.cfg.vae_decode_dtype != "bfloat16":
            per_tile *= 2.0
        batch = 2
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            batch = next((b for b in (8, 4, 2) if b * per_tile <= 0.8 * free), 1)
        self._auto_batch = batch
        return batch

    def _tiled_decode(self, lat: torch.Tensor) -> torch.Tensor:
        ds = self.vae_cfg.downscale
        tile = self.cfg.vae_decoder_tile
        _, h, w, C = lat.shape
        dtype = torch.bfloat16 if self.cfg.vae_decode_dtype == "bfloat16" \
            else torch.float32
        lat = lat.to(dtype)
        if h <= tile and w <= tile:
            return vae_decode(self.vae_params, self.vae_cfg, lat).float()
        offs = _offsets_2d(h, w, tile, tile // 4)
        tiles = torch.cat([lat[:, oy:oy + tile, ox:ox + tile] for oy, ox in offs])
        batch = self.cfg.vae_decode_batch or self._auto_decode_batch()
        t_out = self._run_tile_batches(
            lambda b: vae_decode(self.vae_params, self.vae_cfg, b),
            tiles, batch).float()
        return _blend(t_out, [(oy * ds, ox * ds) for oy, ox in offs],
                      h * ds, w * ds,
                      gaussian_tile_weights(tile * ds, device=lat.device))
