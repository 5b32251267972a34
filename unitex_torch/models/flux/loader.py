"""Checkpoint loading: diffusers safetensors -> the port's parameter trees
(port of unitex_tpu/models/flux/loader.py).

The trees are the ones the port's init makes: the same leaf names, linear
kernels [d_in, d_out] (torch stores [d_out, d_in]), conv kernels HWIO
(torch: OIHW), transformer blocks stacked [L, ...].

Unlike the JAX package, which reads a whole state dict into host memory
and then makes transposed copies of it, the port streams: the shards stay
memory-mapped (:class:`SafetensorsDict`), each leaf is allocated once on
the target device in its final dtype, and each source tensor is read,
moved to the device and copied into its slot (the transpose and the cast
happen in that one device copy).  Host memory stays near one tensor.
"""

from __future__ import annotations

import contextlib
import glob
import os
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional

import torch

from ...utils.precision import resolve_device
from .config import FluxConfig
from .vae import VAEConfig


class SafetensorsDict(Mapping):
    """The tensors of a ``.safetensors`` file, or of the shards of a
    diffusers model directory, by name; a tensor is read from its shard
    (as a CPU tensor) when it is looked up.  Use as a context manager to
    close the shards."""

    def __init__(self, path: str):
        from safetensors import safe_open

        files = (sorted(glob.glob(os.path.join(path, "*.safetensors")))
                 if os.path.isdir(path) else [path])
        if not files:
            raise FileNotFoundError(f"no .safetensors files in {path}")
        self._stack = contextlib.ExitStack()
        self._where = {}
        for f in files:
            handle = self._stack.enter_context(safe_open(f, framework="pt"))
            self._where.update(dict.fromkeys(handle.keys(), handle))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name].get_tensor(name)

    def __contains__(self, name) -> bool:
        # Mapping's default would read the tensor
        return name in self._where

    def shape(self, name: str) -> tuple:
        """A tensor's shape, read from its shard's header."""
        return tuple(self._where[name].get_slice(name).get_shape())

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def close(self) -> None:
        self._stack.close()

    def __enter__(self) -> "SafetensorsDict":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def iter_safetensors(path: str) -> SafetensorsDict:
    """The tensors of a .safetensors file or a diffusers model directory
    (its ``*.safetensors`` shards), read lazily."""
    return SafetensorsDict(path)


# A name tree mirrors the parameter tree; each leaf is (source name, kind)
# with kind "t" (a linear weight, transposed), "conv" (OIHW -> HWIO) or
# "vec" (as stored).  In a stacked block tree the name holds "{i}".

def _lin(sd, prefix, probe=None):
    """A linear's names; the bias only where the state dict has one
    (looked up as ``probe``, the name of layer 0, for stacked blocks)."""
    p = {"kernel": (f"{prefix}.weight", "t")}
    if f"{probe or prefix}.bias" in sd:
        p["bias"] = (f"{prefix}.bias", "vec")
    return p


def _view(x, kind: str) -> torch.Tensor:
    t = torch.as_tensor(x)
    if kind == "t":
        return t.t()
    if kind == "conv":
        return t.permute(2, 3, 1, 0)
    return t


def _materialize(names, sd, device, dtype, n_layers: Optional[int] = None):
    """The parameter tree of a name tree.  Each leaf is allocated once on
    ``device`` (in ``dtype``, or the source's) and filled layer by layer:
    the source tensor goes to the device as stored, and one copy there
    transposes and casts it into its slot."""
    if isinstance(names, dict):
        return {k: _materialize(v, sd, device, dtype, n_layers)
                for k, v in names.items()}
    if isinstance(names, list):
        return [_materialize(v, sd, device, dtype, n_layers) for v in names]
    name, kind = names
    layers = [None] if n_layers is None else range(n_layers)
    out = None
    for i in layers:
        src = _view(sd[name if i is None else name.format(i=i)], kind)
        if out is None:
            shape = src.shape if i is None else (n_layers, *src.shape)
            out = torch.empty(shape, dtype=dtype or src.dtype, device=device)
        (out if i is None else out[i]).copy_(src.to(device))
    return out


# ------------------------------------------------------------ transformer


def _flux_names(sd: Mapping, cfg: FluxConfig):
    """(top-level names, dual-block names, single-block names)."""

    def embedder(prefix):
        return {"in": _lin(sd, f"{prefix}.linear_1"),
                "out": _lin(sd, f"{prefix}.linear_2")}

    top: Dict[str, Any] = {
        "x_embedder": _lin(sd, "x_embedder"),
        "context_embedder": _lin(sd, "context_embedder"),
        "time_embed": embedder("time_text_embed.timestep_embedder"),
        "pooled_embed": embedder("time_text_embed.text_embedder"),
        "norm_out": {"lin": _lin(sd, "norm_out.linear")},
        "proj_out": _lin(sd, "proj_out"),
    }
    if cfg.guidance_embeds:
        top["guidance_embed"] = embedder("time_text_embed.guidance_embedder")

    def block_lin(kind, name):
        return _lin(sd, f"{kind}.{{i}}.{name}", probe=f"{kind}.0.{name}")

    def vec(kind, name):
        return (f"{kind}.{{i}}.{name}.weight", "vec")

    d, s = "transformer_blocks", "single_transformer_blocks"
    dual = {
        "norm1": {"lin": block_lin(d, "norm1.linear")},
        "norm1_context": {"lin": block_lin(d, "norm1_context.linear")},
        "attn": {
            "to_q": block_lin(d, "attn.to_q"),
            "to_k": block_lin(d, "attn.to_k"),
            "to_v": block_lin(d, "attn.to_v"),
            "norm_q": vec(d, "attn.norm_q"),
            "norm_k": vec(d, "attn.norm_k"),
            "add_q_proj": block_lin(d, "attn.add_q_proj"),
            "add_k_proj": block_lin(d, "attn.add_k_proj"),
            "add_v_proj": block_lin(d, "attn.add_v_proj"),
            "norm_added_q": vec(d, "attn.norm_added_q"),
            "norm_added_k": vec(d, "attn.norm_added_k"),
            "to_out": block_lin(d, "attn.to_out.0"),
            "to_add_out": block_lin(d, "attn.to_add_out"),
        },
        "ff": {"in": block_lin(d, "ff.net.0.proj"),
               "out": block_lin(d, "ff.net.2")},
        "ff_context": {"in": block_lin(d, "ff_context.net.0.proj"),
                       "out": block_lin(d, "ff_context.net.2")},
    }
    single = {
        "norm": {"lin": block_lin(s, "norm.linear")},
        "attn": {
            "to_q": block_lin(s, "attn.to_q"),
            "to_k": block_lin(s, "attn.to_k"),
            "to_v": block_lin(s, "attn.to_v"),
            "norm_q": vec(s, "attn.norm_q"),
            "norm_k": vec(s, "attn.norm_k"),
        },
        "proj_mlp": block_lin(s, "proj_mlp"),
        "proj_out": block_lin(s, "proj_out"),
    }
    return top, dual, single


def flux_params_from_state_dict(
    sd: Mapping, cfg: FluxConfig, device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, Any]:
    """Map a diffusers ``FluxTransformer2DModel`` state dict (tensors or
    numpy arrays by name) into the ``init_flux_params`` tree on
    ``device``, cast to ``dtype`` (default: as stored)."""
    dev = resolve_device(device)
    top, dual, single = _flux_names(sd, cfg)
    params = _materialize(top, sd, dev, dtype)
    params["dual_blocks"] = _materialize(dual, sd, dev, dtype, cfg.num_layers)
    params["single_blocks"] = _materialize(single, sd, dev, dtype,
                                           cfg.num_single_layers)
    return params


def load_flux_transformer(
    path: str, cfg: FluxConfig, device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, Any]:
    """The transformer tree of a diffusers model directory (or one
    ``.safetensors`` file), streamed onto ``device``."""
    with iter_safetensors(path) as sd:
        return flux_params_from_state_dict(sd, cfg, device, dtype)


# ------------------------------------------------------------------- VAE


def _vae_names(sd: Mapping, cfg: VAEConfig):
    def cv(prefix):
        return {"kernel": (f"{prefix}.weight", "conv"),
                "bias": (f"{prefix}.bias", "vec")}

    def gn(prefix):
        return {"scale": (f"{prefix}.weight", "vec"),
                "bias": (f"{prefix}.bias", "vec")}

    def lin(prefix):
        return {"kernel": (f"{prefix}.weight", "t"),
                "bias": (f"{prefix}.bias", "vec")}

    def resnet(prefix):
        p = {"norm1": gn(f"{prefix}.norm1"), "conv1": cv(f"{prefix}.conv1"),
             "norm2": gn(f"{prefix}.norm2"), "conv2": cv(f"{prefix}.conv2")}
        if f"{prefix}.conv_shortcut.weight" in sd:
            p["shortcut"] = cv(f"{prefix}.conv_shortcut")
        return p

    def attn(prefix):
        return {"norm": gn(f"{prefix}.group_norm"), "q": lin(f"{prefix}.to_q"),
                "k": lin(f"{prefix}.to_k"), "v": lin(f"{prefix}.to_v"),
                "o": lin(f"{prefix}.to_out.0")}

    def mid(part):
        return {"res1": resnet(f"{part}.mid_block.resnets.0"),
                "attn": attn(f"{part}.mid_block.attentions.0"),
                "res2": resnet(f"{part}.mid_block.resnets.1")}

    n_levels = len(cfg.block_out_channels)
    down = []
    for i in range(n_levels):
        level = {"resnets": [resnet(f"encoder.down_blocks.{i}.resnets.{j}")
                             for j in range(cfg.layers_per_block)]}
        conv = f"encoder.down_blocks.{i}.downsamplers.0.conv"
        if f"{conv}.weight" in sd:
            level["downsample"] = cv(conv)
        down.append(level)
    up = []
    for i in range(n_levels):
        level = {"resnets": [resnet(f"decoder.up_blocks.{i}.resnets.{j}")
                             for j in range(cfg.layers_per_block + 1)]}
        conv = f"decoder.up_blocks.{i}.upsamplers.0.conv"
        if f"{conv}.weight" in sd:
            level["upsample"] = cv(conv)
        up.append(level)
    return {
        "encoder": {"conv_in": cv("encoder.conv_in"), "down": down,
                    "mid": mid("encoder"), "norm_out": gn("encoder.conv_norm_out"),
                    "conv_out": cv("encoder.conv_out")},
        "decoder": {"conv_in": cv("decoder.conv_in"), "mid": mid("decoder"),
                    "up": up, "norm_out": gn("decoder.conv_norm_out"),
                    "conv_out": cv("decoder.conv_out")},
    }


def vae_params_from_state_dict(
    sd: Mapping, cfg: VAEConfig, device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, Any]:
    """Map a diffusers ``AutoencoderKL`` state dict into the
    ``init_vae_params`` tree on ``device``, cast to ``dtype`` (default: as
    stored)."""
    return _materialize(_vae_names(sd, cfg), sd, resolve_device(device), dtype)


def load_vae(
    path: str, cfg: VAEConfig, device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, Any]:
    with iter_safetensors(path) as sd:
        return vae_params_from_state_dict(sd, cfg, device, dtype)
