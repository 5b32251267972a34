"""LPIPS on VGG16 and AlexNet feature stacks (port of the LPIPS part of
unitex_tpu/utils/lpips.py), the perceptual half of TSD-SR's data loss
(``training/tsdsr.make_lpips_perceptual_fn``).

``lpips``: each stage's ReLU features unit-normalized over channels,
squared difference, a learned non-negative per-channel weight, spatial
mean, summed over stages (Zhang et al. 2018).  The backbone follows the
JAX package's (2x2 max-pools, VALID, before the listed stages), not
torchvision's AlexNet pools.

Parameters keep the JAX package's tree: ``{"net": [[{"kernel" HWIO,
"bias"}, ...] per stage], "lins": [per-stage weights], "pnet": "vgg" |
"alex"}``; activations are NHWC at the public functions.  Convolutions
run in f32 without TF32.  ``load_torch_lpips`` converts a torchvision
backbone state dict and the LPIPS package's linear heads.  DISTS is not
ported.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import exact_f32, resolve_device

VGG16_STAGES: Tuple[int, ...] = (64, 128, 256, 512, 512)
ALEX_STAGES: Tuple[int, ...] = (64, 192, 384, 256, 256)

# per-stage conv layers: (in_ch, out_ch, ksize, stride, pad)
_VGG16_CFG = (
    ((3, 64, 3, 1, 1), (64, 64, 3, 1, 1)),
    ((64, 128, 3, 1, 1), (128, 128, 3, 1, 1)),
    ((128, 256, 3, 1, 1), (256, 256, 3, 1, 1), (256, 256, 3, 1, 1)),
    ((256, 512, 3, 1, 1), (512, 512, 3, 1, 1), (512, 512, 3, 1, 1)),
    ((512, 512, 3, 1, 1), (512, 512, 3, 1, 1), (512, 512, 3, 1, 1)),
)
_ALEX_CFG = (
    ((3, 64, 11, 4, 2),),
    ((64, 192, 5, 1, 2),),
    ((192, 384, 3, 1, 1),),
    ((384, 256, 3, 1, 1),),
    ((256, 256, 3, 1, 1),),
)
# a max-pool before each stage (none before stage 0)
_VGG16_POOL = (False, True, True, True, True)
_ALEX_POOL = (False, True, True, False, False)

# LPIPS ScalingLayer constants (on [-1, 1] input)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def _cfg(net: str):
    if net == "vgg":
        return _VGG16_CFG, _VGG16_POOL, VGG16_STAGES
    if net == "alex":
        return _ALEX_CFG, _ALEX_POOL, ALEX_STAGES
    raise ValueError(f"unknown backbone {net!r} (vgg | alex)")


@torch.no_grad()
def init_backbone_params(generator: torch.Generator, net: str = "vgg",
                         device="cuda") -> Dict[str, Any]:
    """He-normal random conv stack, f32 (another PRNG than the JAX
    package's: the same shapes and distributions)."""
    dev = resolve_device(device)
    cfg, _, _ = _cfg(net)
    params: Dict[str, Any] = {"net": []}
    for stage in cfg:
        layers = []
        for cin, cout, k, _, _ in stage:
            w = torch.empty((k, k, cin, cout), device=dev)
            w.normal_(0.0, math.sqrt(2.0 / (k * k * cin)), generator=generator)
            layers.append({"kernel": w, "bias": torch.zeros((cout,), device=dev)})
        params["net"].append(layers)
    return params


@torch.no_grad()
def init_lpips_params(generator: torch.Generator, net: str = "vgg",
                      device="cuda") -> Dict[str, Any]:
    """A random backbone and non-negative per-channel heads |N(0, 1)| / C."""
    dev = resolve_device(device)
    params = init_backbone_params(generator, net, dev)
    lins = []
    for c in _cfg(net)[2]:
        w = torch.empty((c,), device=dev).normal_(generator=generator)
        lins.append(w.abs() / c)
    params["lins"] = lins
    params["pnet"] = net
    return params


def _conv(x: torch.Tensor, p: Dict[str, torch.Tensor], stride: int,
          pad: int) -> torch.Tensor:
    w = p["kernel"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    return F.conv2d(x, w, p["bias"], stride=stride, padding=pad)


@exact_f32()
def backbone_features(params: Dict[str, Any], x: torch.Tensor,
                      net: str = "vgg") -> List[torch.Tensor]:
    """Per-stage ReLU feature maps [N, h, w, C] of a normalized NHWC
    batch."""
    cfg, pools, _ = _cfg(net)
    x = x.permute(0, 3, 1, 2)
    feats = []
    for si, stage in enumerate(cfg):
        if pools[si]:
            x = F.max_pool2d(x, 2, 2)
        for li, (_, _, _, stride, pad) in enumerate(stage):
            x = F.relu(_conv(x, params["net"][si][li], stride, pad))
        feats.append(x.permute(0, 2, 3, 1))
    return feats


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(f * f, dim=-1, keepdim=True)) + eps)


def lpips(params: Dict[str, Any], a: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """LPIPS distance per batch element [N]; a, b: [N, H, W, 3] in
    [-1, 1]."""
    net = params.get("pnet", "vgg")
    shift = torch.tensor(_LPIPS_SHIFT, dtype=torch.float32, device=a.device)
    scale = torch.tensor(_LPIPS_SCALE, dtype=torch.float32, device=a.device)
    fa = backbone_features(params, (a - shift) / scale, net)
    fb = backbone_features(params, (b - shift) / scale, net)
    total = torch.zeros((a.shape[0],), dtype=torch.float32, device=a.device)
    for f1, f2, w in zip(fa, fb, params["lins"]):
        d = (_unit_normalize(f1) - _unit_normalize(f2)) ** 2
        total = total + torch.mean(torch.sum(d * torch.abs(w), dim=-1),
                                   dim=(1, 2))
    return total


def lpips_image01(params: Dict[str, Any], a: torch.Tensor, b: torch.Tensor):
    """:func:`lpips` of [0, 1]-range images."""
    return lpips(params, a * 2.0 - 1.0, b * 2.0 - 1.0)


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def convert_torchvision_backbone(state_dict, net: str = "vgg",
                                 prefix: str = "features.",
                                 device="cuda") -> List[List[Dict]]:
    """A torchvision vgg16 / alexnet ``features.N.{weight, bias}`` (OIHW)
    state dict -> the staged HWIO layout."""
    dev = resolve_device(device)
    cfg, pools, _ = _cfg(net)
    idx = 0
    stages = []
    for si, stage in enumerate(cfg):
        if pools[si]:
            idx += 1  # the MaxPool2d module
        layers = []
        for _ in stage:
            w = np.asarray(state_dict[f"{prefix}{idx}.weight"], np.float32)
            b = np.asarray(state_dict[f"{prefix}{idx}.bias"], np.float32)
            layers.append({"kernel": torch.from_numpy(_oihw_to_hwio(w)).to(dev),
                           "bias": torch.from_numpy(b).to(dev)})
            idx += 2  # conv + relu
        stages.append(layers)
    return stages


def load_torch_lpips(backbone_path: str, lins_path: str, net: str = "vgg",
                     device="cuda") -> Dict[str, Any]:
    """LPIPS params from a torchvision vgg16 / alexnet state dict and the
    LPIPS package's linear heads (``lin{i}.model.1.weight`` [1, C, 1, 1])."""
    dev = resolve_device(device)
    bb = torch.load(backbone_path, map_location="cpu", weights_only=True)
    lin = torch.load(lins_path, map_location="cpu", weights_only=True)
    bb = {k: v.numpy() for k, v in bb.items()}
    params: Dict[str, Any] = {
        "net": convert_torchvision_backbone(bb, net, device=dev),
        "pnet": net,
    }
    params["lins"] = [
        lin[f"lin{i}.model.1.weight"].float().reshape(-1).to(dev)
        for i in range(len(_cfg(net)[2]))]
    return params
