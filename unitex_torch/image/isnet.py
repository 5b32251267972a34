"""Learned background matting: the ISNet / U²-Net family (RMBG-1.4), port
of unitex_tpu/image/isnet.py.

ISNet-DIS: a stride-2 stem conv, six encoder RSU blocks (residual
U-blocks; the last two are the dilated RSU4F form) with 2×2 max-pools
between them, five decoder RSUs over skip concatenations, and a
1-channel 3×3 side head per resolution; side 1 is the matte.  The
parameter tree keeps the JAX package's layout (``{"w": HWIO, "b"}``
convs, BatchNorm folded into ``{"scale", "shift"}``), so
``utils.params.params_from_jax`` carries a JAX tree across unchanged.
The forward runs NCHW in f32 with TF32 off and returns the JAX package's
NHWC side outputs.  ``convert_isnet_torch`` maps the RMBG-1.4 checkpoint
(``conv_in``, ``stage{1..6}``, ``stage{1..5}d``, ``side{1..6}``, REBNCONVs
with ``conv_s1`` / ``bn_s1`` leaves) onto that tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.precision import exact_f32

Params = Dict[str, Any]


# ------------------------------------------------------------------ config


@dataclasses.dataclass(frozen=True)
class RSUSpec:
    """One RSU block: ``height`` pooling levels (7/6/5/4), or a fully
    dilated bottleneck (``dilated=True``, the RSU4F form: no pooling,
    dilation 1/2/4/8)."""

    height: int
    in_ch: int
    mid_ch: int
    out_ch: int
    dilated: bool = False


@dataclasses.dataclass(frozen=True)
class IsnetConfig:
    """ISNet-DIS topology (defaults: RMBG-1.4)."""

    in_channels: int = 3
    stem_out: int = 64
    encoder: Tuple[RSUSpec, ...] = (
        RSUSpec(7, 64, 32, 64),
        RSUSpec(6, 64, 32, 128),
        RSUSpec(5, 128, 64, 256),
        RSUSpec(4, 256, 128, 512),
        RSUSpec(4, 512, 256, 512, dilated=True),
        RSUSpec(4, 512, 256, 512, dilated=True),
    )
    decoder: Tuple[RSUSpec, ...] = (  # stage5d .. stage1d
        RSUSpec(4, 1024, 256, 512, dilated=True),
        RSUSpec(4, 1024, 128, 256),
        RSUSpec(5, 512, 64, 128),
        RSUSpec(6, 256, 32, 64),
        RSUSpec(7, 128, 16, 64),
    )
    # normalization applied by the remover (RMBG-1.4: mean .5, unit std)
    mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    size: int = 1024

    @staticmethod
    def rmbg14() -> "IsnetConfig":
        return IsnetConfig()

    @staticmethod
    def tiny() -> "IsnetConfig":
        """Small-channel topology for parity tests."""
        return IsnetConfig(
            stem_out=8,
            encoder=(
                RSUSpec(7, 8, 4, 8),
                RSUSpec(6, 8, 4, 12),
                RSUSpec(5, 12, 4, 16),
                RSUSpec(4, 16, 4, 24),
                RSUSpec(4, 24, 8, 24, dilated=True),
                RSUSpec(4, 24, 8, 24, dilated=True),
            ),
            decoder=(
                RSUSpec(4, 48, 8, 24, dilated=True),
                RSUSpec(4, 48, 4, 16),
                RSUSpec(5, 32, 4, 12),
                RSUSpec(6, 24, 4, 8),
                RSUSpec(7, 16, 4, 8),
            ),
            size=64,
        )

    def side_in(self) -> List[int]:
        """Input channels of the six side heads (side1 first)."""
        d, e = self.decoder, self.encoder
        return [d[-1].out_ch, d[-2].out_ch, d[-3].out_ch, d[-4].out_ch,
                d[-5].out_ch, e[-1].out_ch]


# -------------------------------------------------------------- primitives


def _conv(p: Params, x: torch.Tensor, stride: int = 1, dilation: int = 1,
          padding: Optional[int] = None) -> torch.Tensor:
    """NCHW conv of an HWIO kernel; default padding: 3×3 'same' at this
    dilation."""
    if padding is None:
        padding = dilation
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], stride=stride,
                    padding=padding, dilation=dilation)


def _rebnconv(p: Params, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """conv3x3(dilation) + folded BatchNorm + ReLU (the REBNCONV unit)."""
    y = _conv(p["conv"], x, dilation=dilation)
    bn = p["bn"]
    return torch.relu(y * bn["scale"][:, None, None] + bn["shift"][:, None, None])


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2×2/2 max-pool with ceil_mode semantics: an odd bottom or right edge
    is padded with -inf."""
    H, W = x.shape[-2:]
    x = F.pad(x, (0, W % 2, 0, H % 2), value=float("-inf"))
    return F.max_pool2d(x, 2, 2)


def _upsample(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear half-pixel resize of NCHW ``x`` to ``size`` (only ever an
    upsampling here, where ``jax.image.resize``'s renormalized edge taps
    equal ``F.interpolate``'s clamped ones)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


# -------------------------------------------------------------------- RSU


def _rsu(p: Params, spec: RSUSpec, x: torch.Tensor) -> torch.Tensor:
    """Residual U-block.  Dilated form (RSU4F): a dilation ladder 1→2→4→8
    and back, no resampling.  Pooled form (RSU-L): L-1 encoder convs with
    pools between, a dilation-2 apex, and a decoder over skip
    concatenations, ending ``hx1d + hxin``."""
    hxin = _rebnconv(p["rebnconvin"], x)
    L = spec.height
    if spec.dilated:
        feats = [hxin]
        for i in range(L):
            feats.append(_rebnconv(p[f"rebnconv{i + 1}"], feats[-1],
                                   dilation=2 ** i))
        h = feats[-1]
        for i in range(L - 1, 0, -1):
            h = _rebnconv(p[f"rebnconv{i}d"], torch.cat([h, feats[i]], 1),
                          dilation=2 ** (i - 1))
        return h + hxin

    enc = [_rebnconv(p["rebnconv1"], hxin)]
    h = enc[0]
    for i in range(2, L):
        h = _rebnconv(p[f"rebnconv{i}"], _maxpool2(h))
        enc.append(h)
    h = _rebnconv(p[f"rebnconv{L}"], enc[-1], dilation=2)
    for i in range(L - 1, 0, -1):
        h = _rebnconv(p[f"rebnconv{i}d"], torch.cat([h, enc[i - 1]], 1))
        if i > 1:
            h = _upsample(h, enc[i - 2].shape[-2:])
    return h + hxin


# ---------------------------------------------------------------- forward


@exact_f32()
def isnet_forward(params: Params, cfg: IsnetConfig,
                  x: torch.Tensor) -> List[torch.Tensor]:
    """x: [B, H, W, 3] normalized.  Returns the 6 side-output logit maps
    [B, H, W, 1], finest (side1, the matte) first, each resized to the
    input size."""
    H, W = x.shape[1:3]
    h = _conv(params["conv_in"], x.permute(0, 3, 1, 2).float(), stride=2,
              padding=1)
    skips = []
    for i, spec in enumerate(cfg.encoder):
        h = _rsu(params[f"stage{i + 1}"], spec, h)
        skips.append(h)
        if i < len(cfg.encoder) - 1:
            h = _maxpool2(h)

    sides = [skips[-1]]  # hx6 feeds side6
    for j, spec in enumerate(cfg.decoder):
        stage = len(cfg.decoder) - j  # 5..1
        skip = skips[stage - 1]
        h = _rsu(params[f"stage{stage}d"], spec,
                 torch.cat([_upsample(h, skip.shape[-2:]), skip], 1))
        sides.append(h)
    sides = sides[::-1]  # hx1d .. hx5d, hx6
    return [_upsample(_conv(params[f"side{i + 1}"], f), (H, W))
            .permute(0, 2, 3, 1) for i, f in enumerate(sides)]


# ------------------------------------------------------------------- init


def _rsu_convs(spec: RSUSpec) -> List[Tuple[str, int, int]]:
    """(name, in, out) of an RSU's REBNCONVs, in the JAX init's order."""
    L, mid, out = spec.height, spec.mid_ch, spec.out_ch
    convs = [("rebnconvin", spec.in_ch, out)]
    if spec.dilated:
        cin = out
        for i in range(L):
            convs.append((f"rebnconv{i + 1}", cin, mid))
            cin = mid
    else:
        convs.append(("rebnconv1", out, mid))
        convs += [(f"rebnconv{i}", mid, mid) for i in range(2, L + 1)]
    convs += [(f"rebnconv{i}d", 2 * mid, out if i == 1 else mid)
              for i in range(L - 1, 0, -1)]
    return convs


def _stages(cfg: IsnetConfig) -> List[Tuple[str, RSUSpec]]:
    return ([(f"stage{i + 1}", s) for i, s in enumerate(cfg.encoder)]
            + [(f"stage{len(cfg.decoder) - j}d", s)
               for j, s in enumerate(cfg.decoder)])


def init_isnet_params(generator: Optional[torch.Generator], cfg: IsnetConfig,
                      device=None) -> Params:
    """A seeded tree in the JAX package's layout (f32): the converter's
    BatchNorm fold of :func:`isnet_state_dict`, on ``device`` (default:
    the generator's)."""
    dev = device if device is not None else generator.device
    return convert_isnet_torch(isnet_state_dict(generator, cfg, dev), cfg, dev)


def isnet_state_dict(generator: Optional[torch.Generator], cfg: IsnetConfig,
                     device=None) -> Dict[str, torch.Tensor]:
    """A seeded state dict in the RMBG-1.4 checkpoint's naming (He-normal
    OIHW convs, BatchNorms with random affine and running statistics), on
    ``device`` (default: the generator's; ``"meta"`` with no generator
    gives shapes only)."""
    dev = device if device is not None else generator.device
    sd: Dict[str, torch.Tensor] = {}

    def rand(shape, std, mean=0.0):
        return torch.empty(shape, device=dev).normal_(mean, std,
                                                      generator=generator)

    def conv(name, cin, cout):
        sd[f"{name}.weight"] = rand((cout, cin, 3, 3), (2.0 / (9 * cin)) ** 0.5)
        sd[f"{name}.bias"] = rand((cout,), 0.1)

    def bn(name, n):
        sd[f"{name}.weight"] = rand((n,), 0.3, 1.0)
        sd[f"{name}.bias"] = rand((n,), 0.2)
        sd[f"{name}.running_mean"] = rand((n,), 0.5)
        sd[f"{name}.running_var"] = torch.empty(n, device=dev).uniform_(
            0.3, 2.3, generator=generator)
        sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64,
                                                        device=dev)

    conv("conv_in", cfg.in_channels, cfg.stem_out)
    for stage, spec in _stages(cfg):
        for n, i, o in _rsu_convs(spec):
            conv(f"{stage}.{n}.conv_s1", i, o)
            bn(f"{stage}.{n}.bn_s1", o)
    for i, cin in enumerate(cfg.side_in()):
        conv(f"side{i + 1}", cin, 1)
    return sd


# -------------------------------------------------------------- converter


def as_f32(v, device) -> torch.Tensor:
    """A checkpoint leaf (tensor or numpy array) as f32 on ``device``."""
    t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    return t.detach().to(device=device, dtype=torch.float32)


def bn_scale(g: torch.Tensor, var: torch.Tensor, eps: float) -> torch.Tensor:
    """``g / sqrt(var + eps)`` in f32 with a correctly rounded square root
    (taken in f64: PyTorch's vectorized f32 sqrt on the CPU is not always),
    so a folded tree equals the JAX package's numpy fold bit for bit."""
    return g / torch.sqrt((var + eps).double()).float()


def _fold_bn(sd, prefix: str, device, eps: float = 1e-5) -> Params:
    g = as_f32(sd[f"{prefix}.weight"], device)
    b = as_f32(sd[f"{prefix}.bias"], device)
    mean = as_f32(sd[f"{prefix}.running_mean"], device)
    var = as_f32(sd[f"{prefix}.running_var"], device)
    scale = bn_scale(g, var, eps)
    return {"scale": scale, "shift": b - mean * scale}


def _conv_t(sd, prefix: str, device) -> Params:
    w = as_f32(sd[f"{prefix}.weight"], device)  # OIHW
    return {"w": w.permute(2, 3, 1, 0).contiguous(),  # HWIO
            "b": as_f32(sd[f"{prefix}.bias"], device)}


def convert_isnet_torch(sd: Dict[str, Any], cfg: IsnetConfig,
                        device="cuda") -> Params:
    """Map an ISNet state dict (RMBG-1.4 / DIS naming; tensors or numpy
    arrays; a ``module.`` prefix is stripped) onto the tree, each
    BatchNorm folded into a per-channel scale/shift at eps 1e-5."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}

    def rebnconv(prefix: str) -> Params:
        return {"conv": _conv_t(sd, f"{prefix}.conv_s1", device),
                "bn": _fold_bn(sd, f"{prefix}.bn_s1", device)}

    def rsu(prefix: str, spec: RSUSpec) -> Params:
        p = {"rebnconvin": rebnconv(f"{prefix}.rebnconvin")}
        for i in range(1, spec.height + 1):
            p[f"rebnconv{i}"] = rebnconv(f"{prefix}.rebnconv{i}")
        for i in range(spec.height - 1, 0, -1):
            p[f"rebnconv{i}d"] = rebnconv(f"{prefix}.rebnconv{i}d")
        return p

    p: Params = {"conv_in": _conv_t(sd, "conv_in", device)}
    for name, spec in _stages(cfg):
        p[name] = rsu(name, spec)
    for i in range(6):
        p[f"side{i + 1}"] = _conv_t(sd, f"side{i + 1}", device)
    return p


def read_state_dict(path: str) -> Dict[str, Any]:
    """A checkpoint's tensors on the host: ``.safetensors``, or a torch
    pickle (``.pth`` / ``.bin``, optionally under ``"state_dict"``)."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def load_isnet(path: str, cfg: Optional[IsnetConfig] = None,
               device="cuda") -> Tuple[Params, IsnetConfig]:
    """RMBG-1.4 weights from a ``.safetensors`` or ``.pth`` file onto
    ``device``; a checkpoint of another topology raises ``ValueError``."""
    cfg = cfg or IsnetConfig.rmbg14()
    params = convert_isnet_torch(read_state_dict(path), cfg, device)
    got = tuple(params["conv_in"]["w"].shape)
    want = (3, 3, cfg.in_channels, cfg.stem_out)
    if got != want or params["stage1"]["rebnconvin"]["conv"]["w"].shape[-1] \
            != cfg.encoder[0].out_ch:
        raise ValueError(
            f"checkpoint at {path} does not match the {want} topology "
            f"(conv_in {got})")
    return params, cfg


# --------------------------------------------------------------- remover


def normalized_input(image, size: int, mean, std) -> np.ndarray:
    """The removers' host preprocess: RGB, PIL resize to ``size``², scaled
    to [0, 1] and normalized; [1, size, size, 3] f32."""
    rgb = image.convert("RGB")
    x = np.asarray(rgb.resize((size, size)), np.float32) / 255.0
    x = (x - np.asarray(mean)) / np.asarray(std)
    return x[None].astype(np.float32)


def matte_image(pred: np.ndarray, size):
    """A [0, 1] matte as a PIL 'L' image of ``size``: ``* 255`` truncated
    to uint8, then PIL-resized."""
    from PIL import Image

    mask = Image.fromarray((pred * 255).astype(np.uint8), mode="L")
    return mask.resize(size)


class IsnetRemover:
    """Callable PIL RGB image -> PIL 'L' alpha matte: ISNet at
    ``cfg.size``² on the parameters' device.  Postprocess as RMBG-1.4:
    sigmoid, then min-max normalize the finest side."""

    def __init__(self, params: Params, cfg: IsnetConfig):
        self.params = params
        self.cfg = cfg
        self.device = params["conv_in"]["w"].device

    @torch.no_grad()
    def _fwd(self, x: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(x).to(self.device)
        return isnet_forward(self.params, self.cfg, x)[0]

    @torch.no_grad()
    def __call__(self, image):
        rgb = image.convert("RGB")
        cfg = self.cfg
        d1 = self._fwd(normalized_input(rgb, cfg.size, cfg.mean, cfg.std))
        pred = torch.sigmoid(torch.as_tensor(d1)[0, ..., 0].float())
        pred = (pred - pred.min()) / torch.clamp(pred.max() - pred.min(),
                                                 min=1e-8)
        return matte_image(pred.cpu().numpy(), rgb.size)
