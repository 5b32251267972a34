"""BiRefNet, the RMBG-2.0 matting tower; port of
unitex_tpu/models/birefnet.py.

A Swin-v1 backbone run at full and half scale, a context-concatenated
squeeze block, and a decoder whose blocks mix deformable-convolution ASPP,
gradient attention and per-level "image pyramid token" (ipt) patches of
the input.  The parameter tree keeps the JAX package's layout (HWIO conv
``kernel``s, ``[in, out]`` dense kernels, BatchNorms folded into the
preceding convs), so ``utils.params.params_from_jax`` carries a JAX tree
across unchanged.  Inference only, in f32 with TF32 off.  Window attention
and the deformable conv are plain PyTorch, as the JAX package computes
them outside any Pallas kernel: the windowed attention as two batched
products with the relative-position bias and the shift mask added, the
deformable conv as a loop over its k² taps, each one bilinear gather of
the input and one product with that tap's kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..image.isnet import (as_f32, bn_scale, matte_image, normalized_input,
                           read_state_dict)
from ..utils.precision import exact_f32

Params = Dict[str, Any]


# ------------------------------------------------------------------ config


@dataclasses.dataclass(frozen=True)
class BiRefNetConfig:
    """BiRefNet topology.  Defaults = RMBG-2.0 (BiRefNet-general):
    swin_v1_large backbone, dual-scale feature concat (doubled lateral
    channels), 3 context levels into the squeeze block, split ipt
    decoration at every decoder level, gradient attention on levels
    4/3/2."""

    # swin backbone
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window: int = 12
    mlp_ratio: float = 4.0
    # birefnet head
    cxt_num: int = 3
    dec_inter: int = 64        # BasicDecBlk inter channels
    aspp_inter: int = 256      # ASPPDeformable inter channels
    aspp_kernels: Tuple[int, ...] = (1, 3, 7)  # parallel deform branches
    gdt_channels: int = 16     # the gdt conv stacks' width
    # remover interface
    size: int = 1024
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)

    @property
    def stage_channels(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * (2**i) for i in range(len(self.depths)))

    @property
    def channels(self) -> Tuple[int, ...]:
        """Decoder lateral channels, deepest first, doubled by the
        dual-scale backbone concat."""
        return tuple(2 * c for c in reversed(self.stage_channels))

    @property
    def cxt(self) -> Tuple[int, ...]:
        """Context channels appended to x4 (x1..x3 order)."""
        if not self.cxt_num:
            return ()
        return tuple(list(self.channels[1:])[::-1][-self.cxt_num:])

    @property
    def ipt_out(self) -> Tuple[int, ...]:
        """ipt block out-channels for levels [5, 4, 3, 2, 1]
        (channels // 8)."""
        ch = self.channels
        return (ch[0] // 8, ch[0] // 8, ch[1] // 8, ch[2] // 8, ch[3] // 8)

    @staticmethod
    def rmbg20() -> "BiRefNetConfig":
        return BiRefNetConfig()

    @staticmethod
    def tiny() -> "BiRefNetConfig":
        return BiRefNetConfig(
            embed_dim=8,
            depths=(1, 1, 2, 1),
            num_heads=(1, 2, 4, 8),
            window=4,
            dec_inter=8,
            aspp_inter=8,
            gdt_channels=4,
            size=64,
        )


# split ipt in-channels: the fixed stride-ratio patch counts × 3
IPT_IN = (3 * 32 * 32, 3 * 16 * 16, 3 * 8 * 8, 3 * 4 * 4, 3)


# ------------------------------------------------------- primitive helpers


def _conv(p: Params, x: torch.Tensor, stride: int = 1,
          pad: Optional[int] = None) -> torch.Tensor:
    """NCHW conv of an HWIO kernel; default padding (k-1)//2 each side
    (the stride-4 patch embed passes ``pad=0``)."""
    k = p["kernel"].shape[0]
    if pad is None:
        pad = (k - 1) // 2
    return F.conv2d(x, p["kernel"].permute(3, 2, 0, 1), p.get("bias"),
                    stride=stride, padding=pad)


def _dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def _ln(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _ac_tables(n_in: int, n_out: int):
    """Align-corners lerp tables along one axis: (i0, i1, w) with i0
    clamped to n_in - 2, so the last sample takes i1 at weight 1."""
    if n_out == 1 or n_in == 1:
        idx0 = np.zeros(n_out, np.int64)
        return idx0, idx0, np.zeros(n_out, np.float32)
    pos = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    i0 = np.minimum(np.floor(pos).astype(np.int64), n_in - 2)
    return i0, i0 + 1, (pos - i0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _on_device(make, *args):
    """``make(*args[:-1])``'s numpy tables as tensors on the device
    ``args[-1]``, made once: a copy from pageable host memory would wait
    for the device at every block."""
    out = make(*args[:-1])
    dev = args[-1]
    if isinstance(out, tuple):
        return tuple(torch.from_numpy(t).to(dev) for t in out)
    return torch.from_numpy(out).to(dev)


def _resize_ac(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` with ``align_corners=True`` semantics
    (the decoder's mode), as separable lerps over numpy index tables."""
    H, W = x.shape[-2:]
    Ho, Wo = size
    if (H, W) == (Ho, Wo):
        return x
    y0, y1, wy = _on_device(_ac_tables, H, Ho, x.device)
    wy = wy[:, None]
    x = x.index_select(-2, y0) * (1.0 - wy) + x.index_select(-2, y1) * wy
    x0, x1, wx = _on_device(_ac_tables, W, Wo, x.device)
    return x.index_select(-1, x0) * (1.0 - wx) + x.index_select(-1, x1) * wx


# ------------------------------------------------------------ swin backbone


def _rel_position_index(w: int) -> np.ndarray:
    coords = np.stack(
        np.meshgrid(np.arange(w), np.arange(w), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


def _shift_mask(Hp: int, Wp: int, w: int, s: int) -> np.ndarray:
    """[nW, w*w, w*w] additive attention mask (-100 across regions) for
    shifted windows on a padded (Hp, Wp) grid."""
    img = np.zeros((Hp, Wp), np.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(Hp // w, w, Wp // w, w).transpose(0, 2, 1, 3)
    win = win.reshape(-1, w * w)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _window_attention(p: Params, x: torch.Tensor, n_heads: int, w: int,
                      mask: Optional[torch.Tensor]) -> torch.Tensor:
    """x [B, nW, w*w, C]; mask [nW, w*w, w*w] or None."""
    B, nW, N, C = x.shape
    hd = C // n_heads
    qkv = _dense(p["qkv"], x).reshape(B, nW, N, 3, n_heads, hd)
    qkv = qkv.permute(3, 0, 1, 4, 2, 5)          # [3, B, nW, nH, N, hd]
    q, k, v = qkv[0] * (hd ** -0.5), qkv[1], qkv[2]
    attn = q @ k.transpose(-1, -2)                # [B, nW, nH, N, N]
    bias = p["bias_table"][_on_device(_rel_position_index, w, x.device)]
    attn = attn + bias.permute(2, 0, 1)
    if mask is not None:
        attn = attn + mask[None, :, None]
    attn = torch.softmax(attn, dim=-1)
    out = (attn @ v).permute(0, 1, 3, 2, 4).reshape(B, nW, N, C)
    return _dense(p["proj"], out)


def _swin_block(p: Params, x: torch.Tensor, n_heads: int, w: int,
                shift: int) -> torch.Tensor:
    """x [B, H, W, C] -> same: the detection-variant Swin block (pad to
    window multiples, roll by -shift, window, attend, reverse, crop)."""
    B, H, W, C = x.shape
    shortcut = x
    x = _ln(p["norm1"], x)
    pb, pr = (-H) % w, (-W) % w
    Hp, Wp = H + pb, W + pr
    x = F.pad(x, (0, 0, 0, pr, 0, pb))
    mask = None
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = _on_device(_shift_mask, Hp, Wp, w, shift, x.device)
    x = x.reshape(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, (Hp // w) * (Wp // w), w * w, C)
    x = _window_attention(p["attn"], x, n_heads, w, mask)
    x = x.reshape(B, Hp // w, Wp // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, Hp, Wp, C)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    x = shortcut + x[:, :H, :W]
    h = _ln(p["norm2"], x)
    h = _dense(p["mlp"]["fc2"], F.gelu(_dense(p["mlp"]["fc1"], h)))
    return x + h


def _patch_merge(p: Params, x: torch.Tensor) -> torch.Tensor:
    H, W = x.shape[1:3]
    x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1)
    return _dense(p["reduction"], _ln(p["norm"], x))


def swin_forward(p: Params, cfg: BiRefNetConfig,
                 x: torch.Tensor) -> List[torch.Tensor]:
    """x [B, 3, H, W] -> 4 NHWC stage features (the layer-normed
    ``norm{i}`` outputs)."""
    x = _conv(p["patch_embed"]["proj"], x, stride=4, pad=0)
    x = _ln(p["patch_embed"]["norm"], x.permute(0, 2, 3, 1))
    feats = []
    for i, stage in enumerate(p["layers"]):
        for j, blk in enumerate(stage["blocks"]):
            shift = 0 if j % 2 == 0 else cfg.window // 2
            x = _swin_block(blk, x, cfg.num_heads[i], cfg.window, shift)
        feats.append(_ln(p["norms"][i], x))
        if stage.get("downsample") is not None:
            x = _patch_merge(stage["downsample"], x)
    return feats


# ----------------------------------------------------- deformable conv ASPP


def _deform_conv(p: Params, x: torch.Tensor, k: int) -> torch.Tensor:
    """Modulated deformable conv (DCNv2) of NCHW ``x``: offsets (Δy, Δx
    per tap, taps in ``meshgrid(..., indexing="ij")`` order) and a
    2·sigmoid modulator from regular convs; each tap bilinearly gathers
    the input, a corner counting only where it lies inside the image, and
    adds its product with the tap's kernel.  One tap at a time: the
    decoder's finest level never holds more than one tap's samples."""
    B, C, H, W = x.shape
    K = k * k
    off = _conv(p["offset"], x).reshape(B, K, 2, H, W)
    mod = 2.0 * torch.sigmoid(_conv(p["modulator"], x))      # [B, K, H, W]
    pad = (k - 1) // 2
    w_k = p["kernel"].reshape(K, C, -1)                      # [K, C, O]
    O = w_k.shape[-1]
    rows = x.permute(0, 2, 3, 1).reshape(B * H * W, C)
    base = (torch.arange(B, device=x.device) * (H * W))[:, None, None]
    ys = torch.arange(H, dtype=x.dtype, device=x.device)[:, None]
    xs = torch.arange(W, dtype=x.dtype, device=x.device)[None, :]
    acc = torch.zeros(B, H, W, O, dtype=x.dtype, device=x.device)
    for t in range(K):
        dy, dx = t // k - pad, t % k - pad
        py = ys + float(dy) + off[:, t, 0]
        px = xs + float(dx) + off[:, t, 1]
        y0 = torch.floor(py)
        x0 = torch.floor(px)
        wy = py - y0
        wx = px - x0
        val = 0.0
        for oy, wyy in ((y0, 1.0 - wy), (y0 + 1.0, wy)):
            for ox, wxx in ((x0, 1.0 - wx), (x0 + 1.0, wx)):
                iy = oy.long().clamp(0, H - 1)
                ix = ox.long().clamp(0, W - 1)
                inside = (oy >= 0) & (oy <= H - 1) & (ox >= 0) & (ox <= W - 1)
                g = rows.index_select(0, (base + iy * W + ix).reshape(-1))
                g = g.reshape(B, H, W, C)
                val = val + g * (wyy * wxx * inside)[..., None]
        acc = acc + (val * mod[:, t, ..., None]) @ w_k[t]
    if "bias" in p:
        acc = acc + p["bias"]
    return acc.permute(0, 3, 1, 2)


def _aspp_deformable(p: Params, cfg: BiRefNetConfig,
                     x: torch.Tensor) -> torch.Tensor:
    """ASPPDeformable: deformable 1×1 + parallel deformable k×k branches +
    a global-average-pool branch, concat -> 1×1 conv (+folded BN) ->
    relu."""
    branches = [torch.relu(_deform_conv(p["aspp1"], x, 1))]
    for bp, k in zip(p["deforms"], cfg.aspp_kernels):
        branches.append(torch.relu(_deform_conv(bp, x, k)))
    g = torch.relu(_conv(p["gap"], x.mean(dim=(2, 3), keepdim=True)))
    branches.append(g.expand_as(branches[0]))
    return torch.relu(_conv(p["project"], torch.cat(branches, 1)))


def _dec_blk(p: Params, cfg: BiRefNetConfig, x: torch.Tensor) -> torch.Tensor:
    """BasicDecBlk: conv_in(+BN) -> relu -> ASPPDeformable ->
    conv_out(+BN)."""
    x = torch.relu(_conv(p["conv_in"], x))
    return _conv(p["conv_out"], _aspp_deformable(p["aspp"], cfg, x))


def _simple_convs(p: Params, x: torch.Tensor) -> torch.Tensor:
    return _conv(p["conv_out"], _conv(p["conv1"], x))


# ------------------------------------------------------------------ decoder


def _split_patches(x: torch.Tensor, size) -> torch.Tensor:
    """The decoder's split ipt decoration of NHWC ``x``: tile it into
    (H/h, W/w) patches of the target size and stack them on the channel
    axis, column-major then row within column (the reference's
    ``get_patches_batch`` order); NCHW out."""
    B, H, W, C = x.shape
    h, w = size
    nr, nc = H // h, W // w
    x = x.reshape(B, nr, h, nc, w, C).permute(0, 2, 4, 3, 1, 5)
    return x.reshape(B, h, w, nc * nr * C).permute(0, 3, 1, 2)


@exact_f32()
def birefnet_forward(params: Params, cfg: BiRefNetConfig,
                     x: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, 3] (ImageNet-normalized) -> matte logits [B, H, W, 1]:
    dual-scale Swin features -> context concat -> squeeze -> the
    ipt-decorated decoder with gdt attention at levels 4/3/2."""
    H, W = x.shape[1:3]
    x_nhwc = x.float()
    x = x_nhwc.permute(0, 3, 1, 2)
    f_full = swin_forward(params["bb"], cfg, x)
    f_half = swin_forward(params["bb"], cfg, _resize_ac(x, (H // 2, W // 2)))
    feats = []
    for f, g in zip(f_full, f_half):
        f = f.permute(0, 3, 1, 2)
        g = g.permute(0, 3, 1, 2)
        feats.append(torch.cat([f, _resize_ac(g, f.shape[-2:])], 1))
    del f_full, f_half
    x1, x2, x3, x4 = feats
    if cfg.cxt_num:
        cxt = [_resize_ac(f, x4.shape[-2:]) for f in (x1, x2, x3)]
        x4 = torch.cat(cxt[-cfg.cxt_num:] + [x4], 1)
    for sp in params["squeeze"]:
        x4 = _dec_blk(sp, cfg, x4)

    dec = params["decoder"]

    def ipt(level: int, size) -> torch.Tensor:
        return _simple_convs(dec["ipt"][level], _split_patches(x_nhwc, size))

    def gdt_attn(gp: Params, p: torch.Tensor) -> torch.Tensor:
        g = torch.relu(_conv(gp["conv"], p))
        return p * torch.sigmoid(_conv(gp["attn"], g))

    p = torch.cat([x4, ipt(0, x4.shape[-2:])], 1)
    for lvl, lat in ((4, x3), (3, x2), (2, x1)):
        p = gdt_attn(dec[f"gdt{lvl}"], _dec_blk(dec[f"block{lvl}"], cfg, p))
        p = _resize_ac(p, lat.shape[-2:]) + _conv(dec[f"lateral{lvl}"], lat)
        p = torch.cat([p, ipt(5 - lvl, p.shape[-2:])], 1)
    p = _resize_ac(_dec_blk(dec["block1"], cfg, p), (H, W))
    p = torch.cat([p, ipt(4, (H, W))], 1)
    return _conv(dec["out"], p).permute(0, 2, 3, 1)


# --------------------------------------------------------------------- init


def init_birefnet_params(generator: Optional[torch.Generator],
                         cfg: BiRefNetConfig, device=None) -> Params:
    """A seeded tree in the JAX package's layout (f32): the converter's
    fold of :func:`birefnet_state_dict`, on ``device`` (default: the
    generator's; ``"meta"`` with no generator gives shapes only)."""
    dev = device if device is not None else generator.device
    return convert_birefnet_torch(birefnet_state_dict(generator, cfg, dev),
                                  cfg, dev)


def birefnet_state_dict(generator: Optional[torch.Generator],
                        cfg: BiRefNetConfig,
                        device=None) -> Dict[str, torch.Tensor]:
    """A seeded state dict in the RMBG-2.0 checkpoint's naming (OIHW
    convs, ``[out, in]`` linears), on ``device`` (default: the
    generator's; ``"meta"`` with no generator gives shapes only).  Every
    BatchNorm has random affine and running statistics, and the offset
    and modulator convs are non-zero (offsets of about a pixel), so a
    converter's BatchNorm fold and the deformable gathers both matter."""
    dev = device if device is not None else generator.device
    sd: Dict[str, torch.Tensor] = {}

    def normal(shape, std, mean=0.0):
        return torch.empty(shape, device=dev).normal_(mean, std,
                                                      generator=generator)

    def conv(name, k, cin, cout, bias=True, std=None):
        sd[f"{name}.weight"] = normal(
            (cout, cin, k, k), std or 1 / math.sqrt(k * k * cin))
        if bias:
            sd[f"{name}.bias"] = normal((cout,), 0.05)

    def bn(name, n):
        sd[f"{name}.weight"] = normal((n,), 0.2, 1.0)
        sd[f"{name}.bias"] = normal((n,), 0.2)
        sd[f"{name}.running_mean"] = normal((n,), 0.3)
        sd[f"{name}.running_var"] = torch.empty(n, device=dev).uniform_(
            0.5, 1.5, generator=generator)
        sd[f"{name}.num_batches_tracked"] = torch.zeros(
            (), dtype=torch.int64, device=dev)

    def linear(name, cin, cout, bias=True):
        sd[f"{name}.weight"] = normal((cout, cin), 1 / math.sqrt(cin))
        if bias:
            sd[f"{name}.bias"] = normal((cout,), 0.02)

    def ln(name, c):
        sd[f"{name}.weight"] = normal((c,), 0.1, 1.0)
        sd[f"{name}.bias"] = normal((c,), 0.1)

    def deform(name, k, cin, cout):
        for part, n in (("offset_conv", 2 * k * k), ("modulator_conv", k * k)):
            sd[f"{name}.{part}.weight"] = normal((n, cin, k, k), 0.05)
            sd[f"{name}.{part}.bias"] = normal((n,), 0.3)
        conv(f"{name}.regular_conv", k, cin, cout, bias=False)

    def dec_blk(name, cin, cout):
        ic, ai = cfg.dec_inter, cfg.aspp_inter
        conv(f"{name}.conv_in", 3, cin, ic)
        bn(f"{name}.bn_in", ic)
        att = f"{name}.dec_att"
        deform(f"{att}.aspp1.atrous_conv", 1, ic, ai)
        bn(f"{att}.aspp1.bn", ai)
        for i, k in enumerate(cfg.aspp_kernels):
            deform(f"{att}.aspp_deforms.{i}.atrous_conv", k, ic, ai)
            bn(f"{att}.aspp_deforms.{i}.bn", ai)
        conv(f"{att}.global_avg_pool.1", 1, ic, ai, bias=False)
        bn(f"{att}.global_avg_pool.2", ai)
        conv(f"{att}.conv1", 1, (2 + len(cfg.aspp_kernels)) * ai, ic,
             bias=False)
        bn(f"{att}.bn1", ic)
        conv(f"{name}.conv_out", 3, ic, cout)
        bn(f"{name}.bn_out", cout)

    ed, w = cfg.embed_dim, cfg.window
    conv("bb.patch_embed.proj", 4, 3, ed)
    ln("bb.patch_embed.norm", ed)
    for i, depth in enumerate(cfg.depths):
        c = cfg.stage_channels[i]
        hidden = int(c * cfg.mlp_ratio)
        for j in range(depth):
            pre = f"bb.layers.{i}.blocks.{j}"
            ln(f"{pre}.norm1", c)
            linear(f"{pre}.attn.qkv", c, 3 * c)
            linear(f"{pre}.attn.proj", c, c)
            sd[f"{pre}.attn.relative_position_bias_table"] = normal(
                ((2 * w - 1) ** 2, cfg.num_heads[i]), 0.02)
            sd[f"{pre}.attn.relative_position_index"] = torch.from_numpy(
                _rel_position_index(w).reshape(w * w, w * w)).to(dev)
            ln(f"{pre}.norm2", c)
            linear(f"{pre}.mlp.fc1", c, hidden)
            linear(f"{pre}.mlp.fc2", hidden, c)
        if i < len(cfg.depths) - 1:
            ln(f"bb.layers.{i}.downsample.norm", 4 * c)
            linear(f"bb.layers.{i}.downsample.reduction", 4 * c, 2 * c,
                   bias=False)
        ln(f"bb.norm{i}", c)

    ch, io, ng = cfg.channels, cfg.ipt_out, cfg.gdt_channels
    dec_blk("squeeze_module.0", ch[0] + sum(cfg.cxt), ch[0])
    for i, (cin, cout) in enumerate(zip(IPT_IN, io)):
        conv(f"decoder.ipt_blk{5 - i}.conv1", 3, cin, 64)
        conv(f"decoder.ipt_blk{5 - i}.conv_out", 3, 64, cout)
    dec_blk("decoder.decoder_block4", ch[0] + io[0], ch[1])
    dec_blk("decoder.decoder_block3", ch[1] + io[1], ch[2])
    dec_blk("decoder.decoder_block2", ch[2] + io[2], ch[3])
    dec_blk("decoder.decoder_block1", ch[3] + io[3], ch[3] // 2)
    conv("decoder.conv_out1.0", 1, ch[3] // 2 + io[4], 1)
    for lvl, c in ((4, ch[1]), (3, ch[2]), (2, ch[3])):
        conv(f"decoder.lateral_block{lvl}.conv", 1, c, c)
        conv(f"decoder.gdt_convs_{lvl}.0", 3, c, ng)
        bn(f"decoder.gdt_convs_{lvl}.1", ng)
        conv(f"decoder.gdt_convs_attn_{lvl}.0", 1, ng, 1)
    return sd


# ---------------------------------------------------------------- converter


def _t_conv(sd, prefix: str, device) -> Params:
    w = as_f32(sd[f"{prefix}.weight"], device)
    p: Params = {"kernel": w.permute(2, 3, 1, 0).contiguous()}
    if f"{prefix}.bias" in sd:
        p["bias"] = as_f32(sd[f"{prefix}.bias"], device)
    return p


def _t_conv_bn(sd, conv: str, bn: str, device, eps: float = 1e-5) -> Params:
    """Fold ``bn`` (following ``conv``) into the conv kernel and bias; a
    missing BN degrades to the plain conv."""
    if f"{bn}.weight" not in sd:
        return _t_conv(sd, conv, device)
    w = as_f32(sd[f"{conv}.weight"], device)
    b = (as_f32(sd[f"{conv}.bias"], device) if f"{conv}.bias" in sd
         else torch.zeros(w.shape[0], device=device))
    g = as_f32(sd[f"{bn}.weight"], device)
    beta = as_f32(sd[f"{bn}.bias"], device)
    mu = as_f32(sd[f"{bn}.running_mean"], device)
    var = as_f32(sd[f"{bn}.running_var"], device)
    s = bn_scale(g, var, eps)
    return {"kernel": (w * s[:, None, None, None]).permute(2, 3, 1, 0)
            .contiguous(),
            "bias": (b - mu) * s + beta}


def _t_dense(sd, prefix: str, device) -> Params:
    p: Params = {"kernel": as_f32(sd[f"{prefix}.weight"], device).t().contiguous()}
    if f"{prefix}.bias" in sd:
        p["bias"] = as_f32(sd[f"{prefix}.bias"], device)
    return p


def _t_ln(sd, prefix: str, device) -> Params:
    return {"scale": as_f32(sd[f"{prefix}.weight"], device),
            "bias": as_f32(sd[f"{prefix}.bias"], device)}


def _t_deform(sd, prefix: str, bn: str, device) -> Params:
    """DeformableConv2d, its trailing BN folded into the regular conv."""
    reg = _t_conv_bn(sd, f"{prefix}.regular_conv", bn, device)
    p: Params = {"offset": _t_conv(sd, f"{prefix}.offset_conv", device),
                 "modulator": _t_conv(sd, f"{prefix}.modulator_conv", device),
                 "kernel": reg["kernel"]}
    if "bias" in reg:
        p["bias"] = reg["bias"]
    return p


def _t_dec_blk(sd, cfg: BiRefNetConfig, prefix: str, device) -> Params:
    att = f"{prefix}.dec_att"
    return {
        "conv_in": _t_conv_bn(sd, f"{prefix}.conv_in", f"{prefix}.bn_in",
                              device),
        "aspp": {
            "aspp1": _t_deform(sd, f"{att}.aspp1.atrous_conv",
                               f"{att}.aspp1.bn", device),
            "deforms": [_t_deform(sd, f"{att}.aspp_deforms.{i}.atrous_conv",
                                  f"{att}.aspp_deforms.{i}.bn", device)
                        for i in range(len(cfg.aspp_kernels))],
            "gap": _t_conv_bn(sd, f"{att}.global_avg_pool.1",
                              f"{att}.global_avg_pool.2", device),
            "project": _t_conv_bn(sd, f"{att}.conv1", f"{att}.bn1", device),
        },
        "conv_out": _t_conv_bn(sd, f"{prefix}.conv_out", f"{prefix}.bn_out",
                               device),
    }


def convert_birefnet_torch(sd: Dict[str, Any], cfg: BiRefNetConfig,
                           device="cuda") -> Params:
    """Map a BiRefNet / RMBG-2.0 state dict (tensors or numpy arrays) onto
    the tree on ``device``, every BatchNorm folded into its conv at eps
    1e-5.  Training-only heads are ignored."""
    bb: Params = {
        "patch_embed": {"proj": _t_conv(sd, "bb.patch_embed.proj", device),
                        "norm": _t_ln(sd, "bb.patch_embed.norm", device)},
        "layers": [],
        "norms": [_t_ln(sd, f"bb.norm{i}", device)
                  for i in range(len(cfg.depths))],
    }
    for i, depth in enumerate(cfg.depths):
        blocks = []
        for j in range(depth):
            pre = f"bb.layers.{i}.blocks.{j}"
            blocks.append({
                "norm1": _t_ln(sd, f"{pre}.norm1", device),
                "attn": {
                    "qkv": _t_dense(sd, f"{pre}.attn.qkv", device),
                    "proj": _t_dense(sd, f"{pre}.attn.proj", device),
                    "bias_table": as_f32(
                        sd[f"{pre}.attn.relative_position_bias_table"], device),
                },
                "norm2": _t_ln(sd, f"{pre}.norm2", device),
                "mlp": {"fc1": _t_dense(sd, f"{pre}.mlp.fc1", device),
                        "fc2": _t_dense(sd, f"{pre}.mlp.fc2", device)},
            })
        down = None
        if f"bb.layers.{i}.downsample.reduction.weight" in sd:
            down = {"norm": _t_ln(sd, f"bb.layers.{i}.downsample.norm", device),
                    "reduction": _t_dense(
                        sd, f"bb.layers.{i}.downsample.reduction", device)}
        bb["layers"].append({"blocks": blocks, "downsample": down})

    n_sq = len({k.split(".")[1] for k in sd if k.startswith("squeeze_module.")})
    dec: Params = {
        "ipt": [{"conv1": _t_conv(sd, f"decoder.ipt_blk{5 - i}.conv1", device),
                 "conv_out": _t_conv(sd, f"decoder.ipt_blk{5 - i}.conv_out",
                                     device)}
                for i in range(5)],
        "out": _t_conv(sd, "decoder.conv_out1.0", device),
    }
    for lvl in (4, 3, 2, 1):
        dec[f"block{lvl}"] = _t_dec_blk(sd, cfg, f"decoder.decoder_block{lvl}",
                                        device)
    for lvl in (4, 3, 2):
        dec[f"lateral{lvl}"] = _t_conv(sd, f"decoder.lateral_block{lvl}.conv",
                                       device)
        dec[f"gdt{lvl}"] = {
            "conv": _t_conv_bn(sd, f"decoder.gdt_convs_{lvl}.0",
                               f"decoder.gdt_convs_{lvl}.1", device),
            "attn": _t_conv(sd, f"decoder.gdt_convs_attn_{lvl}.0", device),
        }
    return {"bb": bb,
            "squeeze": [_t_dec_blk(sd, cfg, f"squeeze_module.{i}", device)
                        for i in range(n_sq)],
            "decoder": dec}


def load_birefnet(path: str, cfg: Optional[BiRefNetConfig] = None,
                  device="cuda") -> Tuple[Params, BiRefNetConfig]:
    """RMBG-2.0 weights (``.safetensors`` or a torch pickle) onto
    ``device``."""
    cfg = cfg or BiRefNetConfig.rmbg20()
    return convert_birefnet_torch(read_state_dict(path), cfg, device), cfg


# ------------------------------------------------------------------ remover


class BirefnetRemover:
    """Callable PIL RGB image -> PIL 'L' alpha matte: BiRefNet at the
    reference's 1024² ImageNet-normalized operating point on the
    parameters' device.  Postprocess: sigmoid, ``* 255`` truncated (no
    min-max)."""

    def __init__(self, params: Params, cfg: BiRefNetConfig):
        self.params = params
        self.cfg = cfg
        self.device = params["bb"]["patch_embed"]["proj"]["kernel"].device

    @torch.no_grad()
    def _fwd(self, x: np.ndarray) -> torch.Tensor:
        return birefnet_forward(self.params, self.cfg,
                                torch.from_numpy(x).to(self.device))

    @torch.no_grad()
    def __call__(self, image):
        rgb = image.convert("RGB")
        cfg = self.cfg
        logits = self._fwd(normalized_input(rgb, cfg.size, cfg.mean, cfg.std))
        pred = torch.sigmoid(torch.as_tensor(logits)[0, ..., 0].float())
        return matte_image(pred.cpu().numpy(), rgb.size)
