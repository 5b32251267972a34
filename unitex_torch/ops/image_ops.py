"""Image-space morphology, blurs and pull-push hole filling in PyTorch
(port of the parts of unitex_tpu/ops/image_ops.py on the bake path).

All ops take channels-last images [..., H, W, C] (masks [..., H, W, 1]
bool), as in the JAX package.  Window reductions pad with the reduction's
identity (SAME), box sums with zeros, the gaussian blur with reflection,
the lens blur with zeros.  The f32 convolutions are exact (no TF32).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.precision import exact_f32


def _as_nchw1(x: torch.Tensor):
    """[..., H, W] -> ([N, 1, H, W], lead shape)."""
    lead = x.shape[:-2]
    return x.reshape(-1, 1, *x.shape[-2:]), lead


def _pool(x: torch.Tensor, k: int, op: str) -> torch.Tensor:
    """Same-padded k x k window max/min over the H, W axes of a
    channels-last [..., H, W, C] image (padded with the reduction's
    identity, -inf for max and +inf for min)."""
    lead = x.shape[:-3]
    y = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
    if op == "min":
        y = -y
    pad = k // 2
    y = F.max_pool2d(F.pad(y, (pad, pad, pad, pad), value=-float("inf")),
                     k, stride=1)
    if op == "min":
        y = -y
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[-2:], y.shape[1])


def max_pool2d(x: torch.Tensor, k: int) -> torch.Tensor:
    return _pool(x, k, "max")


def min_pool2d(x: torch.Tensor, k: int) -> torch.Tensor:
    return _pool(x, k, "min")


def _pool_mask(mask: torch.Tensor, k: int, op: str) -> torch.Tensor:
    """k x k window max/min of a [..., H, W, 1] bool mask -> bool."""
    x, lead = _as_nchw1(mask[..., 0].float())
    pad = k // 2
    if op == "max":
        y = F.max_pool2d(F.pad(x, (pad, pad, pad, pad), value=-float("inf")),
                         k, stride=1)
    else:
        y = -F.max_pool2d(F.pad(-x, (pad, pad, pad, pad), value=-float("inf")),
                          k, stride=1)
    return (y > 0.0).reshape(*lead, *y.shape[-2:])[..., None]


def dilate_mask(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Binary dilation of a [..., H, W, 1] bool mask."""
    return _pool_mask(mask, k, "max")


def erode_mask(mask: torch.Tensor, k: int) -> torch.Tensor:
    return _pool_mask(mask, k, "min")


def boundary_mask(mask: torch.Tensor, k: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inner, outer) boundary rings of a bool mask."""
    inner = mask & ~erode_mask(mask, k)
    outer = dilate_mask(mask, k) & ~mask
    return inner, outer


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-padded SAME k x k box sum over the last two axes (k odd), as two
    separable 1-D sums."""
    if k <= 1:
        return x
    if k % 2 != 1:
        raise ValueError(f"_box_sum requires an odd kernel, got {k}")
    y, lead = _as_nchw1(x)
    pad = k // 2
    y = F.avg_pool2d(F.pad(y, (0, 0, pad, pad)), (k, 1), stride=1,
                     divisor_override=1)
    y = F.avg_pool2d(F.pad(y, (pad, pad, 0, 0)), (1, k), stride=1,
                     divisor_override=1)
    return y.reshape(*lead, *y.shape[-2:])


def ring_close_mask(mask: torch.Tensor, ks: Tuple[int, ...] = (3, 5)) -> torch.Tensor:
    """Close pin-holes in a visibility mask: a pixel is switched on when the
    k x k ring around it is (almost) fully on.  The ring conv (k² on the
    border, -1 inside, threshold ((k-1)²-1)·(k-2)²) decomposes exactly into
    box sums: conv = k²·box_k - (k²+1)·box_{k-2} (integer-exact in f32)."""
    m = mask
    for k in ks:
        x = m[..., 0].float()
        conv = (k * k) * _box_sum(x, k) - (k * k + 1.0) * _box_sum(x, k - 2)
        thresh = ((k - 1) ** 2 - 1) * ((k - 2) ** 2)
        m = m | (conv >= thresh)[..., None]
    return m


def _gauss_kernel(k: int, sigma: float | None = None) -> np.ndarray:
    if sigma is None:
        sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8  # OpenCV default
    x = np.arange(k, dtype=np.float64) - (k - 1) / 2.0
    w = np.exp(-(x**2) / (2 * sigma**2))
    return (w / w.sum()).astype(np.float32)


def _depthwise(x: torch.Tensor, k1d: torch.Tensor, axis: str, padding) -> torch.Tensor:
    """Depthwise 1-D conv of [N, C, H, W] along H or W (cross-correlation,
    as lax.conv)."""
    C = x.shape[1]
    K = k1d.shape[0]
    w = k1d.reshape(1, 1, K, 1) if axis == "h" else k1d.reshape(1, 1, 1, K)
    return F.conv2d(x, w.expand(C, 1, *w.shape[2:]).contiguous(),
                    padding=padding, groups=C)


@exact_f32()
def gaussian_blur(img: torch.Tensor, k: int = 5, sigma: float | None = None) -> torch.Tensor:
    """Separable gaussian blur of [..., H, W, C] with reflect padding."""
    kern = torch.from_numpy(_gauss_kernel(k, sigma)).to(img.device)
    lead = img.shape[:-3]
    x = img.reshape(-1, *img.shape[-3:]).permute(0, 3, 1, 2)
    pad = k // 2
    x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    x = _depthwise(_depthwise(x, kern, "h", 0), kern, "w", 0)
    return x.permute(0, 2, 3, 1).reshape(*lead, *x.shape[2:], x.shape[1])


@exact_f32()
def disk_blur(img: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Uniform disk ("bokeh") blur of [..., H, W, C] with reflect padding:
    the mean over the pixels within ``radius``."""
    k = 2 * radius + 1
    yy, xx = np.mgrid[-radius: radius + 1, -radius: radius + 1]
    kern = ((yy ** 2 + xx ** 2) <= radius ** 2).astype(np.float64)
    kern = torch.from_numpy((kern / kern.sum()).astype(np.float32)).to(img.device)
    lead, C = img.shape[:-3], img.shape[-1]
    x = img.reshape(-1, *img.shape[-3:]).permute(0, 3, 1, 2)
    x = F.pad(x, (radius, radius, radius, radius), mode="reflect")
    x = F.conv2d(x, kern.reshape(1, 1, k, k).expand(C, 1, k, k).contiguous(),
                 groups=C)
    return x.permute(0, 2, 3, 1).reshape(*lead, *x.shape[2:], C)


def pull_push(color: torch.Tensor, mask: torch.Tensor, levels: int = 0) -> torch.Tensor:
    """Mip-pyramid pull-push hole filling: average-downsample valid-weighted
    color to the top of the pyramid, then upsample back filling only
    invalid texels.  color [H, W, C], mask [H, W, 1] bool; H, W powers of
    two."""
    H = color.shape[0]
    if levels <= 0:
        levels = max(1, int(np.log2(H)))
    w = mask.to(color.dtype)
    c = color * w
    pyramid = [(c, w)]
    for _ in range(levels):
        c = 0.25 * (c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2] + c[1::2, 1::2])
        w = 0.25 * (w[0::2, 0::2] + w[1::2, 0::2] + w[0::2, 1::2] + w[1::2, 1::2])
        pyramid.append((c, w))
    c_up, w_up = pyramid[-1]
    for lvl in range(levels - 1, -1, -1):
        c_cur, w_cur = pyramid[lvl]
        c_big = c_up.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        w_big = w_up.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        w_clamped = torch.clamp(w_cur, max=1.0)
        c_norm = torch.where(w_big > 1e-8, c_big / torch.clamp(w_big, min=1e-8),
                             torch.zeros_like(c_big))
        c_up = c_cur + (1.0 - w_clamped) * c_norm * torch.clamp(w_big, max=1.0)
        w_up = w_cur + (1.0 - w_clamped) * torch.clamp(w_big, max=1.0)
    out = torch.where(w_up > 1e-8, c_up / torch.clamp(w_up, min=1e-8),
                      torch.zeros_like(c_up))
    return torch.where(mask, color, out)


# ------------------------------------------------------- lens (bokeh) blur

# Complex-Gaussian bokeh approximation constants (Olli Niemitalo,
# "Circularly symmetric convolution and lens blur"): per component count,
# (a, b, A, B) components plus a radius-calibration scale.
_LENS_SCALES = (1.4, 1.2, 1.2, 1.2, 1.2, 1.2)
_LENS_PARAMS = (
    ((0.862325, 1.624835, 0.767583, 1.862321),),
    ((0.886528, 5.268909, 0.411259, -0.548794),
     (1.960518, 1.558213, 0.513282, 4.56111)),
    ((2.17649, 5.043495, 1.621035, -2.105439),
     (1.019306, 9.027613, -0.28086, -0.162882),
     (2.81511, 1.597273, -0.366471, 10.300301)),
    ((4.338459, 1.553635, -5.767909, 46.164397),
     (3.839993, 4.693183, 9.795391, -15.227561),
     (2.791880, 8.178137, -3.048324, 0.302959),
     (1.342190, 12.328289, 0.010001, 0.244650)),
    ((4.892608, 1.685979, -22.356787, 85.91246),
     (4.71187, 4.998496, 35.918936, -28.875618),
     (4.052795, 8.244168, -13.212253, -1.578428),
     (2.929212, 11.900859, 0.507991, 1.816328),
     (1.512961, 16.116382, 0.138051, -0.01)),
    ((5.143778, 2.079813, -82.326596, 111.231024),
     (5.612426, 6.153387, 113.878661, 58.004879),
     (5.982921, 9.802895, 39.479083, -162.028887),
     (6.505167, 11.059237, -71.286026, 95.027069),
     (3.869579, 14.81052, 1.405746, -3.704914),
     (2.201904, 19.032909, -0.152784, -0.107988)),
)


def _lens_kernels(radius: float, components: int):
    """1-D complex kernel halves (re, im, A, B), jointly normalized so the
    2-D weighted combination integrates to 1 (closed form
    A(Sr² - Si²) + 2B·Sr·Si with Sr/Si the kernel sums)."""
    idx = max(0, min(components - 1, len(_LENS_PARAMS) - 1))
    params = _LENS_PARAMS[idx]
    scale = _LENS_SCALES[idx]
    kr = int(np.ceil(radius))
    ax = np.linspace(-radius, radius, 2 * kr + 1, dtype=np.float64)
    ax = ax * scale / radius
    kernels = []
    total = 0.0
    for (a, b, A, B) in params:
        e = np.exp(-a * ax**2)
        re = e * np.cos(b * ax**2)
        im = e * np.sin(b * ax**2)
        sr, si = re.sum(), im.sum()
        total += A * (sr * sr - si * si) + B * (2.0 * sr * si)
        kernels.append((re, im, A, B))
    norm = float(np.sqrt(total))
    return [((re / norm).astype(np.float32), (im / norm).astype(np.float32), A, B)
            for (re, im, A, B) in kernels], kr


@exact_f32()
def lens_blur(
    img: torch.Tensor,
    radius: float = 3.0,
    components: int = 5,
    exposure_gamma: float = 5.0,
) -> torch.Tensor:
    """Complex-kernel lens (bokeh) blur: exposure boost by ``pow(gamma)``,
    per component a separable complex convolution with Re/Im
    cross-combination, weighted sum A·Re + B·Im, inverse exposure, clamp.
    Zero SAME padding.  img: [..., H, W, C] float in [0, 1]."""
    lead = img.shape[:-3]
    x = img.reshape(-1, *img.shape[-3:]).float().permute(0, 3, 1, 2)
    x = torch.pow(torch.clamp(x, min=0.0), exposure_gamma)
    kernels, kr = _lens_kernels(radius, components)
    out = torch.zeros_like(x)
    for re, im, A, B in kernels:
        re_t = torch.from_numpy(re).to(x.device)
        im_t = torch.from_numpy(im).to(x.device)
        ir = _depthwise(x, re_t, "w", (0, kr))
        ii = _depthwise(x, im_t, "w", (0, kr))
        real2 = _depthwise(ir, re_t, "h", (kr, 0)) - _depthwise(ii, im_t, "h", (kr, 0))
        imag2 = _depthwise(ir, im_t, "h", (kr, 0)) + _depthwise(ii, re_t, "h", (kr, 0))
        out = out + A * real2 + B * imag2
    out = torch.pow(torch.clamp(out, min=0.0), 1.0 / exposure_gamma)
    out = torch.clamp(out, 0.0, 1.0).permute(0, 2, 3, 1)
    return out.reshape(*lead, *out.shape[1:])


@torch.no_grad()
@exact_f32()
def uv_dilation(
    color: torch.Tensor,
    mask: torch.Tensor,
    max_iters: int = -1,
    kernel_size: int = 3,
) -> torch.Tensor:
    """Iterative masked-neighbour UV dilation: invalid texels repeatedly
    take the mean of their valid k x k neighbourhood until the map is full
    (or ``max_iters`` passes; -1 runs until full, at most H + W passes),
    then the grown region is blended over the original.  color [H, W, C]
    in [0, 1]; mask [H, W, 1] bool, True = valid.  Whether a hole is left
    is read on the host after each pass."""
    k = 2 * (kernel_size // 2) + 1
    H, W, _ = color.shape
    valid = mask.to(torch.float32)
    col = color * valid
    limit = max_iters if max_iters > 0 else H + W

    def box_avg(x):
        # zero-padded SAME k x k mean, as reduce_window's sum / k²
        y = x.permute(2, 0, 1)[None]
        y = F.avg_pool2d(y, k, stride=1, padding=k // 2, count_include_pad=True)
        return y[0].permute(1, 2, 0)

    for _ in range(limit):
        if float(valid.min()) != 0.0:
            break
        vavg = box_avg(valid)
        cavg = box_avg(col)
        boundary = torch.abs(vavg - valid) > 0.0
        col = torch.where(boundary, cavg / torch.clamp(vavg, min=1e-20), col)
        valid = (vavg > 0.0).to(torch.float32)
    return torch.clamp(valid * col + (1.0 - valid) * color, 0.0, 1.0)
