"""Image quality metrics: PSNR, SSIM, BasicSR's calculate_psnr /
calculate_ssim and the Fréchet distance (port of unitex_tpu/utils/metrics.py).

``psnr`` and ``ssim`` take tensors (or arrays) on any device and return a
0-d tensor there; the BasicSR helpers and the Fréchet statistics return
Python floats, as in the JAX package.  SSIM is the 11 x 11 Gaussian window
(σ = 1.5) over valid positions, per channel, averaged.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .precision import exact_f32


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
    eps: float = 1e-6,
) -> float:
    """Fréchet distance between two Gaussians, the FID statistic:
    ||mu1 - mu2||² + tr(S1 + S2 - 2 sqrt(S1 S2)), the square root by an
    eigendecomposition with a jitter retry."""
    mu1 = np.atleast_1d(mu1).astype(np.float64)
    mu2 = np.atleast_1d(mu2).astype(np.float64)
    sigma1 = np.atleast_2d(sigma1).astype(np.float64)
    sigma2 = np.atleast_2d(sigma2).astype(np.float64)
    diff = mu1 - mu2
    w, v = np.linalg.eig(sigma1 @ sigma2)
    if not np.isfinite(w).all() or (w.real < -eps).any():
        offset = np.eye(sigma1.shape[0]) * eps
        w, v = np.linalg.eig((sigma1 + offset) @ (sigma2 + offset))
    covmean = (v * np.sqrt(np.maximum(w.real, 0.0) + 0j)) @ np.linalg.inv(v)
    tr_covmean = float(np.trace(covmean).real)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


def activation_statistics(feats):
    """[N, D] activations -> (mu, sigma) for :func:`frechet_distance`."""
    if torch.is_tensor(feats):
        feats = feats.detach().cpu().numpy()
    feats = np.asarray(feats, np.float64)
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).float()


def psnr(a, b, data_range: float = 1.0) -> torch.Tensor:
    a = _f32(a)
    mse = torch.mean((a - _f32(b).to(a.device)) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


@exact_f32()
def ssim(a, b, data_range: float = 1.0, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over an [H, W, C] pair."""
    a = _f32(a)
    b = _f32(b).to(a.device)
    C = a.shape[-1]
    k = torch.from_numpy(_gaussian_kernel()).to(a.device)
    w = k[None, None].expand(C, 1, *k.shape).contiguous()

    def filt(x):
        return F.conv2d(x.permute(2, 0, 1)[None], w, groups=C)[0]

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_a, mu_b = filt(a), filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_aa = filt(a * a) - mu_aa
    sigma_bb = filt(b * b) - mu_bb
    sigma_ab = filt(a * b) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * sigma_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (sigma_aa + sigma_bb + c2))
    return s.mean()


def _to_y_channel(img: torch.Tensor, bgr: bool) -> torch.Tensor:
    """[0, 255] image -> [0, 255] Y (MATLAB's convention; BasicSR's images
    are BGR, as cv2 reads them)."""
    from ..image.matlab import bgr2ycbcr, rgb2ycbcr

    f = bgr2ycbcr if bgr else rgb2ycbcr
    return f(img / 255.0, y_only=True) * 255.0


def _basicsr_pair(img, img2, crop_border: int, test_y_channel: bool, bgr: bool):
    img, img2 = _f32(img), _f32(img2)
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border]
    if test_y_channel:
        img, img2 = _to_y_channel(img, bgr), _to_y_channel(img2, bgr)
    return img, img2


def calculate_psnr(img, img2, crop_border: int = 0,
                   test_y_channel: bool = False, bgr: bool = True) -> float:
    """BasicSR-convention PSNR: [0, 255]-range HWC images, an optional
    border crop and MATLAB-Y-channel scoring; inf for equal images."""
    img, img2 = _basicsr_pair(img, img2, crop_border, test_y_channel, bgr)
    if float(torch.mean((img - img2) ** 2)) == 0.0:
        return float("inf")
    return float(psnr(img, img2, data_range=255.0))


def calculate_ssim(img, img2, crop_border: int = 0,
                   test_y_channel: bool = False, bgr: bool = True) -> float:
    """BasicSR-convention SSIM: per-channel 11 x 11 Gaussian SSIM on the
    [0, 255] scale, channel-averaged."""
    img, img2 = _basicsr_pair(img, img2, crop_border, test_y_channel, bgr)
    return float(ssim(img, img2, data_range=255.0))
