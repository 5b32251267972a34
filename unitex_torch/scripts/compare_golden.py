"""Golden-output comparison with the PyTorch port (the counterpart of the
root ``scripts/compare_golden.py``): score every common image artifact of
two pipeline cache directories by PSNR and SSIM and print a JSON report.

    python -m unitex_torch.scripts.compare_golden ours/cache golden/cache
        [--min-psnr 35] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

COMPARED = (
    "rembg_image.png",
    "processed_image.png",
    "mv_alpha.png",
    "mv_ccm.png",
    "mv_normal.png",
    "mv_rgb_w_light.png",
    "mv_rgb.png",
    # with super-resolution mv_rgb.png is the TSD-SR output and
    # mv_rgb_lr.png the grid before it: both are scored, so SR parity and
    # diffusion parity are told apart; absent files report null
    "mv_rgb_lr.png",
    "visable_uv_mask.png",
    "valid_uv_mask.png",
    "completed_uv.png",
)


def compare_caches(ours: str, golden: str, device="cuda") -> dict:
    """PSNR and SSIM (on ``device``) of every artifact of ``COMPARED``
    present in both directories -> ``{"artifacts": {...}, "worst_psnr":
    float}``, the report the CLI prints.  Equal images score the PSNR
    cap, 120 dB (the mean squared error is floored at 1e-12)."""
    import torch

    from ..utils.image_io import load_image
    from ..utils.metrics import psnr, ssim
    from ..utils.precision import resolve_device

    device = resolve_device(device)
    report = {}
    worst = float("inf")
    for name in COMPARED:
        a_path, b_path = os.path.join(ours, name), os.path.join(golden, name)
        if not (os.path.exists(a_path) and os.path.exists(b_path)):
            report[name] = None
            continue
        a, b = load_image(a_path), load_image(b_path)
        if a.shape != b.shape:
            report[name] = {"error": f"shape {a.shape} vs {b.shape}"}
            worst = min(worst, 0.0)
            continue
        ta = torch.from_numpy(a).to(device)
        tb = torch.from_numpy(b).to(device)
        p = float(psnr(ta, tb))
        s = float(ssim(ta, tb)) if min(a.shape[:2]) >= 11 else None
        report[name] = {"psnr": round(p, 2), "ssim": round(s, 4) if s else None}
        worst = min(worst, p)
    return {"artifacts": report, "worst_psnr": round(worst, 2)}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ours")
    ap.add_argument("golden")
    ap.add_argument("--min-psnr", type=float, default=None,
                    help="exit nonzero if any artifact scores below this")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs without a card)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    report = compare_caches(args.ours, args.golden, args.device)
    print(json.dumps(report, indent=2))
    if args.min_psnr is not None and report["worst_psnr"] < args.min_psnr:
        sys.exit(1)
    return report


if __name__ == "__main__":
    main()
