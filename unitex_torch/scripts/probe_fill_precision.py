"""What the precision of the fill's distance products does to the texture
round trip (``oracle_campaign``) on the card.

The KNN fill ranks visible texels by |q|² + |r|² - 2 q·r.  The port computes
q·r in exact f32; the JAX package's ``jnp.dot`` at a TPU's default
precision rounds q and r to bf16 first (f32 accumulation).  This probe
bakes each case twice, with the exact product and with the bf16-rounded
one, and prints the scores of both beside ORACLE_r05.json's.

    python -m unitex_torch.scripts.probe_fill_precision [--primitives cup trefoil]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from unittest import mock

import torch

from ..render import renderer_inverse
from ..utils.precision import exact_f32
from . import oracle_campaign

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KEYS = ("texture_psnr_visible", "texture_psnr_all", "rerender_psnr")


@torch.no_grad()
@exact_f32()
def knn_bf16_product(queries, references, k=1, chunk=65536, ref_valid=None):
    """``ops.knn.knn`` with q·r on bf16-rounded inputs (f32 accumulation),
    the squared norms exact: a TPU's default-precision ``jnp.dot``."""
    ref_sq = torch.sum(references * references, dim=-1)
    penalty = torch.zeros_like(ref_sq)
    if ref_valid is not None:
        penalty = torch.where(ref_valid, penalty, torch.full_like(ref_sq, float("inf")))
    refs16 = references.to(torch.bfloat16).float()
    dists, idx = [], []
    for q0 in range(0, queries.shape[0], chunk):
        q = queries[q0:q0 + chunk]
        d2 = (torch.sum(q * q, dim=-1, keepdim=True) + ref_sq[None, :]
              - 2.0 * (q.to(torch.bfloat16).float() @ refs16.T))
        d2 = torch.clamp(d2, min=0.0) + penalty[None, :]
        rows = torch.arange(d2.shape[0], device=d2.device)
        dk, ik = [], []
        for j in range(min(k, references.shape[0])):
            best = torch.argmin(d2, dim=1)
            dk.append(d2[rows, best])
            ik.append(best)
            d2[rows, best] = float("inf")
        dists.append(torch.stack(dk, 1))
        idx.append(torch.stack(ik, 1))
    return torch.sqrt(torch.clamp(torch.cat(dists), min=0.0)), torch.cat(idx)


def _recorded(primitive: str, setting: dict) -> dict:
    with open(os.path.join(REPO, "ORACLE_r05.json")) as f:
        for case in json.load(f)["cases"]:
            if (case["primitive"] == primitive and "fill" not in case
                    and case["fill_k"] == setting["fill_k"]):
                return case
    return {}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--primitives", nargs="+", default=["cup", "trefoil"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--view-size", type=int, default=512)
    ap.add_argument("--uv-size", type=int, default=2048)
    args = ap.parse_args(argv)
    for prim in args.primitives:
        scene = oracle_campaign.prepare_case(prim, args.view_size, args.uv_size,
                                             args.device)
        for name in ("priority_k1", "cosine_k8_relax"):
            setting = oracle_campaign.SETTINGS[name]
            ref = _recorded(prim, setting)
            for product in ("f32", "bf16"):
                patch = (mock.patch.object(renderer_inverse, "knn", knn_bf16_product)
                         if product == "bf16" else contextlib.nullcontext())
                with patch:
                    case = oracle_campaign.run_case(prim, args.view_size,
                                                    args.uv_size,
                                                    device=args.device,
                                                    scene=scene, **setting)
                print(f"[fill_precision] {prim} {name} q·r {product}: "
                      + ", ".join(f"{k} {case[k]} (JAX {ref.get(k)})" for k in KEYS)
                      + f"; bake {case['bake_s']:.3f}s", flush=True)


if __name__ == "__main__":
    main()
