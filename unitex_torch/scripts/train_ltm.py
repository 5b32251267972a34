"""Train the LTM texture-function VAE (``models/ltm.py``) on procedural
data (port of scripts/train_ltm.py).

The data is the family the texture round trip measures: randomized
primitives (sphere, torus, trefoil, compound, cup point banks, built once
on the host) x random smooth RGB fields x contiguous occlusion holes
(``training/ltm.occlusion_split``), all drawn on the device.  The run
reports the held-out hole PSNR beside the k=8 inverse-distance fill on
the same batch, keeps the best held-out parameters and writes them with
``utils/param_cache.save_params`` (the file format both packages read,
with the model config in its meta, so ``RGBTextureFullPipeline(
ltm_params=...)`` takes it).

    python -m unitex_torch.scripts.train_ltm --out ltm_params.npz [--steps 20000]
    python -m unitex_torch.scripts.train_ltm --tiny --device cpu --out /tmp/ltm.npz

The steps run back to back on the device with no host sync between logs:
the mesh of each step is picked with ``torch.randint`` on the device's
generator.  Logs come at the first chunk's end (step ``min(log_every,
250)``, or 1 with ``--tiny``), every ``--log-every`` steps and at the
last step.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="ltm_params.npz")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--bank-meshes", type=int, default=40)
    ap.add_argument("--bank-points", type=int, default=16384)
    ap.add_argument("--n-query", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--kl-weight", type=float, default=1e-6)
    ap.add_argument("--log-every", type=int, default=500)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config + few steps (CPU smoke)")
    ap.add_argument("--config", default="large", choices=["default", "large"],
                    help="model capacity (large: about 4x, the kernel decoder)")
    ap.add_argument("--curriculum", default="default",
                    choices=["default", "r04", "affine"],
                    help="field family: default (context-inferable scales), "
                         "r04 (the flat-curve settings, for A/B), affine "
                         "(pure affine fields: a learning diagnostic)")
    ap.add_argument("--report", default=None,
                    help="write a JSON training report here")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


@torch.no_grad()
def eval_psnr(params, cfg, batch):
    """The holdout metric on a batch of the held-out mesh (a fresh field
    and holes, ``training/ltm.sample_device_batch``): PSNR over the hole
    queries only (``query_in_hole``), and the k=8 IDW fill's on the same
    batch.  Returns the two as 0-d tensors."""
    from ..models.ltm import decode_field, encode_geometry
    from ..training.ltm import idw_fill_baseline

    z, _, _ = encode_geometry(params, cfg, batch["points"], batch["colors"],
                              batch["valid"])
    pred = decode_field(params, cfg, z, batch["query_points"],
                        ctx=(batch["points"], batch["colors"], batch["valid"]))
    idw = idw_fill_baseline(batch["points"], batch["colors"], batch["valid"],
                            batch["query_points"], k=8)
    hole = batch["query_in_hole"]
    n = torch.clamp(torch.sum(hole), min=1)

    def psnr(p):
        err2 = torch.mean((p - batch["query_colors"]) ** 2, dim=-1)
        mse = torch.sum(torch.where(hole, err2, torch.zeros_like(err2))) / n
        return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))

    return psnr(pred), psnr(idw)


def main(argv: Optional[List[str]] = None) -> dict:
    """Train; returns {"state", "tx", "cfg", "tcfg", "curriculum", "bank"
    (on the device), "bank_seconds", "best_params" (CPU tensors),
    "best_step", "best_psnr", "log" (the report's entries), "elapsed" (the
    unrounded seconds of each log entry)}."""
    args = parse_args(argv)

    from ..models.ltm import LTMConfig
    from ..training.flux_lora import warmup_cosine_decay_schedule
    from ..training.ltm import (
        LTMCurriculum, LTMTrainConfig, build_point_bank, create_ltm_state,
        ltm_train_step, sample_device_batch,
    )
    from ..utils.param_cache import save_params
    from ..utils.precision import resolve_device

    dev = resolve_device(args.device)
    cur = {
        "default": LTMCurriculum(),
        "r04": LTMCurriculum.r04(),
        "affine": LTMCurriculum.affine_only(),
    }[args.curriculum]
    if args.tiny:
        cfg = LTMConfig.tiny()
        args.steps = min(args.steps, 200)
        args.bank_meshes = 4
        args.bank_points = 1024
        args.n_query = 256
        args.log_every = 50
    else:
        cfg = LTMConfig.large() if args.config == "large" else LTMConfig()
    tcfg = LTMTrainConfig(learning_rate=args.lr, kl_weight=args.kl_weight,
                          n_visible=args.bank_points, n_query=args.n_query)

    t0 = time.perf_counter()
    bank = build_point_bank(args.bank_meshes, args.bank_points, seed=0)
    bank_s = time.perf_counter() - t0
    print(f"point bank {bank.shape} built in {bank_s:.1f}s", flush=True)
    bank_dev = torch.as_tensor(bank, device=dev)
    # one mesh held out entirely for evaluation
    n_train = bank.shape[0] - 1

    # cosine decay with warmup: the cross-attention latents collapse at
    # full LR from step 0
    sched = warmup_cosine_decay_schedule(
        0.0, args.lr, min(500, args.steps // 10), args.steps, args.lr * 0.05)
    gen = torch.Generator(device=dev)
    state, tx = create_ltm_state(gen.manual_seed(0), cfg, tcfg, schedule=sched,
                                 device=dev)

    gen.manual_seed(1)
    train_bank = bank_dev[:n_train]
    losses, elapsed = [], []
    best = {"psnr": -1.0, "params": None, "step": 0}
    first_log = 1 if args.tiny else min(args.log_every, 250)
    t0 = time.perf_counter()
    loss = None
    for it in range(1, args.steps + 1):
        mi = torch.randint(0, n_train, (1,), generator=gen, device=dev)
        batch = sample_device_batch(train_bank.index_select(0, mi)[0],
                                    args.n_query, cur, generator=gen)
        state, loss = ltm_train_step(state, batch, cfg, tcfg, tx, generator=gen)
        if it % args.log_every == 0 or it == args.steps or it == first_log:
            held_out = sample_device_batch(
                bank_dev[-1], args.n_query, cur,
                generator=torch.Generator(device=dev).manual_seed(10_000 + it))
            p, p_idw = eval_psnr(state.params, cfg, held_out)
            l, p, p_idw = float(loss), float(p), float(p_idw)
            dt = time.perf_counter() - t0
            elapsed.append(dt)
            losses.append({"step": it, "loss": round(l, 6),
                           "holdout_hole_psnr_db": round(p, 2),
                           "idw_k8_hole_psnr_db": round(p_idw, 2),
                           "elapsed_s": round(dt, 1)})
            print(json.dumps(losses[-1]), flush=True)
            # keep the best holdout state: a long run must not ship a
            # checkpoint that drifted below an earlier eval point
            if p > best["psnr"]:
                best = {"psnr": p, "step": it, "params": _map_detach(state.params)}

    host_params = (best["params"] if best["params"] is not None
                   else _map_detach(state.params))
    print(f"saving best-holdout params (step {best['step']}, "
          f"{best['psnr']:.2f} dB)", flush=True)
    save_params(args.out, host_params, meta={
        "model": "ltm_texture_vae",
        "config": {k: getattr(cfg, k) for k in (
            "n_latents", "latent_dim", "n_heads", "n_self_layers",
            "n_fourier", "color_dim", "kl_latent_dim", "n_cross_layers",
            "kernel_decode", "kernel_tau")},
        "steps": args.steps,
        "best_step": best["step"],
        "curriculum": args.curriculum,
        "data": "procedural primitives x random smooth fields x "
                "occlusion holes (training/ltm.py)",
    })
    print(f"wrote {args.out}", flush=True)
    if args.report:
        with open(args.report, "w") as f:
            json.dump({
                "metric": "ltm_training",
                "steps": args.steps,
                "config": "tiny" if args.tiny else args.config,
                "curriculum": args.curriculum,
                "bank": [args.bank_meshes, args.bank_points],
                "best_step": best["step"],
                "best_holdout_hole_psnr_db": round(best["psnr"], 2),
                "log": losses,
            }, f, indent=2)
    return {"state": state, "tx": tx, "cfg": cfg, "tcfg": tcfg,
            "curriculum": cur, "bank": bank_dev, "bank_seconds": bank_s,
            "best_params": host_params, "best_step": best["step"],
            "best_psnr": best["psnr"], "log": losses, "elapsed": elapsed}


def _map_detach(tree):
    """A CPU copy of a parameter tree."""
    from ..training.flux_lora import _map

    return _map(lambda p: p.detach().cpu().clone(), tree)


if __name__ == "__main__":
    main()
