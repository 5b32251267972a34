"""TSD-SR training launcher (port of scripts/train_tsdsr.py): target score
distillation of a one-step SD3 SR student against a frozen CFG teacher
with a learned regularizer; ``training/tsdsr.py`` holds the math, this
script the data, the VAE encodes and the checkpoints.

    python -m unitex_torch.scripts.train_tsdsr --lr-dir LR/ --hr-dir HR/ \
        --pretrain /ckpts --steps 10000 --output-dir runs/tsd
    python -m unitex_torch.scripts.train_tsdsr --lr-dir LR/ --hr-dir HR/ \
        --tiny --cpu --steps 2 --output-dir /tmp/tsd

It runs on the card unless ``--cpu`` is given.  ``--pretrain`` names a
checkpoint root with ``sd3/{transformer,vae}``, read by the port's
``TSDSRPipeline``; ``--tiny`` makes seeded tiny SD3 and VAE trees
instead.  The LR image is upscaled to the HR size with MATLAB's bicubic
(``image/matlab.imresize``) before its VAE encode, as the serving
pipeline feeds the student at the target resolution.  The prompt
embeddings come from ``--prompt-embeds`` (an .npz with prompt_embeds and
pooled_embeds, optionally their _null variants) or are zeros of
[1, 154, joint_attention_dim] and [1, pooled_projection_dim].  Metrics go
to ``<output-dir>/train.jsonl``, the adapters to
``<output-dir>/checkpoints/checkpoint-<step>/state.pt``.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr-dir", required=True)
    ap.add_argument("--hr-dir", required=True)
    ap.add_argument("--pretrain", default=None,
                    help="checkpoint root with sd3/ (transformer + vae)")
    ap.add_argument("--prompt-embeds", default=None, help=".npz path")
    ap.add_argument("--tiny", action="store_true",
                    help="random tiny SD3 + VAE (smoke runs, no weights)")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--gt-size", type=int, default=None,
                    help="HR crop (multiple of 8 * patch); default: full")
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--reg-lr", type=float, default=1e-5)
    ap.add_argument("--output-dir", default="tsdsr_run")
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def _models(args, dev):
    """(SD3 config, base tree, VAE config, VAE tree)."""
    from ..models.flux.vae import VAEConfig, init_vae_params
    from ..models.sd3.config import SD3Config

    if args.tiny:
        from ..models.sd3.model import init_sd3_params

        gen = torch.Generator(device=dev)
        cfg, vae_cfg = SD3Config.tiny(), VAEConfig.tiny()
        return (cfg, init_sd3_params(gen.manual_seed(args.seed), cfg, dev),
                vae_cfg, init_vae_params(gen.manual_seed(args.seed + 1),
                                         vae_cfg, device=dev))
    if not args.pretrain:
        raise SystemExit("--pretrain required (or pass --tiny)")
    from ..models.sd3.sr_pipeline import TSDSRPipeline

    pipe = TSDSRPipeline(pretrain_root=args.pretrain, device=dev)
    if pipe.transformer_params is None or pipe.vae_params is None:
        raise SystemExit(f"no sd3 checkpoints under {args.pretrain}")
    return pipe.sd3_cfg, pipe.transformer_params, pipe.vae_cfg, pipe.vae_params


def _prompts(args, cfg, dev):
    """(prompt, pooled, prompt_null, pooled_null), each with a batch of 1."""
    if args.prompt_embeds:
        pe = np.load(args.prompt_embeds)
        prompt = torch.as_tensor(pe["prompt_embeds"], dtype=torch.float32)
        pooled = torch.as_tensor(pe["pooled_embeds"], dtype=torch.float32)
        prompt_null = (torch.as_tensor(pe["prompt_embeds_null"])
                       if "prompt_embeds_null" in pe else prompt * 0)
        pooled_null = (torch.as_tensor(pe["pooled_embeds_null"])
                       if "pooled_embeds_null" in pe else pooled * 0)
    else:
        prompt = torch.zeros((1, 154, cfg.joint_attention_dim))
        pooled = torch.zeros((1, cfg.pooled_projection_dim))
        prompt_null, pooled_null = prompt, pooled
    return tuple(x.float().to(dev)
                 for x in (prompt, pooled, prompt_null, pooled_null))


def main(argv: Optional[List[str]] = None,
         on_step: Optional[Callable] = None):
    """Train; ``on_step(it, state, metrics)`` is called after each step
    (a caller's hook for its own checks).  Returns the final
    ``TSDTrainState``."""
    args = parse_args(argv)
    from ..image.matlab import imresize
    from ..models.flux.vae import vae_encode
    from ..training import sr_data as sd
    from ..training.checkpoint import CheckpointManager
    from ..training.tsdsr import TSDTrainConfig, create_tsd_state, tsd_train_step
    from ..utils.logging import MetricLogger
    from ..utils.precision import resolve_device
    from ..utils.timer import CPUTimer

    dev = resolve_device("cpu" if args.cpu else "cuda")
    rng = np.random.default_rng(args.seed)
    cfg, base_params, vae_cfg, vae_params = _models(args, dev)

    tcfg = TSDTrainConfig(rank=args.rank, learning_rate=args.lr,
                          reg_learning_rate=args.reg_lr)
    state, tx_s, tx_r = create_tsd_state(
        torch.Generator(device=dev).manual_seed(args.seed + 2), base_params,
        tcfg, device=dev)

    ds = sd.PairedImageDataset(sd.PairedImageConfig(
        lq_folder=args.lr_dir, gt_folder=args.hr_dir, scale=args.scale,
        phase="train" if args.gt_size else "val",
        gt_size=args.gt_size or 0, seed=args.seed))
    print(f"{len(ds)} training pairs", flush=True)
    prompt, pooled, prompt_null, pooled_null = _prompts(args, cfg, dev)

    logger = MetricLogger(args.output_dir)
    ckpt = CheckpointManager(os.path.join(args.output_dir, "checkpoints"),
                             save_every=args.save_every)

    def encode(img):  # [B, H, W, 3] in [0, 1] -> latents
        return vae_encode(vae_params, vae_cfg, img * 2.0 - 1.0)

    def adapters():
        return {"student_lora": state.student_lora, "reg_lora": state.reg_lora}

    it = 0
    while it < args.steps:
        for batch_d in sd.batch_iterator(ds, args.batch, rng):
            with CPUTimer("tsd_vae_encode", verbose=False):
                hr = torch.from_numpy(batch_d["gt"]).to(dev)
                lq = torch.from_numpy(batch_d["lq"]).to(dev)
                lr_up = imresize(lq, hr.shape[1] / lq.shape[1])
                B = hr.shape[0]
                batch = {
                    "latent_lr": encode(lr_up.clamp(0, 1)),
                    "latent_hr": encode(hr),
                    "prompt_embeds": prompt.expand(B, -1, -1),
                    "pooled_embeds": pooled.expand(B, -1),
                    "prompt_embeds_null": prompt_null.expand(B, -1, -1),
                    "pooled_embeds_null": pooled_null.expand(B, -1),
                }
            gen = torch.Generator(device=dev).manual_seed(
                args.seed + 1 + 1_000_003 * it)
            state, metrics = tsd_train_step(state, base_params, cfg, tcfg,
                                            batch, tx_s, tx_r, generator=gen)
            it += 1
            if on_step is not None:
                on_step(it, state, metrics)
            if it % args.log_every == 0 or it == args.steps:
                logger.log(it, metrics)
                msg = ", ".join(f"{k}={float(v):.4g}"
                                for k, v in metrics.items())
                print(f"step {it}/{args.steps}  {msg}", flush=True)
            if ckpt.should_save(it):
                ckpt.save(it, adapters())
            if it >= args.steps:
                break
        else:
            if len(ds) < args.batch:
                raise SystemExit(f"{len(ds)} training pairs make no batch of "
                                 f"{args.batch}")
    ckpt.save(args.steps, adapters())
    logger.close()
    print("training done", flush=True)
    return state


if __name__ == "__main__":
    main()
