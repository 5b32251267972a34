"""Product entry point of the PyTorch port, the counterpart of the root
``run.py``: one image + one mesh -> a textured GLB (and by default its
orbit video).

    python -m unitex_torch.run --image ref.png --mesh model.obj \\
        --pretrain-models <root> [--out output] [--fast-steps 8] [--int8] \\
        [--super-resolution]

It takes the root ``run.py``'s flags with the same defaults, and
``--device`` (default ``cuda``; ``cpu`` runs it without a card).
``--super-resolution`` adds the TSD-SR x4 stage before the bake: SD3-medium
and its VAE from ``<root>/sd3/{transformer,vae}`` (and the prompt
embedding ``<root>/tsdsr/prompt_embeds.npz`` if present), or without them
the bicubic x4 upscale; the bake then reads 2048² views.

Under ``torchrun --nproc-per-node N`` (``WORLD_SIZE`` > 1) the same
command serves one job across the N processes, one GPU each (NCCL; gloo
with ``--device cpu``): FLUX and the SR stage tensor-parallel (with
``--int8`` / ``--int8-max-memory`` on the ranks' int8 slices), rank 0
doing the host work and writing the outputs (``pipeline.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import torch.distributed as dist

from .config import DEFAULT_CONFIG
from .pipeline import CustomRGBTextureFullPipeline


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="UniTEX texture generation "
                                             "(PyTorch/CUDA)")
    ap.add_argument("--image", required=True, help="reference RGB image")
    ap.add_argument("--mesh", required=True, help="untextured mesh (obj/ply/glb)")
    ap.add_argument("--out", default="output", help="output directory")
    ap.add_argument("--pretrain-models", default=None,
                    help="checkpoint root (flux/{transformer,vae} + LoRAs)")
    ap.add_argument("--seed", type=int, default=63)
    ap.add_argument("--super-resolution", action="store_true",
                    help="TSD-SR x4 super-resolution of the views (SD3 "
                         "weights from <root>/sd3, else bicubic)")
    # the 120-frame orbit video is written by default, as by the reference
    ap.add_argument("--export-video", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--int8", dest="int8", action="store_const", const=True,
                    default=False, help="W8A8 int8 serving")
    ap.add_argument("--int8-max-memory", dest="int8",
                    action="store_const", const="max_memory",
                    help="int8 + weight-only int8 for the other block kernels")
    ap.add_argument("--fast-steps", type=int, default=0,
                    help="denoise steps served by velocity extrapolation "
                         "instead of a transformer evaluation (training-"
                         "free speedup; 0 = the exact 28-step schedule)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs without a card)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    config = DEFAULT_CONFIG
    if args.fast_steps:
        config = dataclasses.replace(
            config, diffusion=dataclasses.replace(
                config.diffusion, velocity_reuse=args.fast_steps))
    pipeline = CustomRGBTextureFullPipeline(
        pretrain_models=args.pretrain_models,
        super_resolutions=args.super_resolution,
        seed=args.seed,
        int8_serving=args.int8,
        config=config,
        device=args.device,
    )
    rembg_png, textured_glb = pipeline(
        args.out, args.image, args.mesh, export_video=args.export_video)
    if dist.is_initialized():   # a multi-rank job's group (torchrun)
        dist.destroy_process_group()
    if textured_glb is not None:  # rank 0's (the only rank of one process)
        print(f"wrote {rembg_png}\nwrote {textured_glb}")


if __name__ == "__main__":
    main()
