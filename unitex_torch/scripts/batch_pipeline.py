"""Batch texture generation with the PyTorch port (the counterpart of the
root ``scripts/batch_pipeline.py``).

    python -m unitex_torch.scripts.batch_pipeline <jobs> --out batch_out \\
        [--pretrain-models <root>] [--device cuda]

Loads the models once and runs a queue of (image, mesh) jobs: a directory
of ``<name>.png`` + ``<name>.{glb,obj,ply}`` pairs, or a JSONL manifest of
``{"name":..., "image":..., "mesh":...}`` lines.  A worker thread runs job
N+1's host preprocessing while the main thread drives job N on the device,
and (without ``--sync-io``) the pipeline's writer thread writes each GLB
behind the next job's device work.  With ``--super-resolution`` and
``--sr-window k`` > 1, ``k`` jobs are denoised first, their grids
super-resolved inside one ``sr_pipeline.staged()`` window, then baked.
``manifest.json`` in ``--out`` lists each job's GLB and seconds, or its
error.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

MESH_EXTS = (".glb", ".obj", ".ply")


def discover_jobs(path):
    if path.endswith(".jsonl"):
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    jobs = []
    for img in sorted(glob.glob(os.path.join(path, "*.png"))):
        name = os.path.splitext(os.path.basename(img))[0]
        for ext in MESH_EXTS:
            mesh = os.path.join(path, name + ext)
            if os.path.exists(mesh):
                jobs.append({"name": name, "image": img, "mesh": mesh})
                break
    return jobs


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("jobs", help="job directory or JSONL manifest")
    ap.add_argument("--out", default="batch_out")
    ap.add_argument("--pretrain-models", default=None)
    ap.add_argument("--seed", type=int, default=63)
    ap.add_argument("--super-resolution", action="store_true")
    ap.add_argument("--sr-window", type=int, default=1,
                    help="jobs per SD3 staging window when the SR stage "
                         "keeps its weights on the host: denoise the "
                         "window, stage SD3 once, super-resolve every "
                         "grid, then bake all")
    ap.add_argument("--keep-going", action="store_true",
                    help="continue past per-job failures")
    ap.add_argument("--no-artifacts", action="store_true",
                    help="skip the intermediate PNGs")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="no host-preprocess worker thread")
    ap.add_argument("--sync-io", action="store_true",
                    help="write each job's GLB before starting the next "
                         "(default: the writer thread overlaps it with the "
                         "next job's device work)")
    ap.add_argument("--int8", dest="int8", action="store_const", const=True,
                    default=False, help="W8A8 int8 serving")
    ap.add_argument("--int8-max-memory", dest="int8",
                    action="store_const", const="max_memory",
                    help="int8 + weight-only int8 for the other block kernels")
    ap.add_argument("--small", action="store_true",
                    help="reduced resolutions (smoke tests, CPU)")
    ap.add_argument("--fast-steps", type=int, default=0,
                    help="denoise steps served by velocity extrapolation "
                         "instead of a transformer evaluation (0 = the "
                         "exact schedule)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs without a card)")
    return ap.parse_args(argv)


def build_config(small: bool, fast_steps: int = 0):
    """``--small``'s reduced resolutions and ``--fast-steps``, or None for
    the pipeline's default."""
    from unitex_torch.config import (
        DEFAULT_CONFIG, BakeConfig, CameraConfig, MeshConfig, PipelineConfig,
    )

    config = None
    if small:
        config = PipelineConfig(
            camera=CameraConfig(view_size=64),
            mesh=MeshConfig(min_faces=500, max_faces=4000, uv_size=256),
            bake=BakeConfig(uv_size=256),
        )
    if fast_steps:
        base = config if config is not None else DEFAULT_CONFIG
        config = dataclasses.replace(base, diffusion=dataclasses.replace(
            base.diffusion, velocity_reuse=fast_steps))
    return config


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    from unitex_torch.pipeline import CustomRGBTextureFullPipeline

    jobs = discover_jobs(args.jobs)
    if not jobs:
        print("no jobs found")
        return
    print(f"{len(jobs)} jobs")
    config = build_config(args.small, args.fast_steps)
    kwargs = {"config": config} if config is not None else {}
    pipe = CustomRGBTextureFullPipeline(
        pretrain_models=args.pretrain_models,
        super_resolutions=args.super_resolution,
        seed=args.seed,
        save_artifacts=not args.no_artifacts,
        int8_serving=args.int8,
        async_io=not args.sync_io,
        device=args.device,
        **kwargs,
    )
    executor = None if args.no_prefetch else ThreadPoolExecutor(max_workers=1)

    def submit(job):
        out_dir = os.path.join(args.out, job["name"])
        return executor.submit(pipe.preprocess_job, out_dir, job["image"],
                               job["mesh"])

    pending = submit(jobs[0]) if executor else None
    results = []
    if args.sr_window > 1 and pipe.sr_pipeline is not None:
        _run_windowed(args, pipe, jobs, executor, submit, pending, results)
        _finish(args, pipe, results)
        return
    for i, job in enumerate(jobs):
        out_dir = os.path.join(args.out, job["name"])
        t0 = time.perf_counter()
        try:
            pre = pending.result() if pending is not None else None
        except Exception as e:  # noqa: BLE001 -- reported with the job
            pre, job_error = None, e
        else:
            job_error = None
        if executor and i + 1 < len(jobs):
            pending = submit(jobs[i + 1])
        try:
            if job_error is not None:
                raise job_error
            _, glb = pipe(out_dir, job["image"], job["mesh"], preprocessed=pre)
            dt = time.perf_counter() - t0
            results.append({"name": job["name"], "glb": glb,
                            "seconds": round(dt, 2)})
            print(f"[{i + 1}/{len(jobs)}] {job['name']}: {dt:.1f}s")
        except Exception as e:  # noqa: BLE001 -- --keep-going
            if not args.keep_going:
                raise
            results.append({"name": job["name"], "error": str(e)})
            print(f"[{i + 1}/{len(jobs)}] {job['name']}: FAILED {e}")
    if executor:
        executor.shutdown(wait=False)
    _finish(args, pipe, results)


def _finish(args, pipe, results):
    try:
        pipe.flush_io()
    except Exception as e:  # noqa: BLE001 -- --keep-going
        results.append({"name": "__flush_io__", "error": str(e)})
        if not args.keep_going:
            raise
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(results, f, indent=2)


def _run_windowed(args, pipe, jobs, executor, submit, pending, results):
    """The SR-window loop: denoise ``--sr-window`` jobs with the SR stage
    deferred, super-resolve every grid inside one
    ``sr_pipeline.staged()`` window, then bake each."""
    from unitex_torch.pipeline import _host
    from unitex_torch.utils.image_io import save_image

    window = args.sr_window
    n = len(jobs)
    i = 0
    while i < n:
        held = []
        for k, job in enumerate(jobs[i:i + window]):
            out_dir = os.path.join(args.out, job["name"])
            cache = os.path.join(out_dir, "cache")
            os.makedirs(cache, exist_ok=True)
            t0 = time.perf_counter()
            try:
                if pending is not None:
                    pre = pending.result()
                else:
                    pre = pipe.preprocess_job(out_dir, job["image"], job["mesh"])
                pending = (submit(jobs[i + k + 1])
                           if executor and i + k + 1 < n else None)
                condition = pipe.render_geometry_images_stage(cache, pre[0])
                mv = pipe.infer_mv_stage(cache, pre[1], condition,
                                         apply_sr=False)
                # hold only what the bake reads across the window
                condition = {c: condition[c]
                             for c in ("mesh", "c2ws", "intrinsics")}
                held.append([job, out_dir, cache, pre, condition, mv, t0])
            except Exception as e:  # noqa: BLE001 -- --keep-going
                if not args.keep_going:
                    raise
                results.append({"name": job["name"], "error": str(e)})
                print(f"{job['name']}: FAILED {e}")
        staged = getattr(pipe.sr_pipeline, "staged", contextlib.nullcontext)
        with staged():
            for rec in held:
                rec[5] = pipe._apply_sr(
                    rec[5], rec[2] if not args.no_artifacts else None)
        if not args.no_artifacts:
            for rec in held:
                save_image(os.path.join(rec[2], "mv_rgb.png"), _host(rec[5]))
        for job, out_dir, cache, pre, condition, mv, t0 in held:
            try:
                glb = pipe.reproject_stage(cache, condition["mesh"], mv,
                                           condition, pre[0])
                shutil.copy(os.path.join(cache, "rembg_image.png"),
                            os.path.join(out_dir, "rembg_image.png"))
                glb_out = os.path.join(out_dir, "textured_mesh.glb")
                pipe._submit_io(shutil.copy, glb, glb_out)
                dt = time.perf_counter() - t0
                results.append({"name": job["name"], "glb": glb_out,
                                "seconds": round(dt, 2)})
                print(f"{job['name']}: {dt:.1f}s (window {window})")
            except Exception as e:  # noqa: BLE001 -- --keep-going
                if not args.keep_going:
                    raise
                results.append({"name": job["name"], "error": str(e)})
                print(f"{job['name']}: FAILED {e}")
        i += window
    if executor:
        executor.shutdown(wait=False)


if __name__ == "__main__":
    main()
