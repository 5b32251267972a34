"""Multi-GPU serving on one host: one process per card over NCCL.

    torchrun --nproc-per-node 4 -m unitex_torch.scripts.probe_multi_gpu \\
        [--steps 4] [--out multi_gpu.json]

(``python -m torch.distributed.run`` where there is no ``torchrun``.)  On
N cards it runs, each part fenced by a synchronize and a barrier:

1. the full-width FLUX.1-dev tree (random, bf16) whole on every rank:
   rank 0's one-card ``flux_forward`` at S = 512 + 13312 = 13824 as the
   reference, then on all ranks the tensor-parallel forward (model = N),
   Ulysses and the ring (seq = N), each held to the reference (max|d| of
   max|ref|), and TP with ``attn_qk8`` (kernel B3 on the local heads) held
   to rank 0's one-card ``attn_qk8`` forward; each with its wall and the
   B1 / B3 launches on each rank;
2. B1 alone at the Ulysses shape [1, 13824, 24/N, 128] (also TP's) and at
   the ring's block [1, 13824/N, 24, 128], and B3 at the Ulysses shape,
   timed with CUDA events on each rank, beside the bound, rank 0's plain
   version and ``scaled_dot_product_attention``;
3. one texturing job (the icosphere of ``chip_smoke.py``'s assets,
   ``--steps`` denoise steps) through the pipeline on the TP = N mesh,
   random weights drawn as slices: its wall, each rank's B1 launches and
   peak memory;
4. the TSD-SR stage on a data = N mesh (SD3-medium and its VAE random,
   bf16 transformer, one 512² view to 2048², the VAE decode in bf16 and
   in f32) against the same stage on rank 0 alone: wall, max and mean
   |d|.

Rank 0 prints the card's name and power limit, one ``[multi]`` line a
measurement, and writes every number to ``--out``.  Nothing is caught: a
failing rank ends the job.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import DEFAULT_CONFIG
from ..geometry.io.mesh_io import save_mesh
from ..geometry.primitives import make_icosphere
from ..models.flux.config import FluxConfig
from ..models.flux.model import flux_forward, init_flux_params, tp_config
from ..models.flux.pipeline import latent_image_ids
from ..models.flux.sp import flux_forward_sp
from ..ops import attention as attn
from ..parallel.mesh import make_mesh
from ..parallel.sharding import shard_flux_params
from ..utils import cuda_build
from ..utils.timer import CPUTimer
from .probe_flash_bwd import card_line, cuda_ms

S_TXT = 512


def fenced(fn):
    """(result, wall seconds) of ``fn()`` between barriers, synchronized."""
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dist.barrier()
    return out, wall


def gathered(value) -> list:
    """Every rank's ``value`` (a number or a short list), on every rank."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


class Report:
    def __init__(self, root: bool):
        self.root, self.data = root, {}

    def __call__(self, key: str, line: str, **values) -> None:
        self.data[key] = values
        if self.root:
            print(f"[multi] {line}", flush=True)


def forwards(report: Report, n: int, device) -> None:
    cfg = FluxConfig.flux1_dev()
    params = init_flux_params(torch.Generator(device=device).manual_seed(0),
                              cfg, device=device)
    g = torch.Generator(device=device).manual_seed(20)
    img_ids = torch.cat([
        latent_image_ids(32, 192, device=device),
        latent_image_ids(32, 192, offset_y=16, device=device),
        latent_image_ids(32, 32, offset_x=96, offset_y=16, device=device)])
    S_img = img_ids.shape[0]
    args = [torch.randn((1, S_img, cfg.in_channels), generator=g, device=device),
            torch.randn((1, S_TXT, cfg.joint_attention_dim), generator=g,
                        device=device),
            torch.tensor([0.6], device=device),
            torch.randn((1, cfg.pooled_projection_dim), generator=g,
                        device=device),
            img_ids, torch.zeros((S_TXT, 3), device=device),
            torch.tensor([3.5], device=device)]
    tp_mesh = make_mesh(data=1, model=n, device=device)
    sp_mesh = make_mesh(data=1, seq=n, model=1, device=device)
    qk8 = dataclasses.replace(cfg, attn_qk8=True)
    refs = {}
    for name, c in (("one_card", cfg), ("one_card_qk8", qk8)):
        if tp_mesh.is_root:
            flux_forward(params, c, *args)   # the first call
            refs[name], wall = fenced(lambda: flux_forward(params, c, *args))
        else:
            _, wall = fenced(lambda: None)
        report(name, f"flux_forward on rank 0 alone{', attn_qk8' * c.attn_qk8}"
               f": S = {S_TXT} + {S_img}, {wall:.3f}s", seconds=wall)
    shard = shard_flux_params(params, tp_mesh)
    group = tp_mesh.group("model")
    runs = {
        "tp": lambda: flux_forward(shard, tp_config(cfg, group), *args),
        "tp_qk8": lambda: flux_forward(shard, tp_config(qk8, group), *args),
        "ulysses": lambda: flux_forward_sp(params, cfg, *args,
                                           seq_axis=sp_mesh.group("seq"),
                                           sp_mode="ulysses"),
        "ring": lambda: flux_forward_sp(params, cfg, *args,
                                        seq_axis=sp_mesh.group("seq"),
                                        sp_mode="ring"),
    }
    for name, fn in runs.items():
        fn()   # the first call: NCCL's communicators
        before = (attn.launches, attn.launches_qk8)
        out, wall = fenced(fn)
        launches = gathered([attn.launches - before[0],
                             attn.launches_qk8 - before[1]])
        err = None
        ref = refs.get("one_card_qk8" if name == "tp_qk8" else "one_card")
        if ref is not None:
            err = float((out.float() - ref.float()).abs().max()
                        / ref.float().abs().max())
        report(name, f"flux_forward {name} over {n} ranks: {wall:.3f}s, "
               f"max|d| {err} of max|ref| (rank 0's one-card forward), "
               f"B1 / B3 launches by rank {launches}", seconds=wall,
               rel_err=err, launches=launches)
        del out
    del params, shard


PEAK_BF16, PEAK_INT8 = 989e12, 1979e12   # H100 SXM dense tensor-core peaks


def kernels(report: Report, n: int, device) -> None:
    """B1 at the Ulysses (and TP) shape and the ring's block, B3 at the
    Ulysses shape: ms on each rank, rank 0's plain version (f32 logits)
    and ``scaled_dot_product_attention`` on the same inputs, the bound
    (the tensor cores' time for 4·B·H·S²·D, B3's Q·Kᵀ half in int8) and
    max|d| against the plain version."""
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(21)
    for name, shape in (("B1 ulysses", (1, 13824, 24 // n, 128)),
                        ("B1 ring block", (1, 13824 // n, 24, 128)),
                        ("B3 ulysses", (1, 13824, 24 // n, 128))):
        q, k, v = (torch.randn(shape, generator=g, device=device,
                               dtype=torch.bfloat16) for _ in range(3))
        B, S, H, D = shape
        flops = 2 * B * H * S * S * D
        if name.startswith("B3"):
            qq, sq = attn.quant_rows(q)
            kq, sk = attn.quant_rows(k)

            def kernel():
                return attn.flash_attention_qk8(qq, kq, v, sq, sk)

            def plain():
                return attn.attention_qk8_reference(qq, kq, v, sq, sk)

            bound = (flops / PEAK_INT8 + flops / PEAK_BF16) * 1e3
            library = None
        else:
            def kernel():
                return attn.flash_attention(q, k, v)[0]

            def plain():
                return attn.attention_reference(q, k, v)[0]

            bound = 2 * flops / PEAK_BF16 * 1e3
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
        ms = gathered(cuda_ms(kernel, 10))
        plain_ms = cuda_ms(plain, 2)
        err = float((kernel().float() - plain().float()).abs().max())
        report(name, f"{name} {list(shape)}: {ms} ms by rank, bound "
               f"{bound:.4f} ms (operations), plain {plain_ms:.3f} ms, "
               f"library {library} ms, max|d| {err:.3e} against the plain "
               f"version (rank 0)", shape=shape, ms_by_rank=ms, bound_ms=bound,
               plain_ms=plain_ms, library_ms=library, max_abs_err=err)
        del q, k, v


def job(report: Report, n: int, device, steps: int) -> None:
    from PIL import Image

    from ..pipeline import CustomRGBTextureFullPipeline

    config = dataclasses.replace(DEFAULT_CONFIG, diffusion=dataclasses.replace(
        DEFAULT_CONFIG.diffusion, num_inference_steps=steps))
    mesh = make_mesh(data=1, model=n, device=device)
    torch.cuda.reset_peak_memory_stats()
    pipe = CustomRGBTextureFullPipeline(random_weights=True, config=config,
                                        device=device, mesh=mesh)
    params_gib = torch.cuda.memory_allocated() / 2**30
    with tempfile.TemporaryDirectory(prefix="probe_multi_") as d:
        mesh_path, img_path = os.path.join(d, "m.obj"), os.path.join(d, "i.png")
        if mesh.is_root:
            save_mesh(mesh_path, make_icosphere(5))
            img = np.full((512, 512, 3), 255, np.uint8)
            yy, xx = np.mgrid[:512, :512]
            img[(yy - 256) ** 2 + (xx - 256) ** 2 < 160 ** 2] = (200, 60, 30)
            Image.fromarray(img).save(img_path)
        before = attn.launches
        (_, glb), wall = fenced(lambda: pipe(os.path.join(d, "out"), img_path,
                                             mesh_path))
        if mesh.is_root:
            pipe.flush_io()
            if not os.path.exists(glb):
                raise AssertionError(f"no GLB at {glb}")
    launches = gathered(attn.launches - before)
    peak = gathered(round(torch.cuda.max_memory_allocated() / 2**30, 2))
    params = gathered(round(params_gib, 2))
    # rank 0's: the other ranks skip the host stages
    stages = {k: round(CPUTimer.records.get(k, 0.0), 3) for k in (
        "preprocess_blank_mesh", "preprocess_reference_image",
        "render_geometry_images", "infer_mv", "reproject_and_query_field")}
    report("job", f"icosphere job, {steps} steps, TP = {n}: {wall:.2f}s "
           f"(rank 0's stages {stages}), B1 launches by rank {launches}, "
           f"parameters {params} GiB, peak {peak} GiB by rank", seconds=wall,
           stages=stages, launches=launches, params_gib=params, peak_gib=peak)
    del pipe


def sr_stage(report: Report, n: int, device) -> None:
    from ..models.flux.vae import VAEConfig, init_vae_params
    from ..models.sd3.config import SD3Config
    from ..models.sd3.model import init_sd3_params
    from ..models.sd3.sr_pipeline import TSDSRConfig, TSDSRPipeline

    cfg = SD3Config.sd3_medium()
    gen = torch.Generator(device=device)
    tree = init_sd3_params(gen.manual_seed(0), cfg, device=device)
    vae = init_vae_params(gen.manual_seed(1), VAEConfig.sd3(), device=device)
    image = torch.rand((512, 512, 3), generator=gen.manual_seed(2),
                       device=device)
    mesh = make_mesh(data=n, model=1, device=device)
    # the default bf16 VAE decode, then f32: the tile batches a rank runs
    # are smaller than one card's, so bf16 convolutions and GEMMs may take
    # other algorithms and round otherwise
    for decode in ("bfloat16", "float32"):
        sr_cfg = TSDSRConfig(vae_decode_dtype=decode)
        ref = None
        if mesh.is_root:
            one = TSDSRPipeline(None, cfg=sr_cfg, sd3_cfg=cfg,
                                transformer_params=tree, vae_params=vae,
                                device=device)
            one(image)   # the first call
            ref, wall_one = fenced(lambda: one(image))
        else:
            _, wall_one = fenced(lambda: None)
        ranked = TSDSRPipeline(None, cfg=sr_cfg, sd3_cfg=cfg,
                               transformer_params=tree, vae_params=vae,
                               mesh=mesh)
        ranked(image)   # the first call: NCCL's communicators
        before = attn.launches_d64
        out, wall = fenced(lambda: ranked(image))
        launches = gathered(attn.launches_d64 - before)
        err = mean = None
        if ref is not None:
            err = float((out - ref).abs().max())
            mean = float((out - ref).abs().mean())
        report(f"sr_{decode}", f"TSD-SR 512² -> 2048², {decode} VAE decode, "
               f"on data = {n}: {wall:.2f}s (rank 0 alone {wall_one:.2f}s), "
               f"max|d| {err} mean|d| {mean} against rank 0 alone, B1 "
               f"(D = 64) launches by rank {launches}", seconds=wall,
               seconds_one=wall_one, max_abs_err=err, mean_abs_err=mean,
               launches=launches)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", default="multi_gpu.json")
    args = ap.parse_args(argv)
    mesh = make_mesh(device="cuda")
    n, device, root = mesh.world_size, mesh.device, mesh.is_root
    if root:
        cuda_build.build(attn.KERNEL, attn.KERNEL_QK8)
    dist.barrier()
    report = Report(root)
    if root:
        print(f"[multi] cards:\n{card_line()}\n[multi] torch {torch.__version__}"
              f" cuda {torch.version.cuda}, world {n}", flush=True)
    with torch.no_grad():
        forwards(report, n, device)
        torch.cuda.empty_cache()
        kernels(report, n, device)
        torch.cuda.empty_cache()
        job(report, n, device, args.steps)
        torch.cuda.empty_cache()
        sr_stage(report, n, device)
    if root:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card_line(), "world": n, **report.data}, f,
                      indent=1)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
