"""Multi-GPU serving and training on one host: one process per card over
NCCL.

    torchrun --nproc-per-node 4 -m unitex_torch.scripts.probe_multi_gpu \\
        [--mode serve|int8|http|train] [--steps 4] [--out multi_gpu.json]
    python -m unitex_torch.scripts.probe_multi_gpu --mode sr-quarters

(``python -m torch.distributed.run`` where there is no ``torchrun``.)  On
N cards ``--mode serve`` (the default) runs, each part fenced by a
synchronize and a barrier:

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

``--mode int8`` runs the texturing job of part 3 in int8 serving, W8A8
(``int8_serving=True``) and "max_memory", both with ``attn_qk8`` (kernel
B3 on the local heads), the random tree drawn node by node, each node
quantized whole and then cut: each rank's parameter bytes and peak, rank
0's stages and wall, each rank's B3 launches; then the whole serving
tree gathered from the slices (``unshard_tree``) and rank 0's one-card
``flux_forward`` on it (S = 13824, ``attn_qk8``) against the
tensor-parallel forward: max|d| of max|ref|.

``--mode http`` serves on the TP = N mesh (bf16, random weights) over
HTTP: rank 0 runs ``serving.serve`` (``prefetch=False``) and the other
ranks ``pipeline.follow``; the icosphere, a job whose mesh file does not
parse (it must fail), then the icosphere again, each awaited before the
next: each job's status, wall and device seconds, and each rank's
launches.

``--mode train`` trains the full-width, full-depth FLUX.1-dev (random,
bf16 base) on a batch of four 512² synthetic examples (S = 12800, rank 16,
remat): rank 0's one-card LoRA step as the reference, then three LoRA
steps on each mesh of ``TRAIN_MESHES`` (data x model tensor parallelism,
the GPipe pipeline over ``pipe``, both with the batch cut over ``data``)
and three ZeRO-1 full fine-tuning steps (f32 masters, bf16 compute, the
batch's first two examples) on each mesh of ``ZERO_MESHES``, the data
axis growing until the per-rank bytes outgrow one card (their reference
loss: rank 0's one-card forward of the same tree in bf16; ``--mode
train-zero`` runs these alone); for each, the median step of steps 2-3,
each rank's peak memory and B1 / B2a / B2b launches a step, and the
first step's loss against the reference.  Each mesh's process groups
are destroyed after it (their NCCL buffers freed).

``--mode sr-quarters`` (one card): the TSD-SR stage of ``sr_stage`` with
its tile batches cut to a quarter (transformer, VAE encode and decode
batches 8 -> 2: what each rank of a data = 4 mesh runs) against the
whole batches, in the bf16 and f32 VAE decode.

Rank 0 prints the card's name and power limit, one ``[multi]`` line a
measurement, and writes every number to ``--out``.  Nothing is caught: a
failing rank ends the job.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
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
    """Rank 0 prints each measurement and rewrites ``out`` with all of
    them so far (a later part's failure keeps the earlier numbers)."""

    def __init__(self, root: bool, out: str = None, head: dict = None):
        self.root, self.out, self.head, self.data = root, out, head or {}, {}

    def __call__(self, key: str, line: str, **values) -> None:
        self.data[key] = values
        if self.root:
            print(f"[multi] {line}", flush=True)
            if self.out:
                os.makedirs(os.path.dirname(self.out) or ".", exist_ok=True)
                with open(self.out, "w") as f:
                    json.dump({**self.head, **self.data}, f, indent=1)


def forwards(report: Report, n: int, device) -> None:
    cfg = FluxConfig.flux1_dev()
    params = init_flux_params(torch.Generator(device=device).manual_seed(0),
                              cfg, device=device)
    args = _flux_args(cfg, device)
    S_img = args[0].shape[1]
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
    from ..pipeline import CustomRGBTextureFullPipeline

    config = dataclasses.replace(DEFAULT_CONFIG, diffusion=dataclasses.replace(
        DEFAULT_CONFIG.diffusion, num_inference_steps=steps))
    mesh = make_mesh(data=1, model=n, device=device)
    torch.cuda.reset_peak_memory_stats()
    pipe = CustomRGBTextureFullPipeline(random_weights=True, config=config,
                                        device=device, mesh=mesh)
    params_gib = torch.cuda.memory_allocated() / 2**30
    with tempfile.TemporaryDirectory(prefix="probe_multi_") as d:
        mesh_path, img_path = _assets(d, mesh.is_root)
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


def _flux_args(cfg, device):
    """The serving job's FLUX forward inputs at S = 512 + 13312 (the
    noise, control and dual grids of ``chip_smoke.parallel_ids``)."""
    g = torch.Generator(device=device).manual_seed(20)
    img_ids = torch.cat([
        latent_image_ids(32, 192, device=device),
        latent_image_ids(32, 192, offset_y=16, device=device),
        latent_image_ids(32, 32, offset_x=96, offset_y=16, device=device)])
    S_img = img_ids.shape[0]
    return [torch.randn((1, S_img, cfg.in_channels), generator=g, device=device),
            torch.randn((1, S_TXT, cfg.joint_attention_dim), generator=g,
                        device=device),
            torch.tensor([0.6], device=device),
            torch.randn((1, cfg.pooled_projection_dim), generator=g,
                        device=device),
            img_ids, torch.zeros((S_TXT, 3), device=device),
            torch.tensor([3.5], device=device)]


def _assets(d: str, root: bool):
    """The icosphere and its reference image of part 3, written by rank 0."""
    from PIL import Image

    mesh_path, img_path = os.path.join(d, "m.obj"), os.path.join(d, "i.png")
    if root:
        save_mesh(mesh_path, make_icosphere(5))
        img = np.full((512, 512, 3), 255, np.uint8)
        yy, xx = np.mgrid[:512, :512]
        img[(yy - 256) ** 2 + (xx - 256) ** 2 < 160 ** 2] = (200, 60, 30)
        Image.fromarray(img).save(img_path)
    return mesh_path, img_path


def int8_jobs(report: Report, n: int, device, steps: int) -> None:
    """``--mode int8`` (module docstring)."""
    from ..ops.quant import count_quantized
    from ..parallel.sharding import unshard_tree
    from ..pipeline import CustomRGBTextureFullPipeline

    config = dataclasses.replace(DEFAULT_CONFIG, diffusion=dataclasses.replace(
        DEFAULT_CONFIG.diffusion, num_inference_steps=steps))
    mesh = make_mesh(data=1, model=n, device=device)
    for mode in (True, "max_memory"):
        name = "int8_w8a8" if mode is True else "int8_max_memory"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = CustomRGBTextureFullPipeline(random_weights=True, config=config,
                                            int8_serving=mode, device=device,
                                            mesh=mesh)
        pipe.flux_cfg = dataclasses.replace(pipe.flux_cfg, attn_qk8=True)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tree_gib = sum(x.numel() * x.element_size() for x in _leaves(
            pipe.transformer_params)) / 2**30
        n_q, n_f = count_quantized(pipe.transformer_params)
        with tempfile.TemporaryDirectory(prefix="probe_multi_") as d:
            mesh_path, img_path = _assets(d, mesh.is_root)
            before = attn.launches_qk8, attn.launches
            CPUTimer.records.clear()
            (_, glb), wall = fenced(lambda: pipe(os.path.join(d, "out"),
                                                 img_path, mesh_path))
            if mesh.is_root:
                pipe.flush_io()
                if not os.path.exists(glb):
                    raise AssertionError(f"no GLB at {glb}")
        launches = gathered([attn.launches_qk8 - before[0],
                             attn.launches - before[1]])
        peak = gathered(round(torch.cuda.max_memory_allocated() / 2**30, 2))
        params = gathered(round(tree_gib, 2))
        stages = {k: round(CPUTimer.records.get(k, 0.0), 3) for k in (
            "preprocess_blank_mesh", "preprocess_reference_image",
            "render_geometry_images", "infer_mv", "reproject_and_query_field")}
        report(name, f"icosphere job in int8 ({mode!r}, attn_qk8), {steps} "
               f"steps, TP = {n}: init {init_s:.2f}s, wall {wall:.2f}s "
               f"(rank 0's stages {stages}), B3 / B1 launches by rank "
               f"{launches}, serving tree {params} GiB by rank ({n_q / 1e9:.3f}"
               f" G int8, {n_f / 1e9:.3f} G float elements on rank 0), peak "
               f"{peak} GiB by rank", seconds=wall, init_s=init_s,
               stages=stages, launches=launches, params_gib=params,
               peak_gib=peak)

        # the TP forward against rank 0's one-card forward of the whole tree
        cfg = dataclasses.replace(pipe.flux_cfg, attn_qk8=True)
        args = _flux_args(cfg, device)
        tp = lambda: flux_forward(pipe.transformer_params,
                                  tp_config(cfg, mesh.group("model")), *args)
        tp()
        out, t_tp = fenced(tp)
        whole = unshard_tree(pipe.transformer_params, mesh.group("model"))
        if not mesh.is_root:
            whole = None
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        err = t_one = None
        if mesh.is_root:
            flux_forward(whole, cfg, *args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = flux_forward(whole, cfg, *args)
            torch.cuda.synchronize()
            t_one = time.perf_counter() - t0
            err = float((out.float() - ref.float()).abs().max()
                        / ref.float().abs().max())
            del ref
        dist.barrier()
        report(f"{name}_forward", f"flux_forward in int8 ({mode!r}, attn_qk8)"
               f" over {n} ranks: {t_tp:.3f}s against rank 0's one-card "
               f"forward of the gathered tree {t_one}s, max|d| {err} of "
               f"max|ref|", seconds=t_tp, one_card_s=t_one, rel_err=err)
        del whole, out
        gc.collect()
        torch.cuda.empty_cache()
    free_mesh(mesh)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def http_serve(report: Report, n: int, device, steps: int) -> None:
    """``--mode http`` (module docstring)."""
    import threading
    import urllib.request

    from ..pipeline import CustomRGBTextureFullPipeline
    from ..serving import serve

    config = dataclasses.replace(DEFAULT_CONFIG, diffusion=dataclasses.replace(
        DEFAULT_CONFIG.diffusion, num_inference_steps=steps))
    mesh = make_mesh(data=1, model=n, device=device)
    pipe = CustomRGBTextureFullPipeline(random_weights=True, config=config,
                                        device=device, mesh=mesh)
    d = tempfile.mkdtemp(prefix="probe_serve_") if mesh.is_root else None
    d = gathered(d)[0]
    mesh_path, img_path = _assets(d, mesh.is_root)
    before = attn.launches
    dist.barrier()
    if not mesh.is_root:
        pipe.follow()
        gathered(attn.launches - before)
        return

    def request(url, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(url, data=data, headers={
            "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=900) as r:
            return json.loads(r.read())

    broken = os.path.join(d, "broken.obj")
    with open(broken, "w") as f:
        f.write("v 0 0\nf 1 2 x\n")
    httpd = serve(pipe, os.path.join(d, "work"), port=0, prefetch=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    recs = []
    for name, m in (("first", mesh_path), ("broken", broken),
                    ("second", mesh_path)):
        t0 = time.perf_counter()
        job_id = request(base + "/jobs", {"mesh_path": m, "image_path": img_path,
                                          "name": name})["id"]
        while True:
            rec = request(f"{base}/jobs/{job_id}")
            if rec["status"] in ("done", "failed"):
                break
            time.sleep(0.05)
        rec["wall"] = round(time.perf_counter() - t0, 3)
        recs.append(rec)
    httpd.jobs.stop()   # releases the followers
    launches = gathered(attn.launches - before)
    httpd.shutdown()
    httpd.server_close()
    statuses = [r["status"] for r in recs]
    report("http", f"HTTP jobs on TP = {n}, {steps} steps: "
           + ", ".join(f"{r['name']} {r['status']} wall {r['wall']:.2f}s "
                       f"device {r.get('device_s', 0):.2f}s" for r in recs)
           + f"; the broken job's error {recs[1].get('error')!r}; B1 launches "
           f"by rank {launches}", statuses=statuses,
           walls=[r["wall"] for r in recs],
           device_s=[r.get("device_s") for r in recs], launches=launches)
    if statuses != ["done", "failed", "done"]:
        raise AssertionError(f"http: {recs}")


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


S_TRAIN_BATCH = 4
TRAIN_STEPS = 3
# name: (make_mesh arguments, PP microbatches or 0 for tensor parallelism)
TRAIN_MESHES = {
    "data 1 x model 4": (dict(data=1, model=4), 0),
    "data 2 x model 2": (dict(data=2, model=2), 0),
    "pipe 4, M = 4": (dict(data=1, pipe=4, model=1), 4),
    "data 2 x pipe 2, M = 2": (dict(data=2, pipe=2, model=1), 2),
}
# ZeRO-1 meshes, the data axis growing (the last may not fit one card)
ZERO_MESHES = {"data 1 x model 4": dict(data=1, model=4),
               "data 2 x model 2": dict(data=2, model=2)}


def free_mesh(mesh) -> None:
    """Destroy a mesh's process groups (their NCCL communicators' memory
    goes back to the card) and return the freed blocks to the card."""
    for group in {id(g): g for g in mesh.groups.values()}.values():
        dist.destroy_process_group(group)
    gc.collect()
    torch.cuda.empty_cache()


def _train_batch(device, cfg, vae_cfg, view_size: int, s_txt: int):
    """The batch of ``S_TRAIN_BATCH`` synthetic examples (a seeded random
    VAE), the same on every rank."""
    from ..models.flux.vae import init_vae_params
    from ..training.data import SyntheticTextureDataset
    from .train_flux_lora import build_batch

    vae = init_vae_params(torch.Generator(device=device).manual_seed(1),
                          vae_cfg, device=device)
    data = iter(SyntheticTextureDataset(view_size=view_size, seed=0,
                                        device=str(device)))
    batch = build_batch([next(data) for _ in range(S_TRAIN_BATCH)], vae,
                        vae_cfg, torch.zeros((s_txt, cfg.joint_attention_dim),
                                             device=device),
                        torch.zeros((cfg.pooled_projection_dim,),
                                    device=device))
    del vae
    return batch


def _launches():
    return (attn.launches, attn.launches_bwd_dkv, attn.launches_bwd_dq)


def _steps(step_fn, report_key, report, name, ref_loss, extra=""):
    """``TRAIN_STEPS`` calls of ``step_fn(i) -> loss``, fenced: the median
    of steps 2-3, each rank's peak and launches a step, the first loss
    against ``ref_loss``."""
    torch.cuda.reset_peak_memory_stats()
    walls, losses, counts = [], [], []
    for i in range(TRAIN_STEPS):
        before = _launches()
        loss, wall = fenced(lambda: float(step_fn(i)))
        walls.append(wall)
        losses.append(loss)
        counts.append(tuple(a - b for a, b in zip(_launches(), before)))
    peak = gathered(torch.cuda.max_memory_allocated() / 2**30)
    per_rank = gathered(list(counts[-1]))
    med = float(np.median(walls[1:]))
    d = None if ref_loss is None else abs(losses[0] - ref_loss)
    report(report_key, f"train {name}{extra}: step {med:.3f}s (median of steps "
           f"2-3; steps {[round(w, 3) for w in walls]}), peak by rank "
           f"{[round(p, 2) for p in peak]} GiB, B1/B2a/B2b a step by rank "
           f"{per_rank}, losses {losses}, |loss - one card| {d}",
           seconds=med, walls=walls, peak_gib=peak, launches=per_rank,
           losses=losses, ref_loss=ref_loss, loss_abs_diff=d)


def training(report: Report, n: int, device, cfg=None, vae_cfg=None,
             view_size: int = 512, s_txt: int = S_TXT,
             parts=("lora", "zero")) -> None:
    """``--mode train`` (module docstring); ``cfg`` / ``vae_cfg`` / the view
    size and text length default to FLUX.1-dev's training shapes (smaller
    ones rehearse it over gloo on the CPU)."""
    from ..models.flux.vae import VAEConfig
    from ..models.flux.lora import init_lora_params
    from ..models.flux.model import flux_param_shapes
    from ..models.flux.pp import prepare_flux_params_pp, prepare_lora_pp
    from ..parallel.sharding import shard_hook
    from ..training.flux_lora import (
        FluxLoraTrainConfig,
        TrainState,
        _leaves,
        _map,
        flow_match_loss,
        make_optimizer,
        train_step,
    )
    from ..training.full_finetune import (
        FullTrainState,
        full_train_step,
        shard_opt_state_zero,
    )

    cfg = dataclasses.replace(cfg or FluxConfig.flux1_dev(), remat=True)
    tcfg = FluxLoraTrainConfig(rank=16, learning_rate=1e-4,
                               lr_scheduler="constant")
    batch = _train_batch(device, cfg, vae_cfg or VAEConfig.flux(), view_size,
                         s_txt)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def lora_tree():
        return init_lora_params(gen(5), flux_param_shapes(cfg), rank=16,
                                device=device)

    def requires_grad(tree):
        for leaf in _leaves(tree):
            leaf.requires_grad_(True)
        return tree

    if "lora" in parts:
        # rank 0's one-card LoRA step: the reference loss
        ref = None
        if dist.get_rank() == 0:
            params = init_flux_params(gen(0), cfg, device=device)
            lora = requires_grad(lora_tree())
            tx = make_optimizer(tcfg)
            state = TrainState(0, lora, tx.init(lora))
            before = _launches()
            (state, loss), wall = fenced(lambda: train_step(
                state, params, batch, gen(1000), cfg, tcfg, tx))
            ref = float(loss)
            print(f"[multi] train one card (rank 0), batch {S_TRAIN_BATCH}: loss "
                  f"{ref} step {wall:.3f}s (first call) B1/B2a/B2b "
                  f"{tuple(a - b for a, b in zip(_launches(), before))} peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
            del params, lora, state, tx
            torch.cuda.empty_cache()
        else:
            fenced(lambda: None)
        ref = gathered(ref)[0]

        for name, (axes, n_micro) in TRAIN_MESHES.items():
            mesh = make_mesh(device=device, **axes)
            data = mesh.group("data")
            if n_micro:
                whole = init_flux_params(gen(0), cfg, device=device)
                params = prepare_flux_params_pp(whole, mesh)
                params = {k: (_map(lambda x: x.clone(), v) if k in
                              ("dual_blocks", "single_blocks") else v)
                          for k, v in params.items()}
                del whole
                torch.cuda.empty_cache()
                lora = requires_grad(prepare_lora_pp(lora_tree(), mesh))
                t = dataclasses.replace(
                    tcfg, pipe_axis=mesh.group("pipe"), pipe_n_micro=n_micro,
                    pipe_data_axis=data if mesh.size("data") > 1 else None)
                c, data_axis = cfg, None
            else:
                params = init_flux_params(gen(0), cfg, device=device,
                                          hook=shard_hook(mesh))
                lora = requires_grad(shard_flux_params(lora_tree(), mesh))
                t, c, data_axis = tcfg, tp_config(cfg, mesh.group("model")), data
            tx = make_optimizer(t)
            state = TrainState(0, lora, tx.init(lora))

            def step(i, state=state, params=params, c=c, t=t, tx=tx,
                     data_axis=data_axis):
                return train_step(state, params, batch, gen(1000 + i), c, t, tx,
                                  data_axis=data_axis)[1]

            _steps(step, f"train_{name}", report, f"LoRA {name}", ref)
            # ``step`` holds the mesh's trees through its defaults
            del params, lora, state, tx, step
            free_mesh(mesh)

    if "zero" not in parts:
        return
    # ZeRO-1 on the batch's first two examples (one a data rank): rank 0's
    # one-card loss of the same tree in bf16 first
    batch = {k: v if k == "cond_ids" else v[:2] for k, v in batch.items()}
    zref = None
    if dist.get_rank() == 0:
        to_bf16 = (lambda path, node: {k: v.to(torch.bfloat16)
                                       for k, v in node.items()})
        params = init_flux_params(gen(0), cfg, device=device,
                                  dtype=torch.float32, hook=to_bf16)
        params = _map(lambda x: x.to(torch.bfloat16), params)
        with torch.no_grad():
            zref = float(flow_match_loss(None, params, cfg, tcfg, batch,
                                         gen(1000)))
        del params
        torch.cuda.empty_cache()
    zref = gathered(zref)[0]
    for zname, axes in ZERO_MESHES.items():
        mesh = make_mesh(device=device, **axes)
        params = init_flux_params(gen(0), cfg, device=device,
                                  dtype=torch.float32, hook=shard_hook(mesh))
        requires_grad(params)
        tx = make_optimizer(tcfg)
        opt, zero = shard_opt_state_zero(params, mesh, tx)
        state = FullTrainState(0, params, opt, zero)
        c = tp_config(cfg, mesh.group("model"))

        def zstep(i, state=state, c=c, tx=tx, data=mesh.group("data")):
            return full_train_step(state, batch, gen(1000 + i), c, tcfg, tx,
                                   bf16_compute=True, data_axis=data)[1]

        _steps(zstep, f"train_zero_{zname}", report,
               f"ZeRO-1 full fine-tuning {zname}", zref,
               extra=" (f32 masters, bf16 compute, batch 2)")
        del state, params, opt, tx, zstep
        free_mesh(mesh)

def sr_quarters(report: Report, device) -> None:
    """The TSD-SR stage on one card in quarter tile batches against the
    whole batches (module docstring)."""
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
    for decode in ("bfloat16", "float32"):
        outs = {}
        for name, b in (("whole", 8), ("quarter", 2)):
            sr = TSDSRPipeline(None, cfg=TSDSRConfig(
                vae_decode_dtype=decode, tile_batch=b, vae_encode_batch=b,
                vae_decode_batch=b), sd3_cfg=cfg, transformer_params=tree,
                vae_params=vae, device=device)
            sr(image)   # the first call
            outs[name], wall = fenced(lambda: sr(image))
            outs[name + "_s"] = wall
        err = float((outs["quarter"] - outs["whole"]).abs().max())
        mean = float((outs["quarter"] - outs["whole"]).abs().mean())
        report(f"sr_quarters_{decode}", f"TSD-SR 512² -> 2048², {decode} VAE "
               f"decode, one card: tile batches of 2 against 8: max|d| {err} "
               f"mean|d| {mean} ({outs['quarter_s']:.2f}s against "
               f"{outs['whole_s']:.2f}s)", max_abs_err=err, mean_abs_err=mean)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="serve",
                    choices=["serve", "int8", "http", "train", "train-zero",
                             "sr-quarters"])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", default="multi_gpu.json")
    args = ap.parse_args(argv)
    # the ZeRO mesh's per-rank state is close to one card's memory
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    mesh = make_mesh(device="cuda")
    n, device, root = mesh.world_size, mesh.device, mesh.is_root
    if root:
        cuda_build.build(attn.KERNEL, attn.KERNEL_BWD, attn.KERNEL_QK8)
    dist.barrier()
    report = Report(root, args.out, {"card": card_line(), "world": n})
    if root:
        print(f"[multi] cards:\n{card_line()}\n[multi] torch {torch.__version__}"
              f" cuda {torch.version.cuda}, world {n}, mode {args.mode}",
              flush=True)
    if args.mode in ("train", "train-zero"):
        training(report, n, device,
                 parts=("zero",) if args.mode == "train-zero" else ("lora", "zero"))
    elif args.mode == "sr-quarters":
        with torch.no_grad():
            sr_quarters(report, device)
    elif args.mode == "int8":
        with torch.no_grad():
            int8_jobs(report, n, device, args.steps)
    elif args.mode == "http":
        with torch.no_grad():
            http_serve(report, n, device, args.steps)
    else:
        with torch.no_grad():
            forwards(report, n, device)
            torch.cuda.empty_cache()
            kernels(report, n, device)
            torch.cuda.empty_cache()
            job(report, n, device, args.steps)
            torch.cuda.empty_cache()
            sr_stage(report, n, device)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
