#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``unitex_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fenced by ``torch.cuda.synchronize()``; any failure exits
non-zero:

1. card: name and power limit (``nvidia-smi``);
2. build: the hand-written kernels of both paths, one ``nvcc`` per source
   from the checkout, all started together, with ptxas' register and
   spill report of each kernel;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the paths give it (q/k/v/dO [1, S, 24, 128] bf16 at
   S = 13824 and 12800, plus a ragged S = 1000), with its time, the plain
   version's, one PyTorch library call's (a yardstick only) and the
   bound: flash attention B1 held to max|dout| <= min(2e-2, 2 % of
   max|ref|) and max|dlse| <= 1e-3; its backward B2a (dK, dV) and B2b (dQ)
   to max|d| <= 2 % of max|ref| for each gradient;
4. serving path: ``CustomRGBTextureFullPipeline(random_weights=True)`` at
   full FLUX.1-dev width and depth with the FLUX VAE answers two jobs
   (a 20,480-face icosphere and a torus, synthetic reference images) on
   ``DEFAULT_CONFIG`` with ``num_inference_steps=4`` instead of 28 to fit
   the time limit; each job must write its GLB, bake a finite 2048²
   texture and launch B1 exactly 57 x 4 x 2 = 456 times;
5. training path: three FLUX.1-dev LoRA ``train_step``s (rank 16, remat,
   constant lr 1e-4) on the serving pipeline's resident base tree, each on
   one ``SyntheticTextureDataset(view_size=512)`` batch built by the
   launcher's ``build_batch`` (S = 512 + 6144 + 6144 = 12800 tokens); each
   step must give a finite loss and launch B1 114 times (57 forward + 57
   recomputed) and B2a and B2b 57 times each, the first must move the
   LoRA ``b`` leaves off 0, and the peak must stay under 80 GB.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or run outside
a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12           # H100 SXM HBM3 bandwidth
ATTN_SHAPES = (13824, 12800, 1000)
# B1 against its f32 plain version on unit-normal bf16 inputs.  The output
# is held to 2 % of the largest reference value and never more than 2e-2:
# the bf16 rounding of out and of P alone stays below 2**-8 of it, while a
# P·V fault such as a missed rescale moves out by tens of per cent.
OUT_TOL, OUT_REL, LSE_TOL = 2e-2, 2e-2, 1e-3
# B2a/B2b against their f32 plain version on the same bf16 inputs: each of
# dq, dk, dv within 2 % of its largest reference value.  Rounding P and dS
# to bf16 costs about 2**-9 of an element; a dropped scale (x11.3) or a
# missing - Drow moves the gradients far past 2 %.
GRAD_REL = 2e-2
STEPS = 4
TRAIN_STEPS = 3
TRAIN_S = 12800          # 512 text + 6144 noise + 6144 control tokens
PEAK_LIMIT = 80e9        # bytes: one H100


def ptxas_usage(log_path: str):
    """(kernel, "N registers, S bytes spill stores, L bytes spill loads")
    for each kernel that ptxas reports in ``log_path``."""
    out, fn, spill = [], None, ""
    with open(log_path) as f:
        for ln in f:
            if "Compiling entry function" in ln:
                fn = next((n for n in ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                                       "flash_bwd_dq_kernel") if n in ln), ln)
            elif "spill stores" in ln:
                spill = ln.split(":", 1)[-1].strip() if ":" in ln else ln.strip()
            elif "registers" in ln and fn is not None:
                out.append((fn, f"{ln.split(':', 1)[-1].strip()}; {spill}"))
                fn = None
    return out


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn()`` over ``iters`` launches, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_flash_attention(attn, torch) -> dict:
    """B1 against ``attention_reference`` (f32 on the same bf16 inputs)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, D = 1, 24, 128
    record = None
    worst = 0.0
    for S in ATTN_SHAPES:
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        out, lse = attn.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err_o = err_l = ref_max = 0.0
        for h in range(H):  # per head: the f32 logits of all heads are 18 GB
            sl = slice(h, h + 1)
            ro, rl = attn.attention_reference(
                q[:, :, sl].float(), k[:, :, sl].float(), v[:, :, sl].float())
            err_o = max(err_o, (out[:, :, sl].float() - ro).abs().max().item())
            err_l = max(err_l, (lse[h] - rl[0]).abs().max().item())
            ref_max = max(ref_max, ro.abs().max().item())
        torch.cuda.synchronize()
        out_tol = min(OUT_TOL, OUT_REL * ref_max)
        if not (err_o <= out_tol and err_l <= LSE_TOL):
            raise AssertionError(
                f"flash_attention S={S}: max|dout|={err_o} (tol {out_tol}), "
                f"max|dlse|={err_l} (tol {LSE_TOL})")
        worst = max(worst, err_o)
        iters = 20 if S > 5000 else 50

        def plain():
            for h in range(H):
                sl = slice(h, h + 1)
                attn.attention_reference(q[:, :, sl].float(), k[:, :, sl].float(),
                                         v[:, :, sl].float())

        ms = cuda_ms(lambda: attn.flash_attention(q, k, v), iters)
        plain_ms = cuda_ms(plain, 2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
        flops = 4 * B * H * S * S * D
        nbytes = 4 * B * S * H * D * 2 + B * H * S * 4
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        print(f"[kernels] flash_attn_fwd S={S}: ms={ms:.4f} plain_ms="
              f"{plain_ms:.3f} library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({flops / ms / 1e9:.1f} TFLOP/s) max|dout|={err_o:.3e} "
              f"(tol {out_tol:.3e}, max|ref|={ref_max:.3e}) "
              f"max|dlse|={err_l:.3e}", flush=True)
        if S == ATTN_SHAPES[0]:
            record = {
                "name": "flash_attn_fwd", "route": "cuda",
                "source": "unitex_torch/csrc/flash_attn_fwd.cu",
                "replaces": "unitex_tpu/ops/attention.py:49",
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "operations" if flops / PEAK_BF16_FLOPS
                >= nbytes / PEAK_BYTES else "bytes",
                "library_ms": lib_ms,
            }
        del q, k, v, out, lse
    record["max_abs_err"] = worst
    return record


def check_flash_backward(attn, torch) -> list:
    """B2a and B2b against the plain backward (f32 on the same bf16 inputs,
    one head at a time), on out and lse from B1."""
    import torch.nn.functional as F

    assert not torch.backends.cuda.matmul.allow_tf32  # the f32 reference
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, H, D = 1, 24, 128
    records = {}
    worst = {"dkv": 0.0, "dq": 0.0}
    for S in ATTN_SHAPES:
        q, k, v, g = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                      .to(torch.bfloat16) for _ in range(4))
        out, lse = attn.flash_attention(q, k, v)
        drow = attn._row_dot(g, out)
        dk, dv = attn.flash_attention_bwd_dkv(q, k, v, g, lse, drow)
        dq = attn.flash_attention_bwd_dq(q, k, v, g, lse, drow)
        torch.cuda.synchronize()
        got = {"dq": dq, "dk": dk, "dv": dv}
        err = dict.fromkeys(got, 0.0)
        ref_max = dict.fromkeys(got, 0.0)

        def plain_head(h):
            sl = slice(h, h + 1)
            return dict(zip(("dq", "dk", "dv"), attn.attention_backward_reference(
                q[:, :, sl].float(), k[:, :, sl].float(), v[:, :, sl].float(),
                out[:, :, sl].float(), lse[h:h + 1], g[:, :, sl].float())))

        for h in range(H):  # per head: the f32 S×S temporaries of all heads
            ref = plain_head(h)
            for name, x in got.items():
                err[name] = max(err[name], (x[:, :, h:h + 1].float() - ref[name])
                                .abs().max().item())
                ref_max[name] = max(ref_max[name], ref[name].abs().max().item())
        torch.cuda.synchronize()
        bad = [n for n in got if not err[n] <= GRAD_REL * ref_max[n]]
        if bad:
            raise AssertionError(
                f"flash backward S={S}: " + ", ".join(
                    f"max|d{n}|={err[n]:.3e} (tol {GRAD_REL * ref_max[n]:.3e})"
                    for n in got))
        worst["dkv"] = max(worst["dkv"], err["dk"], err["dv"])
        worst["dq"] = max(worst["dq"], err["dq"])
        iters = 10 if S > 5000 else 50
        ms_dkv = cuda_ms(lambda: attn.flash_attention_bwd_dkv(q, k, v, g, lse, drow),
                         iters)
        ms_dq = cuda_ms(lambda: attn.flash_attention_bwd_dq(q, k, v, g, lse, drow),
                        iters)
        plain_ms = cuda_ms(lambda: [plain_head(h) for h in range(H)], 1)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        gt = g.transpose(1, 2)

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qt, kt, vt).backward(gt)
            qt.grad = kt.grad = vt.grad = None

        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                             iters)
        lib_ms = cuda_ms(sdpa_fwd_bwd, iters) - fwd_ms
        bsd = B * S * H * D
        in_bytes = 4 * bsd * 2 + 2 * B * H * S * 4   # q, k, v, dO; lse, Drow
        for name, mult, n_out, ms in (("flash_attn_bwd_dkv", 8, 2, ms_dkv),
                                      ("flash_attn_bwd_dq", 6, 1, ms_dq)):
            flops = mult * B * H * S * S * D
            nbytes = in_bytes + n_out * bsd * 2
            bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
            print(f"[kernels] {name} S={S}: ms={ms:.4f} bound_ms={bound_ms:.4f} "
                  f"({flops / ms / 1e9:.1f} TFLOP/s)", flush=True)
            if S == TRAIN_S:
                records[name] = {
                    "name": name, "route": "cuda",
                    "source": "unitex_torch/csrc/flash_attn_bwd.cu",
                    "replaces": "unitex_tpu/ops/attention.py:" + (
                        "235" if name.endswith("dkv") else "278"),
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "operations" if flops / PEAK_BF16_FLOPS
                    >= nbytes / PEAK_BYTES else "bytes",
                    "library_ms": lib_ms,
                }
        print(f"[kernels] flash backward S={S}: B2a+B2b={ms_dkv + ms_dq:.4f} ms "
              f"plain_ms={plain_ms:.3f} library_ms (sdpa backward)={lib_ms:.4f} "
              + " ".join(f"max|d{n}|={err[n]:.3e} (tol "
                         f"{GRAD_REL * ref_max[n]:.3e})" for n in got), flush=True)
        del q, k, v, g, out, lse, drow, dq, dk, dv, got, qt, kt, vt, gt
        torch.cuda.empty_cache()
    records["flash_attn_bwd_dkv"]["max_abs_err"] = worst["dkv"]
    records["flash_attn_bwd_dq"]["max_abs_err"] = worst["dq"]
    return [records["flash_attn_bwd_dkv"], records["flash_attn_bwd_dq"]]


def make_assets(d: str):
    """Two jobs: (mesh path, reference image path)."""
    import numpy as np
    from PIL import Image

    from unitex_torch.geometry.io.mesh_io import save_mesh
    from unitex_torch.geometry.primitives import make_icosphere, make_torus

    jobs = []
    for name, mesh, color in (("icosphere", make_icosphere(5), (200, 60, 30)),
                              ("torus", make_torus(), (40, 90, 210))):
        mesh_path = os.path.join(d, f"{name}.obj")
        save_mesh(mesh_path, mesh)
        img = np.full((512, 512, 3), 255, np.uint8)
        yy, xx = np.mgrid[:512, :512]
        img[(yy - 256) ** 2 + (xx - 256) ** 2 < 160 ** 2] = color
        img_path = os.path.join(d, f"{name}.png")
        Image.fromarray(img).save(img_path)
        jobs.append((name, mesh_path, img_path))
    return jobs


def run_main_path(attn, torch):
    """The serving path; returns (B1 launches, the pipeline)."""
    from unitex_torch.config import DEFAULT_CONFIG
    from unitex_torch.pipeline import CustomRGBTextureFullPipeline
    from unitex_torch.utils.timer import CPUTimer

    config = dataclasses.replace(
        DEFAULT_CONFIG,
        diffusion=dataclasses.replace(DEFAULT_CONFIG.diffusion,
                                      num_inference_steps=STEPS))
    per_job = 57 * STEPS * 2
    print(f"[main] DEFAULT_CONFIG with num_inference_steps={STEPS} (28 in "
          f"serving) to fit the time limit; FLUX.1-dev width/depth, random "
          f"weights", flush=True)
    t0 = time.perf_counter()
    pipe = CustomRGBTextureFullPipeline(random_weights=True, config=config,
                                        device="cuda")
    torch.cuda.synchronize()
    print(f"[main] init {time.perf_counter() - t0:.2f}s, params "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    total = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        for name, mesh_path, img_path in make_assets(d):
            out_dir = os.path.join(d, f"out_{name}")
            torch.cuda.reset_peak_memory_stats()
            before = attn.launches
            t0 = time.perf_counter()
            _, glb = pipe(out_dir, img_path, mesh_path)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = attn.launches - before
            total += n
            rec = CPUTimer.records
            stages = {
                "preprocess": rec["preprocess_blank_mesh"]
                + rec["preprocess_reference_image"],
                "render_geometry": rec["render_geometry_images"],
                "infer_mv": rec["infer_mv"],
                "reproject": rec["reproject_and_query_field"],
            }
            tex = pipe.last_texture
            print(f"[main] job {name}: wall {wall:.2f}s stages "
                  + " ".join(f"{k}={v:.3f}s" for k, v in stages.items())
                  + f" peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
                  f" flash_attn_fwd launches {n}", flush=True)
            if not os.path.exists(glb):
                raise AssertionError(f"job {name}: no GLB at {glb}")
            if tuple(tex.shape) != (2048, 2048, 3) or not bool(
                    torch.isfinite(tex).all()):
                raise AssertionError(
                    f"job {name}: texture {tuple(tex.shape)} not a finite 2048²")
            if n != per_job:
                raise AssertionError(
                    f"job {name}: {n} flash_attn_fwd launches, expected {per_job}")
    return total, pipe


def _counts(attn) -> tuple:
    return attn.launches, attn.launches_bwd_dkv, attn.launches_bwd_dq


def run_training(attn, torch, pipe) -> None:
    """Three full-width LoRA train steps on the pipeline's base tree."""
    from unitex_torch.scripts.train_flux_lora import build_batch
    from unitex_torch.training.data import SyntheticTextureDataset
    from unitex_torch.training.flux_lora import (
        FluxLoraTrainConfig,
        create_train_state,
        train_step,
    )

    cfg = dataclasses.replace(pipe.flux_cfg, remat=True)
    tcfg = FluxLoraTrainConfig(rank=16, learning_rate=1e-4,
                               lr_scheduler="constant")
    n_blocks = cfg.num_layers + cfg.num_single_layers
    want = (2 * n_blocks, n_blocks, n_blocks)
    t0 = time.perf_counter()
    state, tx = create_train_state(torch.Generator(device="cuda").manual_seed(5),
                                   pipe.transformer_params, tcfg, device="cuda")
    data = iter(SyntheticTextureDataset(view_size=512, seed=0, device="cuda"))
    seq_e = torch.zeros((512, cfg.joint_attention_dim), device="cuda")
    pooled_e = torch.zeros((cfg.pooled_projection_dim,), device="cuda")
    torch.cuda.synchronize()
    print(f"[train] FluxConfig.flux1_dev() remat=True, LoRA rank 16 "
          f"({sum(x.numel() for _, x in _named_leaves(state.lora)) / 1e6:.1f} M f32 "
          f"parameters), constant lr 1e-4; set-up {time.perf_counter() - t0:.2f}s",
          flush=True)
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        batch = build_batch([next(data)], pipe.vae_params, pipe.vae_cfg, seq_e,
                            pooled_e)
        S = seq_e.shape[0] + batch["latents"].shape[1] * batch["latents"].shape[2] \
            // 4 + batch["cond_tokens"].shape[1]
        torch.cuda.synchronize()
        t_data = time.perf_counter() - t0
        if S != TRAIN_S:
            raise AssertionError(f"training sequence {S} tokens, expected {TRAIN_S}")
        torch.cuda.reset_peak_memory_stats()
        before = _counts(attn)
        t0 = time.perf_counter()
        state, loss = train_step(state, pipe.transformer_params, batch,
                                 torch.Generator(device="cuda").manual_seed(1000 + step),
                                 cfg, tcfg, tx)
        loss = float(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = tuple(a - b for a, b in zip(_counts(attn), before))
        peak = torch.cuda.max_memory_allocated()
        b_max = max(float(leaf.detach().abs().max()) for path, leaf in
                    _named_leaves(state.lora) if path.endswith("/b"))
        print(f"[train] step {step}: loss {loss:.6f} step {wall:.3f}s "
              f"(batch {t_data:.3f}s) peak {peak / 2**30:.2f} GiB launches "
              f"B1/B2a/B2b {n[0]}/{n[1]}/{n[2]} max|lora b| {b_max:.3e}",
              flush=True)
        if not math.isfinite(loss):
            raise AssertionError(f"train step {step}: loss {loss}")
        if n != want:
            raise AssertionError(f"train step {step}: launches {n}, expected {want}")
        if peak >= PEAK_LIMIT:
            raise AssertionError(f"train step {step}: peak {peak} bytes")
        if b_max == 0.0:
            raise AssertionError(f"train step {step}: the LoRA b leaves are still 0")


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "unitex_torch", "csrc")):
        return fail("run from a checkout of the repository (unitex_torch/ "
                    "not found beside chip_smoke.py)")
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this script runs only on the GPU")
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    from unitex_torch.ops import attention as attn
    from unitex_torch.utils import cuda_build

    t0 = time.perf_counter()
    nvcc_s = cuda_build.build(attn.KERNEL, attn.KERNEL_BWD)
    print(f"[build] {time.perf_counter() - t0:.2f}s " + " ".join(
        f"{k}={v:.2f}s" for k, v in nvcc_s.items()), flush=True)
    for source in nvcc_s:
        for fn, usage in ptxas_usage(cuda_build.library_path(source) + ".log"):
            print(f"[build] {source} {fn} ptxas: {usage}", flush=True)

    records = [check_flash_attention(attn, torch)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    records += check_flash_backward(attn, torch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    attn.launches = attn.launches_bwd_dkv = attn.launches_bwd_dq = 0
    launches, pipe = run_main_path(attn, torch)
    torch.cuda.synchronize()
    serve = _counts(attn)
    if launches != serve[0] or launches == 0 or serve[1:] != (0, 0):
        return fail(f"launches B1/B2a/B2b {serve} on the serving path")
    torch.cuda.empty_cache()

    attn.launches = attn.launches_bwd_dkv = attn.launches_bwd_dq = 0
    run_training(attn, torch, pipe)
    torch.cuda.synchronize()
    train = _counts(attn)
    if 0 in train:
        return fail(f"launches B1/B2a/B2b {train} on the training path")
    print(f"[train] launches B1/B2a/B2b {train[0]}/{train[1]}/{train[2]} in "
          f"{TRAIN_STEPS} steps", flush=True)

    for rec, n_serve, n_train in zip(records, serve, train):
        rec["launches"] = n_serve + n_train
        rec["launches_by_path"] = {"serve": n_serve, "train": n_train}
    keys = ("ms", "plain_ms", "bound_ms", "max_abs_err", "library_ms")
    bad = [r for r in records if not all(
        isinstance(r[k], (int, float)) and math.isfinite(r[k]) for k in keys)]
    if bad:
        return fail(f"bad kernel records {bad}")
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
