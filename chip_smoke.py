#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``unitex_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fenced by ``torch.cuda.synchronize()``; any failure exits
non-zero:

1. card: name and power limit (``nvidia-smi``);
2. build: the hand-written kernels of the three paths, one ``nvcc`` per
   source from the checkout, all started together, with ptxas' register
   and spill report of each kernel;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the paths give it (q/k/v/dO [1, S, 24, 128] bf16 at
   S = 13824 and 12800, plus a ragged S = 1000), with its time, the plain
   version's, one PyTorch library call's (a yardstick only) and the
   bound: flash attention B1 held to max|dout| <= min(2e-2, 2 % of
   max|ref|) and max|dlse| <= 1e-3, its line also giving the share of its
   bound, its time over the library call's and its ptxas report; its
   backward B2a (dK, dV) and B2b (dQ) to max|d| <= 2 % of max|ref| for
   each gradient, each kernel's line giving its share of the bound and its
   ptxas report, and the pair's line its time over the library's backward;
   the int8-QK forward B3,
   on q/k quantized by ``quant_rows``, to max|dout| <= min(2e-2, 2 % of
   max|ref|) against its plain version on the same int8 inputs; and one
   W8A8 projection ([13312, 3072] @ [3072, 12288], ``torch._int_mm``)
   timed beside the same product in bf16 (context, not a gate);
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
   LoRA ``b`` leaves off 0, and the peak must stay under 80 GB;
6. int8 serving path: the bf16 pipeline is freed, then
   ``CustomRGBTextureFullPipeline(int8_serving=True, random_weights=True)``
   (W8A8 FLUX.1-dev, each bf16 kernel dropped as it is quantized) with
   ``attn_qk8=True`` set on its ``flux_cfg`` answers the icosphere job on
   the same 4-step config: a GLB and a finite 2048² texture, 456 launches
   of B3 and none of B1, the peak under 80 GB.

The output ends with three lines: the kernels' JSON record
(``{"kernels": [...]}``), the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or run
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12        # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12           # H100 SXM HBM3 bandwidth
# exp2 on the SFUs: 16 a clock on each of 132 SMs at the 1.98 GHz boost
# clock (a second bound for attention, beside the tensor cores)
SFU_EXP_RATE = 132 * 16 * 1.98e9
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


KERNEL_FUNCTIONS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                    "flash_bwd_dq_kernel", "flash_qk8_kernel")


def ptxas_usage(log_path: str):
    """(kernel, "Used N registers, ...; S bytes spill stores, L bytes spill
    loads") for each kernel that ptxas reports in ``log_path`` (nvcc's
    ``-Xptxas -v`` output), with "; wgmma serialized (C7512)" appended
    where ptxas serialized the kernel's wgmma products.  A kernel of
    ``KERNEL_FUNCTIONS`` is named by that name, any other by its line."""
    with open(log_path) as f:
        lines = f.read().splitlines()

    def kernel(ln):
        return next((n for n in KERNEL_FUNCTIONS if n in ln), None)

    serialized = {kernel(ln) for ln in lines if "C7512" in ln}
    out, fn, spill = [], None, ""
    for ln in lines:
        if "Compiling entry function" in ln:
            fn, spill = kernel(ln) or ln.strip(), ""
        elif "spill stores" in ln:
            spill = ln.split(":", 1)[-1].strip() if ":" in ln else ln.strip()
        elif "Used" in ln and "registers" in ln and fn is not None:
            note = "; wgmma serialized (C7512)" if fn in serialized else ""
            out.append((fn, f"{ln.split(':', 1)[-1].strip()}; {spill}{note}"))
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


def check_flash_attention(attn, torch, ptxas: str) -> dict:
    """B1 against ``attention_reference`` (f32 on the same bf16 inputs);
    ``ptxas`` is its kernel's register and spill report, printed beside
    each time."""
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
              f"({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of the "
              f"bound, {ms / lib_ms:.3f}x the library's time) max|dout|="
              f"{err_o:.3e} (tol {out_tol:.3e}, max|ref|={ref_max:.3e}) "
              f"max|dlse|={err_l:.3e}; ptxas: {ptxas}", flush=True)
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


def check_flash_backward(attn, torch, ptxas: dict) -> list:
    """B2a and B2b against the plain backward (f32 on the same bf16 inputs,
    one head at a time), on out and lse from B1; ``ptxas`` maps each
    kernel function to its register and spill report."""
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
        for name, fn, mult, n_out, ms in (
                ("flash_attn_bwd_dkv", "flash_bwd_dkv_kernel", 8, 2, ms_dkv),
                ("flash_attn_bwd_dq", "flash_bwd_dq_kernel", 6, 1, ms_dq)):
            flops = mult * B * H * S * S * D
            nbytes = in_bytes + n_out * bsd * 2
            bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
            print(f"[kernels] {name} S={S}: ms={ms:.4f} bound_ms={bound_ms:.4f} "
                  f"({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of the "
                  f"bound); ptxas: {ptxas[fn]}", flush=True)
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
              f"({(ms_dkv + ms_dq) / lib_ms:.3f}x the library's time) "
              + " ".join(f"max|d{n}|={err[n]:.3e} (tol "
                         f"{GRAD_REL * ref_max[n]:.3e})" for n in got), flush=True)
        del q, k, v, g, out, lse, drow, dq, dk, dv, got, qt, kt, vt, gt
        torch.cuda.empty_cache()
    records["flash_attn_bwd_dkv"]["max_abs_err"] = worst["dkv"]
    records["flash_attn_bwd_dq"]["max_abs_err"] = worst["dq"]
    return [records["flash_attn_bwd_dkv"], records["flash_attn_bwd_dq"]]


def check_flash_qk8(attn, torch) -> dict:
    """B3 against ``attention_qk8_reference`` (f32, on the same int8 q/k
    and row scales from ``quant_rows``, and the same bf16 v)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    B, H, D = 1, 24, 128
    record = None
    worst = 0.0
    for S in ATTN_SHAPES:
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        qq, sq = attn.quant_rows(q)
        kq, sk = attn.quant_rows(k)
        out = attn.flash_attention_qk8(qq, kq, v, sq, sk)
        torch.cuda.synchronize()

        def plain_head(h):
            sl = slice(h, h + 1)
            return attn.attention_qk8_reference(
                qq[:, :, sl], kq[:, :, sl], v[:, :, sl].float(), sq[:, :, sl],
                sk[:, :, sl])

        err = ref_max = 0.0
        for h in range(H):  # per head: the f32 logits of all heads are 18 GB
            ro = plain_head(h)
            err = max(err, (out[:, :, h:h + 1].float() - ro).abs().max().item())
            ref_max = max(ref_max, ro.abs().max().item())
        torch.cuda.synchronize()
        out_tol = min(OUT_TOL, OUT_REL * ref_max)
        if not err <= out_tol:
            raise AssertionError(
                f"flash_attention_qk8 S={S}: max|dout|={err} (tol {out_tol})")
        worst = max(worst, err)
        iters = 20 if S > 5000 else 50
        ms = cuda_ms(lambda: attn.flash_attention_qk8(qq, kq, v, sq, sk), iters)
        plain_ms = cuda_ms(lambda: [plain_head(h) for h in range(H)], 2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                          iters)
        ops = 2 * B * H * S * S * D          # Q·Kᵀ in int8, and P·V in bf16
        t_ops = ops / PEAK_INT8_OPS + ops / PEAK_BF16_FLOPS
        nbytes = 2 * B * S * H * D + 2 * B * S * H * D * 2 + 2 * B * S * H * 4
        bound_ms = max(t_ops, nbytes / PEAK_BYTES) * 1e3
        sfu_ms = B * H * S * S / SFU_EXP_RATE * 1e3
        print(f"[kernels] flash_attn_qk8 S={S}: ms={ms:.4f} bound_ms="
              f"{bound_ms:.4f} (tensor cores; exp2 on the SFUs {sfu_ms:.4f}) "
              f"plain_ms={plain_ms:.3f} max_abs_err={err:.3e} (tol "
              f"{out_tol:.3e}, max|ref|={ref_max:.3e}); no library call "
              f"computes int8-QK attention, bf16 scaled_dot_product_attention "
              f"(not the same function) {sdpa_ms:.4f} ms", flush=True)
        if S == ATTN_SHAPES[0]:
            record = {
                "name": "flash_attn_qk8", "route": "cuda",
                "source": "unitex_torch/csrc/flash_attn_qk8.cu",
                "replaces": "unitex_tpu/ops/attention.py:420",
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "operations" if t_ops >= nbytes / PEAK_BYTES
                else "bytes",
                "library_ms": None,
            }
        del q, k, v, qq, kq, sq, sk, out, qt, kt, vt
        torch.cuda.empty_cache()
    record["max_abs_err"] = worst
    return record


def time_w8a8(torch) -> None:
    """One W8A8 projection of the int8 path (activation quantization, the
    int8 GEMM, the dequant epilogue) against the same product in bf16, and
    the int8 GEMM alone in both layouts of its second operand."""
    from unitex_torch.ops.quant import int8_matmul, quantize_kernel

    gen = torch.Generator(device="cuda").manual_seed(3)
    M, K, N = 13312, 3072, 12288   # the image tokens through ff.in
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5).to(
        torch.bfloat16)
    wq, ws = quantize_kernel(w)
    xq = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                       dtype=torch.int8)
    wq_rows = wq.contiguous()  # the other layout: d_out contiguous
    w8a8_ms = cuda_ms(lambda: int8_matmul(x, wq, ws), 20)
    gemm_ms = cuda_ms(lambda: torch._int_mm(xq, wq), 20)
    gemm_rows_ms = cuda_ms(lambda: torch._int_mm(xq, wq_rows), 20)
    bf16_ms = cuda_ms(lambda: x @ w, 20)
    rel = ((int8_matmul(x, wq, ws).float() - (x @ w).float()).norm()
           / (x @ w).float().norm()).item()
    print(f"[w8a8] [{M}, {K}] @ [{K}, {N}]: int8_matmul {w8a8_ms:.4f} ms "
          f"(int8 GEMM alone {gemm_ms:.4f} ms with the kernel stored d_in-"
          f"contiguous, {gemm_rows_ms:.4f} ms stored d_out-contiguous; bound "
          f"{2 * M * K * N / PEAK_INT8_OPS * 1e3:.4f} ms), bf16 {bf16_ms:.4f} "
          f"ms (bound {2 * M * K * N / PEAK_BF16_FLOPS * 1e3:.4f} ms); rel L2 "
          f"W8A8 vs bf16 {rel:.3e}", flush=True)


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
    """Launches of B1, B2a, B2b and B3."""
    return (attn.launches, attn.launches_bwd_dkv, attn.launches_bwd_dq,
            attn.launches_qk8)


def _reset(attn) -> None:
    attn.launches = attn.launches_bwd_dkv = attn.launches_bwd_dq = 0
    attn.launches_qk8 = 0


def _tree_bytes(tree) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in _named_leaves(tree))


def run_int8_path(attn, torch) -> None:
    """One full-width int8 serving job (W8A8, int8-QK attention)."""
    from unitex_torch.config import DEFAULT_CONFIG
    from unitex_torch.ops.quant import count_quantized
    from unitex_torch.pipeline import CustomRGBTextureFullPipeline
    from unitex_torch.utils.timer import CPUTimer

    config = dataclasses.replace(
        DEFAULT_CONFIG,
        diffusion=dataclasses.replace(DEFAULT_CONFIG.diffusion,
                                      num_inference_steps=STEPS))
    per_job = 57 * STEPS * 2
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = CustomRGBTextureFullPipeline(int8_serving=True, random_weights=True,
                                        config=config, device="cuda")
    pipe.flux_cfg = dataclasses.replace(pipe.flux_cfg, attn_qk8=True)
    torch.cuda.synchronize()
    n_q, n_f = count_quantized(pipe.transformer_params)
    print(f"[int8] init (bf16 random init + W8A8 quantization) "
          f"{time.perf_counter() - t0:.2f}s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; serving tree "
          f"{_tree_bytes(pipe.transformer_params) / 2**30:.2f} GiB ({n_q / 1e9:.3f} "
          f"G int8 elements, {n_f / 1e9:.3f} G float elements in leaves of 2+ "
          f"axes); attn_qk8=True", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as d:
        name, mesh_path, img_path = make_assets(d)[0]
        torch.cuda.reset_peak_memory_stats()
        before = _counts(attn)
        t0 = time.perf_counter()
        _, glb = pipe(os.path.join(d, "out"), img_path, mesh_path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = tuple(a - b for a, b in zip(_counts(attn), before))
        peak = torch.cuda.max_memory_allocated()
        rec = CPUTimer.records
        stages = {
            "preprocess": rec["preprocess_blank_mesh"]
            + rec["preprocess_reference_image"],
            "render_geometry": rec["render_geometry_images"],
            "infer_mv": rec["infer_mv"],
            "reproject": rec["reproject_and_query_field"],
        }
        tex = pipe.last_texture
        print(f"[int8] job {name}: wall {wall:.2f}s stages "
              + " ".join(f"{k}={v:.3f}s" for k, v in stages.items())
              + f" peak {peak / 2**30:.2f} GiB launches B3 {n[3]} B1 {n[0]}",
              flush=True)
        if not os.path.exists(glb):
            raise AssertionError(f"int8 job {name}: no GLB at {glb}")
        if tuple(tex.shape) != (2048, 2048, 3) or not bool(
                torch.isfinite(tex).all()):
            raise AssertionError(
                f"int8 job {name}: texture {tuple(tex.shape)} not a finite 2048²")
        if n != (0, 0, 0, per_job):
            raise AssertionError(
                f"int8 job {name}: launches B1/B2a/B2b/B3 {n}, expected "
                f"(0, 0, 0, {per_job})")
        if peak >= PEAK_LIMIT:
            raise AssertionError(f"int8 job {name}: peak {peak} bytes")


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
    want = (2 * n_blocks, n_blocks, n_blocks, 0)
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
              f"B1/B2a/B2b/B3 {n[0]}/{n[1]}/{n[2]}/{n[3]} max|lora b| "
              f"{b_max:.3e}", flush=True)
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
    nvcc_s = cuda_build.build(attn.KERNEL, attn.KERNEL_BWD, attn.KERNEL_QK8)
    print(f"[build] {time.perf_counter() - t0:.2f}s " + " ".join(
        f"{k}={v:.2f}s" for k, v in nvcc_s.items()), flush=True)
    usage = {}
    for source in nvcc_s:
        for fn, use in ptxas_usage(cuda_build.library_path(source) + ".log"):
            print(f"[build] {source} {fn} ptxas: {use}", flush=True)
            usage[fn] = use

    records = [check_flash_attention(attn, torch, usage["flash_fwd_kernel"])]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    records += check_flash_backward(attn, torch, usage)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    records.append(check_flash_qk8(attn, torch))
    time_w8a8(torch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    _reset(attn)
    launches, pipe = run_main_path(attn, torch)
    torch.cuda.synchronize()
    serve = _counts(attn)
    if launches != serve[0] or launches == 0 or serve[1:] != (0, 0, 0):
        return fail(f"launches B1/B2a/B2b/B3 {serve} on the serving path")
    torch.cuda.empty_cache()

    _reset(attn)
    run_training(attn, torch, pipe)
    torch.cuda.synchronize()
    train = _counts(attn)
    if 0 in train[:3] or train[3] != 0:
        return fail(f"launches B1/B2a/B2b/B3 {train} on the training path")
    print(f"[train] launches B1/B2a/B2b {train[0]}/{train[1]}/{train[2]} in "
          f"{TRAIN_STEPS} steps", flush=True)

    # the int8 job needs the card to itself: drop the bf16 tree first
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    _reset(attn)
    run_int8_path(attn, torch)
    torch.cuda.synchronize()
    int8 = _counts(attn)
    if int8[3] == 0 or int8[:3] != (0, 0, 0):
        return fail(f"launches B1/B2a/B2b/B3 {int8} on the int8 serving path")

    for rec, n_serve, n_train, n_int8 in zip(records, serve, train, int8):
        rec["launches"] = n_serve + n_train + n_int8
        rec["launches_by_path"] = {"serve": n_serve, "train": n_train,
                                   "int8_serve": n_int8}
    keys = ("ms", "plain_ms", "bound_ms", "max_abs_err", "library_ms")
    bad = [r for r in records if not all(
        (k == "library_ms" and r[k] is None)
        or (isinstance(r[k], (int, float)) and math.isfinite(r[k]))
        for k in keys)]
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
