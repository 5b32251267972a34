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
   max|ref|) against its plain version on the same int8 inputs, its line
   also giving its share of the bound, its time over B1's in the same run,
   the time of ``quant_rows`` of q and k and of both with B3 (what
   ``attention(qk8=True)`` launches) over B1's, and its ptxas report; B1
   at D = 64 (its second instantiation, the SD3 transformer's heads) at
   [8, 1178, 24, 64] and [6, 1178, 24, 64] (the TSD-SR grid's tile
   calls), held to the same tolerances, its bound the larger of the
   tensor-core, SFU (exp) and memory times; and one
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
6. checkpoint: the serving pipeline's base transformer is written under
   the diffusers names into ``<tmp>/flux/transformer/`` in shards of at
   most 5 GB, its VAE into ``<tmp>/flux/vae/``, its two adapters with
   ``save_lora_safetensors`` as ``<tmp>/{texture,delight}_lora
   .safetensors``; ``load_flux_transformer``, ``load_vae`` and
   ``load_lora_safetensors`` read them back onto the card, and every leaf
   must be ``torch.equal`` to the resident one; then the bf16 pipeline and
   the loaded copy are freed, and a random SD3-medium transformer (bf16)
   and SD3 VAE (f32), seeded, are written under the diffusers names into
   ``<tmp>/sd3/{transformer,vae}`` and read back leaf for leaf;
7. CLI: ``unitex_torch.run.main`` in process on the icosphere job with
   ``--pretrain-models <tmp> --fast-steps 8 --super-resolution`` and
   otherwise the CLI's defaults (``DEFAULT_CONFIG``'s 28 steps, video
   export on): exactly 57 x 20 x 2 = 2280 launches of B1 (8 of the 28
   steps reuse the velocity), 16 x 24 = 384 of B1 at D = 64 (TSD-SR: 126
   latent tiles of the 2x3 grid in 16 transformer calls of SD3-medium's
   24 layers) and none of B3, ``mv_rgb_lr.png`` (1024 x 1536) and
   ``mv_rgb.png`` (4096 x 6144), ``rembg_image.png`` and a GLB whose
   texture, read back with ``load_mesh``, is a finite 2048² image, a
   video of 120 frames of 1024², the peak under 80 GB; its ``[sr]`` line
   splits the SR stage into upscale, encode, transformer, decode and
   colour fix and gives the bake's seconds on the 2048² views;
8. int8 serving path from the checkpoint:
   ``CustomRGBTextureFullPipeline(int8_serving=True, pretrain_models=<tmp>)``
   (W8A8 FLUX.1-dev, each bf16 kernel dropped as it is quantized) with
   ``attn_qk8=True`` set on its ``flux_cfg`` answers the icosphere job on
   the 4-step config: a GLB and a finite 2048² texture, 456 launches of B3
   and none of B1, the peak under 80 GB;
11. SR options (after phase 8, from ``<tmp>/sd3``): one 512² view
   through ``TSDSRPipeline`` in bf16 and with ``TSDSRConfig(
   int8_serving=True, host_params=True, stage_pack_int4=True)``, each a
   finite 2048² image with 4 x 24 = 96 launches of B1 at D = 64, the
   staging seconds and the staged tree's bytes printed, and the PSNR
   between the two (random weights: printed, not gated).  ``<tmp>`` is
   then deleted;
9. LTM path (run between phases 5 and 6, on the serving phase's resident
   FLUX trees, so FLUX.1-dev is initialized once):
   ``RGBTextureFullPipeline(ltm_params=<repo>/ltm_params.npz)`` (the
   trained ``LTMConfig.large()``) answers two jobs on the 4-step config:
   the cup (``make_cup()``, 18,816 faces), whose chart is under 0.93
   visible, so the LTM field fills it; and the icosphere, at or above 0.93
   visible the k=8 fill with 50 relaxation passes, else (the gradient
   filter trims every silhouette) run again with ``ltm_auto=0.0``, which
   forces that branch, said on its line.  Each job must write its GLB and
   ``completed_uv.png``, bake a finite 2048² texture and launch B1 exactly
   456 times; its line gives the branch, the visible fraction, the
   ``reproject_and_query_field`` seconds split into the LTM encode, the
   decode and the rest, and the peak;
10. texture round trip (no FLUX): ``unitex_torch/scripts/oracle_campaign``
   at 512² views and a 2048² atlas on the cup and the trefoil
   (``make_trefoil(n_major=384, n_minor=40)``) with ``ORACLE_r05.json``'s
   three option sets (priority paste and k=1; cosine paste, k=8 and 50
   relaxation passes; cosine paste and the LTM of ``ltm_params.npz``),
   each score printed beside the JAX package's recorded one; the LTM set
   must beat the k=8 set in ``texture_psnr_all`` on both meshes.  On the
   cup also the priority k=1 bake with ``low_hbm=True`` (its texture
   within 1e-6 of the plain bake's) and one ``reproject_blending`` and one
   ``kdtree`` bake (a finite texture, their seconds).

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
import glob
import json
import math
import os
import re
import shutil
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
FAST_STEPS = 8           # the CLI job's --fast-steps
PEAK_LIMIT = 80e9        # bytes: one H100


KERNEL_FUNCTIONS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                    "flash_bwd_dq_kernel", "flash_qk8_kernel")
# B1 at the SD3 transformer's head width: 24 heads of 64, S = 32² latent
# patches + 154 prompt tokens; batches of 8 latent tiles and the 2x3 grid's
# last chunk of 6
SD3_H, SD3_D, SD3_S = 24, 64, 32 * 32 + 154
SD3_BATCHES = (8, 6)


def ptxas_usage(log_path: str):
    """(kernel, "Used N registers, ...; S bytes spill stores, L bytes spill
    loads") for each kernel that ptxas reports in ``log_path`` (nvcc's
    ``-Xptxas -v`` output), with "; wgmma serialized (C7512)" appended
    where ptxas serialized the kernel's wgmma products.  A kernel of
    ``KERNEL_FUNCTIONS`` is named by that name, an instantiation of a
    template on an int by the name and the int (``flash_fwd_kernel<64>``),
    any other kernel by its line."""
    with open(log_path) as f:
        lines = f.read().splitlines()

    def kernel(ln):
        name = next((n for n in KERNEL_FUNCTIONS if n in ln), None)
        inst = name and re.search(rf"{name}ILi(\d+)E", ln)
        return f"{name}<{inst.group(1)}>" if inst else name

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


def check_flash_attention(attn, torch, ptxas: str):
    """B1 against ``attention_reference`` (f32 on the same bf16 inputs);
    ``ptxas`` is its kernel's register and spill report, printed beside
    each time.  Returns B1's record and its ms at each S."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, D = 1, 24, 128
    record = None
    worst = 0.0
    ms_at = {}
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

        ms = ms_at[S] = cuda_ms(lambda: attn.flash_attention(q, k, v), iters)
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
    return record, ms_at


def check_flash_attention_d64(attn, torch, ptxas: str) -> dict:
    """B1 at D = 64 (the SD3 transformer's attention in the TSD-SR stage)
    against ``attention_reference`` (f32 on the same bf16 inputs) at
    [B, 1178, 24, 64] for each batch of ``SD3_BATCHES``, with the same
    tolerances as at D = 128.  Its bound is the larger of the tensor-core
    time of 4·B·H·S²·D operations, the SFU time of B·H·S² exponentials and
    the memory time.  Returns its record (the first batch's times)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    H, D, S = SD3_H, SD3_D, SD3_S
    record = None
    worst = 0.0
    for B in SD3_BATCHES:
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        before = (attn.launches, attn.launches_d64)
        out, lse = attn.flash_attention(q, k, v)
        torch.cuda.synchronize()
        if (attn.launches, attn.launches_d64) != (before[0], before[1] + 1):
            raise AssertionError("flash_attention at D = 64 did not count one "
                                 "launch of its D = 64 instantiation")
        ro, rl = attn.attention_reference(q.float(), k.float(), v.float())
        err_o = (out.float() - ro).abs().max().item()
        err_l = (lse - rl).abs().max().item()
        ref_max = ro.abs().max().item()
        out_tol = min(OUT_TOL, OUT_REL * ref_max)
        if not (err_o <= out_tol and err_l <= LSE_TOL):
            raise AssertionError(
                f"flash_attention D=64 B={B}: max|dout|={err_o} (tol "
                f"{out_tol}), max|dlse|={err_l} (tol {LSE_TOL})")
        worst = max(worst, err_o)
        ms = cuda_ms(lambda: attn.flash_attention(q, k, v), 100)
        plain_ms = cuda_ms(
            lambda: attn.attention_reference(q.float(), k.float(), v.float()), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 100)
        flops = 4 * B * H * S * S * D
        t_ops = max(flops / PEAK_BF16_FLOPS, B * H * S * S / SFU_EXP_RATE)
        nbytes = 4 * B * S * H * D * 2 + B * H * S * 4
        bound_ms = max(t_ops, nbytes / PEAK_BYTES) * 1e3
        print(f"[kernels] flash_attn_fwd D=64 [{B}, {S}, {H}, {D}]: ms={ms:.4f} "
              f"plain_ms={plain_ms:.3f} library_ms={lib_ms:.4f} bound_ms="
              f"{bound_ms:.4f} (tensor cores {flops / PEAK_BF16_FLOPS * 1e3:.4f},"
              f" exp on the SFUs {B * H * S * S / SFU_EXP_RATE * 1e3:.4f}, "
              f"memory {nbytes / PEAK_BYTES * 1e3:.4f}; {flops / ms / 1e9:.1f} "
              f"TFLOP/s, {bound_ms / ms:.1%} of the bound, {ms / lib_ms:.3f}x "
              f"the library's time) max|dout|={err_o:.3e} (tol {out_tol:.3e}, "
              f"max|ref|={ref_max:.3e}) max|dlse|={err_l:.3e}; ptxas: {ptxas}",
              flush=True)
        if record is None:
            record = {
                "name": "flash_attn_fwd_d64", "route": "cuda",
                "source": "unitex_torch/csrc/flash_attn_fwd.cu",
                "replaces": "unitex_tpu/ops/attention.py:49",
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "operations" if t_ops >= nbytes / PEAK_BYTES
                else "bytes",
                "library_ms": lib_ms,
            }
        del q, k, v, out, lse, ro, rl, qt, kt, vt
        torch.cuda.empty_cache()
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


def check_flash_qk8(attn, torch, ptxas: str, b1_ms: dict) -> dict:
    """B3 against ``attention_qk8_reference`` (f32, on the same int8 q/k
    and row scales from ``quant_rows``, and the same bf16 v); ``ptxas`` is
    its kernel's register and spill report and ``b1_ms`` B1's ms at each S
    in this run.  Each line also times ``quant_rows`` of q and k, and the
    whole of what ``attention(q, k, v, qk8=True)`` launches (both
    quantizations and B3) against B1."""
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
        quant_ms = cuda_ms(lambda: (attn.quant_rows(q), attn.quant_rows(k)), iters)

        def quantized():
            qq1, sq1 = attn.quant_rows(q)
            kq1, sk1 = attn.quant_rows(k)
            return attn.flash_attention_qk8(qq1, kq1, v, sq1, sk1)

        whole_ms = cuda_ms(quantized, iters)
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
              f"{bound_ms:.4f} (tensor cores; exp2 on the SFUs {sfu_ms:.4f}; "
              f"{bound_ms / ms:.1%} of the bound, {ms / b1_ms[S]:.3f}x B1's "
              f"{b1_ms[S]:.4f} ms) plain_ms={plain_ms:.3f} max_abs_err="
              f"{err:.3e} (tol {out_tol:.3e}, max|ref|={ref_max:.3e}); "
              f"quant_rows(q)+quant_rows(k) {quant_ms:.4f} ms, with B3 (what "
              f"attention(qk8=True) launches) {whole_ms:.4f} ms = "
              f"{whole_ms / b1_ms[S]:.3f}x B1; no library call computes "
              f"int8-QK attention, bf16 scaled_dot_product_attention (not "
              f"the same function) {sdpa_ms:.4f} ms; ptxas: {ptxas}",
              flush=True)
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


# tree key -> diffusers module name, where they differ
_HF_NAMES = {
    "dual_blocks": "transformer_blocks",
    "single_blocks": "single_transformer_blocks",
    "time_embed": "time_text_embed.timestep_embedder",
    "pooled_embed": "time_text_embed.text_embedder",
    "guidance_embed": "time_text_embed.guidance_embedder",
    "lin": "linear",
    "to_out": "to_out.0",
}
_HF_EMBED = {"in": "linear_1", "out": "linear_2"}
_HF_FF = {"in": "net.0.proj", "out": "net.2"}


def _hf_name(path) -> str:
    """The diffusers module name of a tree path inside a block or at the
    top of a transformer tree."""
    parts = []
    for parent, key in zip(("",) + tuple(path), path):
        if parent in ("ff", "ff_context"):
            key = _HF_FF[key]
        elif parent.endswith("_embed"):
            key = _HF_EMBED[key]
        parts.append(_HF_NAMES.get(key, key))
    return ".".join(parts)


def flux_state_dict(params):
    """(diffusers name, tensor in torch's layout) of each leaf of a float
    FLUX tree, the inverse of ``unitex_torch.models.flux.loader``: linear
    kernels [d_in, d_out] -> ``.weight`` [d_out, d_in], stacked blocks ->
    one entry a layer.  The tensors are views of the tree's."""
    name = _hf_name
    for path, leaf in _named_leaves(params):
        *mod, kind = path.strip("/").split("/")
        if kind == "kernel":
            field, leaf = "weight", leaf.transpose(-1, -2)
        elif kind == "bias":
            field = "bias"
        else:  # the q/k RMS-norm scales are the module's weight
            mod, field = mod + [kind], "weight"
        if mod[0] in ("dual_blocks", "single_blocks"):
            for i in range(leaf.shape[0]):
                yield f"{_HF_NAMES[mod[0]]}.{i}.{name(tuple(mod[1:]))}.{field}", leaf[i]
        else:
            yield f"{name(tuple(mod))}.{field}", leaf


def sd3_state_dict(params, cfg):
    """(diffusers name, tensor in torch's layout) of each leaf of an SD3
    tree, the inverse of ``unitex_torch.models.sd3.loader``: the patchify
    linear [C·ps·ps, d] -> the ``PatchEmbed`` conv [d, C, ps, ps], the
    position table [pmax, pmax, d] -> [1, pmax², d], the stacked blocks and
    the final block -> ``transformer_blocks.<i>``."""
    ps = cfg.patch_size
    for path, leaf in _named_leaves(params):
        *mod, kind = path.strip("/").split("/")
        if mod[0] == "pos_embed":
            if kind == "pos":
                yield "pos_embed.pos_embed", leaf.reshape(1, -1, leaf.shape[-1])
            elif kind == "kernel":
                yield "pos_embed.proj.weight", leaf.t().reshape(
                    leaf.shape[-1], cfg.in_channels, ps, ps)
            else:
                yield "pos_embed.proj.bias", leaf
            continue
        field = "weight" if kind == "kernel" else "bias"
        if kind == "kernel":
            leaf = leaf.transpose(-1, -2)
        if mod[0] == "blocks":
            for i in range(leaf.shape[0]):
                yield f"transformer_blocks.{i}.{_hf_name(mod[1:])}.{field}", leaf[i]
        elif mod[0] == "final_block":
            yield (f"transformer_blocks.{cfg.num_layers - 1}."
                   f"{_hf_name(mod[1:])}.{field}"), leaf
        else:
            yield f"{_hf_name(mod)}.{field}", leaf


def vae_state_dict(vae):
    """(diffusers name, tensor in torch's layout) of each leaf of a VAE
    tree: conv kernels HWIO -> OIHW, linear kernels transposed."""
    def conv(name, p):
        yield f"{name}.weight", p["kernel"].permute(3, 2, 0, 1)
        yield f"{name}.bias", p["bias"]

    def gn(name, p):
        yield f"{name}.weight", p["scale"]
        yield f"{name}.bias", p["bias"]

    def lin(name, p):
        yield f"{name}.weight", p["kernel"].t()
        yield f"{name}.bias", p["bias"]

    def resnet(name, p):
        yield from gn(f"{name}.norm1", p["norm1"])
        yield from conv(f"{name}.conv1", p["conv1"])
        yield from gn(f"{name}.norm2", p["norm2"])
        yield from conv(f"{name}.conv2", p["conv2"])
        if "shortcut" in p:
            yield from conv(f"{name}.conv_shortcut", p["shortcut"])

    def mid(name, p):
        yield from resnet(f"{name}.resnets.0", p["res1"])
        a = f"{name}.attentions.0"
        yield from gn(f"{a}.group_norm", p["attn"]["norm"])
        for key, hf in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                        ("o", "to_out.0")):
            yield from lin(f"{a}.{hf}", p["attn"][key])
        yield from resnet(f"{name}.resnets.1", p["res2"])

    for part, levels, resample in (("encoder", "down", "downsample"),
                                   ("decoder", "up", "upsample")):
        p = vae[part]
        yield from conv(f"{part}.conv_in", p["conv_in"])
        yield from mid(f"{part}.mid_block", p["mid"])
        for i, level in enumerate(p[levels]):
            block = f"{part}.{levels}_blocks.{i}"
            for j, r in enumerate(level["resnets"]):
                yield from resnet(f"{block}.resnets.{j}", r)
            if resample in level:
                yield from conv(f"{block}.{resample}rs.0.conv", level[resample])
        yield from gn(f"{part}.conv_norm_out", p["norm_out"])
        yield from conv(f"{part}.conv_out", p["conv_out"])


def write_checkpoint(root: str, params, vae, loras: dict,
                     shard_bytes: float = 5e9) -> int:
    """A checkpoint root as the pipeline reads it: ``flux/transformer``
    in safetensors shards of at most ``shard_bytes`` (a shard is built
    whole in host memory), ``flux/vae``, and ``<name>_lora.safetensors``
    for each adapter of ``loras``.  Returns the bytes written."""
    from unitex_torch.models.flux.lora import save_lora_safetensors

    _write_model(os.path.join(root, "flux"), flux_state_dict(params), vae,
                 shard_bytes)
    for name, lora in loras.items():
        save_lora_safetensors(os.path.join(root, f"{name}_lora.safetensors"), lora)
    return _dir_bytes(root)


def write_sd3_checkpoint(root: str, params, vae, cfg,
                         shard_bytes: float = 5e9) -> int:
    """The SR stage's part of a checkpoint root: ``sd3/transformer`` in
    shards of at most ``shard_bytes`` and ``sd3/vae``.  Returns the bytes
    written under ``root/sd3``."""
    _write_model(os.path.join(root, "sd3"), sd3_state_dict(params, cfg), vae,
                 shard_bytes)
    return _dir_bytes(os.path.join(root, "sd3"))


def _dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def _write_model(root: str, transformer_items, vae, shard_bytes: float) -> None:
    """``root/transformer`` from (name, tensor) items in safetensors shards
    of at most ``shard_bytes`` (a shard is built whole in host memory), and
    ``root/vae`` from a VAE tree."""
    from safetensors.torch import save_file

    tdir = os.path.join(root, "transformer")
    vdir = os.path.join(root, "vae")
    os.makedirs(tdir)
    os.makedirs(vdir)
    shard, size, n = {}, 0, 0
    for name, t in transformer_items:
        nbytes = t.numel() * t.element_size()
        if shard and size + nbytes > shard_bytes:
            save_file(shard, os.path.join(tdir, f"diffusion_pytorch_model-{n:05d}"
                                          ".safetensors"))
            shard, size, n = {}, 0, n + 1
        shard[name] = t.contiguous().cpu()
        size += nbytes
    save_file(shard, os.path.join(tdir, f"diffusion_pytorch_model-{n:05d}"
                                  ".safetensors"))
    save_file({k: t.contiguous().cpu() for k, t in vae_state_dict(vae)},
              os.path.join(vdir, "diffusion_pytorch_model.safetensors"))


def run_checkpoint(torch, pipe, root: str) -> None:
    """Write the pipeline's serving trees as a checkpoint under ``root``
    and read them back onto the card, each leaf equal to the resident
    one."""
    from unitex_torch.models.flux.loader import load_flux_transformer, load_vae
    from unitex_torch.models.flux.lora import load_lora_safetensors

    free = shutil.disk_usage(os.path.dirname(root)).free
    t0 = time.perf_counter()
    nbytes = write_checkpoint(root, pipe.transformer_params, pipe.vae_params,
                              {"texture": pipe.texture_lora,
                               "delight": pipe.delight_lora})
    t_write = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = pipe.flux_cfg
    loaded = {
        "transformer": (load_flux_transformer(
            os.path.join(root, "flux", "transformer"), cfg, device="cuda"),
            pipe.transformer_params),
        "vae": (load_vae(os.path.join(root, "flux", "vae"), pipe.vae_cfg,
                         device="cuda"), pipe.vae_params),
    }
    for name in ("texture", "delight"):
        loaded[name] = (load_lora_safetensors(
            os.path.join(root, f"{name}_lora.safetensors"), cfg.num_layers,
            cfg.num_single_layers, device="cuda"), getattr(pipe, f"{name}_lora"))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[checkpoint] wrote {nbytes / 1e9:.3f} GB ({nbytes} bytes; free "
          f"disk before {free / 1e9:.1f} GB) in {t_write:.2f}s; loaded onto the "
          f"card in {t_load:.2f}s ({nbytes / t_load / 1e9:.2f} GB/s), peak "
          f"{peak / 2**30:.2f} GiB with the resident tree", flush=True)
    for what, (got, want) in loaded.items():
        g, w = dict(_named_leaves(got)), dict(_named_leaves(want))
        bad = sorted(k for k in set(g) | set(w)
                     if k not in g or k not in w or not torch.equal(g[k], w[k]))
        if bad:
            raise AssertionError(f"checkpoint {what}: {len(bad)} leaves differ "
                                 f"from the written tree, first {bad[:3]}")
        print(f"[checkpoint] {what}: {len(w)} leaves read back equal", flush=True)
    if peak >= PEAK_LIMIT:
        raise AssertionError(f"checkpoint load: peak {peak} bytes")


def run_sd3_checkpoint(torch, root: str) -> None:
    """Random SD3-medium and SD3 VAE trees (seeded, made on the card in
    bf16 / f32 as the SR stage serves them) written under the diffusers
    names into ``root/sd3/{transformer,vae}`` and read back with the port's
    loaders, each leaf equal to the written one."""
    from unitex_torch.models.flux.loader import load_vae
    from unitex_torch.models.flux.vae import VAEConfig, init_vae_params
    from unitex_torch.models.sd3.config import SD3Config
    from unitex_torch.models.sd3.loader import load_sd3_transformer
    from unitex_torch.models.sd3.model import init_sd3_params

    cfg, vcfg = SD3Config.sd3_medium(), VAEConfig.sd3()
    gen = torch.Generator(device="cuda")
    params = init_sd3_params(gen.manual_seed(10), cfg, device="cuda",
                             dtype=torch.bfloat16)
    vae = init_vae_params(gen.manual_seed(11), vcfg, device="cuda")
    t0 = time.perf_counter()
    nbytes = write_sd3_checkpoint(root, params, vae, cfg)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = {
        "sd3 transformer": (load_sd3_transformer(
            os.path.join(root, "sd3", "transformer"), cfg, device="cuda",
            dtype=torch.bfloat16), params),
        "sd3 vae": (load_vae(os.path.join(root, "sd3", "vae"), vcfg,
                             device="cuda", dtype=torch.float32), vae),
    }
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    print(f"[checkpoint] sd3: wrote {nbytes / 1e9:.3f} GB ({nbytes} bytes; "
          f"transformer {_tree_bytes(params)} bytes in bf16, VAE "
          f"{_tree_bytes(vae)} bytes in f32) in {t_write:.2f}s; loaded onto "
          f"the card in {t_load:.2f}s ({nbytes / t_load / 1e9:.2f} GB/s)",
          flush=True)
    for what, (got, want) in loaded.items():
        g, w = dict(_named_leaves(got)), dict(_named_leaves(want))
        bad = sorted(k for k in set(g) | set(w)
                     if k not in g or k not in w or not torch.equal(g[k], w[k]))
        if bad:
            raise AssertionError(f"checkpoint {what}: {len(bad)} leaves differ "
                                 f"from the written tree, first {bad[:3]}")
        print(f"[checkpoint] {what}: {len(w)} leaves read back equal", flush=True)


def sr_launches(view_size: int, rows: int, cols: int) -> int:
    """B1 (D = 64) launches of one TSD-SR pass over a ``rows`` x ``cols``
    grid of ``view_size``² views at ``TSDSRConfig()``: one a transformer
    layer for each call on ``tile_batch`` latent tiles."""
    from unitex_torch.models.flux.vae import VAEConfig
    from unitex_torch.models.sd3.config import SD3Config
    from unitex_torch.models.sd3.sr_pipeline import TSDSRConfig, _tile_offsets

    c = TSDSRConfig()
    ds = VAEConfig.sd3().downscale
    h, w = (n * view_size * c.upscale // ds for n in (rows, cols))
    tiles = (len(_tile_offsets(h, c.latent_tile, c.latent_overlap))
             * len(_tile_offsets(w, c.latent_tile, c.latent_overlap)))
    return -(-tiles // c.tile_batch) * SD3Config.sd3_medium().num_layers


SR_TIMERS = ("sr_upscale", "sr_encode", "sr_transformer", "sr_decode",
             "sr_color_fix")


def run_cli(attn, torch, root: str) -> None:
    """The product CLI in process on the icosphere job, from the
    checkpoint under ``root``."""
    import numpy as np

    from unitex_torch import run
    from unitex_torch.geometry.io.mesh_io import load_mesh
    from unitex_torch.models.flux.pipeline import make_reuse_mask
    from unitex_torch.utils.timer import CPUTimer

    steps = run.DEFAULT_CONFIG.diffusion.num_inference_steps
    evals = steps - int(make_reuse_mask(steps, FAST_STEPS).sum())
    per_job = 57 * evals * 2
    cam = run.DEFAULT_CONFIG.camera
    per_sr = sr_launches(cam.view_size, cam.rows, cam.cols)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as d:
        name, mesh_path, img_path = make_assets(d)[0]
        out = os.path.join(d, "out")
        torch.cuda.reset_peak_memory_stats()
        before = _counts(attn)
        t0 = time.perf_counter()
        run.main(["--image", img_path, "--mesh", mesh_path, "--out", out,
                  "--pretrain-models", root, "--fast-steps", str(FAST_STEPS),
                  "--super-resolution"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = tuple(a - b for a, b in zip(_counts(attn), before))
        peak = torch.cuda.max_memory_allocated()
        rec = CPUTimer.records
        stages = {
            "load": rec["load_weights"],
            "preprocess": rec["preprocess_blank_mesh"]
            + rec["preprocess_reference_image"],
            "render_geometry": rec["render_geometry_images"],
            "infer_mv": rec["infer_mv"],
            "reproject": rec["reproject_and_query_field"],
            "export_video": rec["export_video"],
        }
        glb = os.path.join(out, "textured_mesh.glb")
        tex = load_mesh(glb).texture if os.path.exists(glb) else None
        videos = glob.glob(os.path.join(out, "cache", "textured_mesh.*"))
        videos = [v for v in videos if v.endswith((".mp4", ".gif"))]
        frames = video_frames(videos[0]) if videos else None
        print(f"[cli] job {name} ({steps} steps, {FAST_STEPS} reused, "
              f"{evals} transformer evaluations a pass, TSD-SR): wall "
              f"{wall:.2f}s stages "
              + " ".join(f"{k}={v:.3f}s" for k, v in stages.items())
              + f" peak {peak / 2**30:.2f} GiB launches B1 {n[0]} B1(D=64) "
              f"{n[4]} B3 {n[3]}", flush=True)
        grids = {}
        for art in ("mv_rgb_lr.png", "mv_rgb.png"):
            path = os.path.join(out, "cache", art)
            if os.path.exists(path):
                from PIL import Image

                with Image.open(path) as im:
                    grids[art] = im.size[::-1]
        print(f"[sr] whole grid {grids.get('mv_rgb_lr.png')} -> "
              f"{grids.get('mv_rgb.png')}: super_resolution "
              f"{rec['super_resolution']:.3f}s = "
              + " ".join(f"{k[3:]}={rec[k]:.3f}s" for k in SR_TIMERS)
              + f"; mv_rgb.png written in {rec['save_mv_rgb']:.3f}s"
              f"; the bake on the {4 * cam.view_size}² views "
              f"{rec['reproject_and_query_field']:.3f}s; job peak "
              f"{peak / 2**30:.2f} GiB", flush=True)
        writer = ("PIL (GIF: imageio-ffmpeg does not import)"
                  if videos and videos[0].endswith(".gif") else "imageio-ffmpeg")
        print(f"[video] {videos}: (frames, height, width) {frames}, written by "
              f"{writer}; rendering {rec['orbit_render']:.3f}s, writing "
              f"{rec['orbit_write']:.3f}s", flush=True)
        if not os.path.exists(os.path.join(out, "rembg_image.png")):
            raise AssertionError("cli: no rembg_image.png")
        if tex is None or tex.shape[:2] != (2048, 2048) or not np.isfinite(
                tex.astype(np.float32)).all():
            raise AssertionError(f"cli: GLB texture "
                                 f"{None if tex is None else tex.shape}")
        if frames != (120, 1024, 1024):
            raise AssertionError(f"cli: video {videos} {frames}, expected 120 "
                                 f"frames of 1024²")
        lr = (cam.rows * cam.view_size, cam.cols * cam.view_size)
        if grids != {"mv_rgb_lr.png": lr,
                     "mv_rgb.png": (4 * lr[0], 4 * lr[1])}:
            raise AssertionError(f"cli: SR grids {grids}")
        if n != (per_job, 0, 0, 0, per_sr):
            raise AssertionError(f"cli: launches B1/B2a/B2b/B3/B1(D=64) {n}, "
                                 f"expected ({per_job}, 0, 0, 0, {per_sr})")
        if peak >= PEAK_LIMIT:
            raise AssertionError(f"cli: peak {peak} bytes")


def video_frames(path: str):
    """(frames, height, width) of a GIF (PIL) or an mp4 (imageio)."""
    if path.endswith(".gif"):
        from PIL import Image

        with Image.open(path) as im:
            return (im.n_frames, im.height, im.width)
    import imageio.v2 as imageio

    frames = imageio.mimread(path, memtest=False)
    return (len(frames),) + frames[0].shape[:2]


def _counts(attn) -> tuple:
    """Launches of B1 (D = 128), B2a, B2b, B3 and B1 at D = 64."""
    return (attn.launches, attn.launches_bwd_dkv, attn.launches_bwd_dq,
            attn.launches_qk8, attn.launches_d64)


def _reset(attn) -> None:
    attn.launches = attn.launches_bwd_dkv = attn.launches_bwd_dq = 0
    attn.launches_qk8 = attn.launches_d64 = 0


def _tree_bytes(tree) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in _named_leaves(tree))


def run_int8_path(attn, torch, root: str) -> None:
    """One full-width int8 serving job (W8A8, int8-QK attention) from the
    checkpoint under ``root``."""
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
    pipe = CustomRGBTextureFullPipeline(int8_serving=True, pretrain_models=root,
                                        require_weights=True, config=config,
                                        device="cuda")
    pipe.flux_cfg = dataclasses.replace(pipe.flux_cfg, attn_qk8=True)
    torch.cuda.synchronize()
    n_q, n_f = count_quantized(pipe.transformer_params)
    print(f"[int8] init (checkpoint streamed in bf16 + W8A8 quantization) "
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
        if n != (0, 0, 0, per_job, 0):
            raise AssertionError(
                f"int8 job {name}: launches B1/B2a/B2b/B3/B1(D=64) {n}, "
                f"expected (0, 0, 0, {per_job}, 0)")
        if peak >= PEAK_LIMIT:
            raise AssertionError(f"int8 job {name}: peak {peak} bytes")


def run_sr_options(attn, torch, root: str) -> None:
    """TSD-SR's serving options on one 512² view from the SD3 checkpoint
    under ``root``: int8 serving with the trees kept on the host and the
    transformer staged int4-packed (``TSDSRConfig(int8_serving=True,
    host_params=True, stage_pack_int4=True)``) against the bf16 SR of the
    same view.  Each must give a finite 2048² image and launch B1 at
    D = 64 as derived; the PSNR between them is printed, not gated (random
    weights)."""
    import numpy as np

    from unitex_torch.models.sd3.sr_pipeline import TSDSRConfig, TSDSRPipeline
    from unitex_torch.utils.timer import CPUTimer

    per_view = sr_launches(512, 1, 1)
    yy, xx = np.mgrid[:512, :512] / 511.0
    view = np.stack([xx, yy, 0.5 + 0.4 * np.sin(12 * xx) * np.cos(9 * yy)],
                    axis=-1).astype(np.float32)
    outs = {}
    for name, cfg in (("bf16", TSDSRConfig()),
                      ("int8 + host_params + stage_pack_int4",
                       TSDSRConfig(int8_serving=True, host_params=True,
                                   stage_pack_int4=True))):
        torch.cuda.reset_peak_memory_stats()
        before = _counts(attn)
        t0 = time.perf_counter()
        pipe = TSDSRPipeline(root, cfg=cfg, device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        if pipe.transformer_params is None:
            raise AssertionError(f"sr {name}: no SD3 weights under {root}")
        t0 = time.perf_counter()
        out = pipe(view)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = tuple(a - b for a, b in zip(_counts(attn), before))
        peak = torch.cuda.max_memory_allocated()
        rec = CPUTimer.records
        staging = ""
        if cfg.host_params:
            staging = (f" staging (int4 pack on the card, host -> device, "
                       f"unpack) {rec['sr_stage_weights']:.3f}s, staged tree "
                       f"{_tree_bytes(pipe._packed[1])} bytes (host tree "
                       f"{_tree_bytes(pipe.transformer_params)} bytes);")
        print(f"[sr_options] {name}: init {t_init:.2f}s, one 512² view -> "
              f"{tuple(out.shape)} in {wall:.3f}s ("
              + " ".join(f"{k[3:]}={rec[k]:.3f}s" for k in SR_TIMERS)
              + f");{staging} peak {peak / 2**30:.2f} GiB launches B1(D=64) "
              f"{n[4]}", flush=True)
        if tuple(out.shape) != (2048, 2048, 3) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"sr {name}: output {tuple(out.shape)} not a "
                                 f"finite 2048² image")
        if n != (0, 0, 0, 0, per_view):
            raise AssertionError(f"sr {name}: launches B1/B2a/B2b/B3/B1(D=64) "
                                 f"{n}, expected (0, 0, 0, 0, {per_view})")
        if peak >= PEAK_LIMIT:
            raise AssertionError(f"sr {name}: peak {peak} bytes")
        outs[name] = out
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    a, b = outs.values()
    mse = float(((a - b) ** 2).mean())
    print(f"[sr_options] PSNR of the int8 + int4-staged SR against the bf16 SR "
          f"of the same view: {10 * math.log10(1.0 / max(mse, 1e-20)):.2f} dB "
          f"(random weights; not gated)", flush=True)


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
    want = (2 * n_blocks, n_blocks, n_blocks, 0, 0)
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


LTM_NPZ = os.path.join(REPO, "ltm_params.npz")
ORACLE_RECORD = os.path.join(REPO, "ORACLE_r05.json")
ORACLE_PRIMITIVES = ("cup", "trefoil")
ORACLE_KEYS = ("visible_texel_fraction", "texture_psnr_visible",
               "texture_psnr_all", "rerender_psnr")
LOW_HBM_TOL = 1e-6       # max|texture| of the low-memory bake vs the plain one


def oracle_record(primitive: str, setting: str, path: str = ORACLE_RECORD) -> dict:
    """The JAX package's recorded case of ``ORACLE_r05.json`` for one of
    ``oracle_campaign.SETTINGS``: "priority_k1", "cosine_k8_relax" or
    "cosine_ltm"."""
    with open(path) as f:
        cases = json.load(f)["cases"]
    for case in cases:
        if case["primitive"] != primitive:
            continue
        if setting == "cosine_ltm" and case.get("fill") == "ltm":
            return case
        if case.get("fill") is None and (case["paste_mode"], case["fill_k"]) == {
                "priority_k1": ("priority", 1),
                "cosine_k8_relax": ("cosine", 8)}.get(setting):
            return case
    raise KeyError(f"{primitive} {setting} not in {path}")


def oracle_line(primitive: str, setting: str, case: dict, ref: dict) -> str:
    """One ``[oracle]`` line: each score beside the JAX package's recorded
    value and the difference, then the bake's seconds."""
    parts = [f"{k} {case[k]} (JAX {ref[k]}, {case[k] - ref[k]:+.2f})"
             for k in ORACLE_KEYS]
    return (f"[oracle] {primitive} {setting}: " + ", ".join(parts)
            + f"; bake {case['bake_s']:.3f}s")


def check_oracle_order(primitive: str, results: dict) -> None:
    """The LTM field must beat the k=8 fill with relaxation over all chart
    texels, as ``ORACLE_r05.json`` records for the JAX package."""
    ltm = results["cosine_ltm"]["texture_psnr_all"]
    idw = results["cosine_k8_relax"]["texture_psnr_all"]
    if not ltm > idw:
        raise AssertionError(f"oracle {primitive}: LTM texture_psnr_all {ltm} "
                             f"does not beat k=8 + relaxation's {idw}")


def result_lines(records: list, card: str, kind: str, count: int) -> list:
    """The last three lines of the output: the kernels' record, the card's
    name and power limit, the result."""
    return [json.dumps({"kernels": records}), card,
            json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                               "count": count}})]


def run_ltm_path(attn, torch, pipe, config=None, device: str = "cuda") -> None:
    """Phase 9: ``RGBTextureFullPipeline`` with the repo's trained LTM on
    the 4-step config, the FLUX trees of ``pipe`` reused: the cup (the
    field fill) and the icosphere (the k=8 fill with relaxation; forced by
    ``ltm_auto=0.0`` where its chart is under 0.93 visible).  ``config``
    defaults to ``DEFAULT_CONFIG`` with ``STEPS`` steps."""
    from PIL import Image

    from unitex_torch.config import DEFAULT_CONFIG
    from unitex_torch.geometry.io.mesh_io import save_mesh
    from unitex_torch.geometry.primitives import make_cup
    from unitex_torch.pipeline import RGBTextureFullPipeline
    from unitex_torch.utils.timer import CPUTimer

    config = config or dataclasses.replace(
        DEFAULT_CONFIG,
        diffusion=dataclasses.replace(DEFAULT_CONFIG.diffusion,
                                      num_inference_steps=STEPS))
    n_blocks = pipe.flux_cfg.num_layers + pipe.flux_cfg.num_single_layers
    per_job = n_blocks * config.diffusion.num_inference_steps * 2
    uv = config.bake.uv_size
    ltm = RGBTextureFullPipeline(config=config, ltm_params=LTM_NPZ, device=device)
    for attr in ("transformer_params", "vae_params", "texture_lora",
                 "delight_lora", "flux_cfg", "vae_cfg"):
        setattr(ltm, attr, getattr(pipe, attr))
    ltm._flux_loaded = True
    print(f"[ltm] {LTM_NPZ}: {ltm.ltm_cfg}; FLUX trees of the serving phase",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ltm_") as d:
        ico = make_assets(d)[0]
        cup_mesh = os.path.join(d, "cup.obj")
        save_mesh(cup_mesh, make_cup())
        jobs = [("cup", cup_mesh, ico[2], "field"), (ico[0], ico[1], ico[2], "knn")]
        for name, mesh_path, img_path, want in jobs:
            ltm.ltm_auto = 0.93
            for attempt in range(2):
                out_dir = os.path.join(d, f"out_{name}_{attempt}")
                torch.cuda.reset_peak_memory_stats()
                before = _counts(attn)
                CPUTimer.records.pop("ltm_encode", None)
                CPUTimer.records.pop("ltm_decode", None)
                t0 = time.perf_counter()
                _, glb = ltm(out_dir, img_path, mesh_path)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n = tuple(a - b for a, b in zip(_counts(attn), before))
                peak = torch.cuda.max_memory_allocated()
                rec = CPUTimer.records
                fill = ltm.last_fill
                enc, dec = rec.get("ltm_encode"), rec.get("ltm_decode")
                split = (f" (ltm_encode {enc:.3f}s ltm_decode {dec:.3f}s rest "
                         f"{rec['reproject_and_query_field'] - enc - dec:.3f}s)"
                         if enc is not None else "")
                print(f"[ltm] job {name} ltm_auto={ltm.ltm_auto}: branch "
                      f"{fill['branch']} visible fraction "
                      f"{fill['visible_fraction']:.4f}; wall {wall:.2f}s infer_mv "
                      f"{rec['infer_mv']:.3f}s reproject_and_query_field "
                      f"{rec['reproject_and_query_field']:.3f}s{split} peak "
                      f"{peak / 2**30:.2f} GiB launches B1 {n[0]}", flush=True)
                tex = ltm.last_texture
                uv_png = os.path.join(out_dir, "cache", "completed_uv.png")
                if not (os.path.exists(glb) and os.path.exists(uv_png)):
                    raise AssertionError(f"ltm job {name}: no GLB or completed_uv.png")
                with Image.open(uv_png) as im:
                    uv_size = im.size
                if tuple(tex.shape) != (uv, uv, 3) or uv_size != (uv, uv) \
                        or not bool(torch.isfinite(tex).all()):
                    raise AssertionError(f"ltm job {name}: texture {tuple(tex.shape)}"
                                         f" ({uv_size} png) not a finite {uv}²")
                if n != (per_job, 0, 0, 0, 0):
                    raise AssertionError(f"ltm job {name}: launches B1/B2a/B2b/B3/"
                                         f"B1(D=64) {n}, expected ({per_job}, 0, "
                                         f"0, 0, 0)")
                if peak >= PEAK_LIMIT:
                    raise AssertionError(f"ltm job {name}: peak {peak} bytes")
                if fill["branch"] == want:
                    break
                if want == "field" or attempt:
                    raise AssertionError(f"ltm job {name}: branch {fill}, expected "
                                         f"{want}")
                print(f"[ltm] job {name}: visible fraction "
                      f"{fill['visible_fraction']:.4f} under 0.93 with the gradient "
                      f"filter; run again with ltm_auto=0.0 to force the k=8 fill "
                      f"with relaxation", flush=True)
                ltm.ltm_auto = 0.0


def run_oracle(torch, view_size: int = 512, uv_size: int = 2048,
               device: str = "cuda") -> None:
    """Phase 10: the texture round trip of ``oracle_campaign`` (512² views,
    2048² atlas) on the cup and the trefoil with the three option sets of
    ``ORACLE_r05.json``, each score beside the JAX package's; on the cup
    also the low-memory bake (its texture that of the plain bake) and one
    bake each of the blending and kdtree methods."""
    from unitex_torch.render.renderer_inverse import bake_texture
    from unitex_torch.scripts.oracle_campaign import SETTINGS, prepare_case, run_case

    for prim in ORACLE_PRIMITIVES:
        t0 = time.perf_counter()
        scene = prepare_case(prim, view_size, uv_size, device=device)
        torch.cuda.synchronize()
        print(f"[oracle] {prim}: {int(scene['mesh'].faces.shape[0])} faces, "
              f"unwrap and views {time.perf_counter() - t0:.3f}s", flush=True)
        results = {}
        for name, setting in SETTINGS.items():
            setting = dict(setting)
            if setting.pop("ltm", False):
                setting["ltm_path"] = LTM_NPZ
            torch.cuda.reset_peak_memory_stats()
            case = run_case(prim, view_size, uv_size, device=device, scene=scene,
                            **setting)
            results[name] = case
            print(oracle_line(prim, name, case, oracle_record(prim, name))
                  + f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
                  flush=True)
        check_oracle_order(prim, results)
        if prim != "cup":
            continue
        low = run_case(prim, view_size, uv_size, device=device, scene=scene,
                       low_hbm=True, **SETTINGS["priority_k1"])
        diff = float((low["texture"] - results["priority_k1"]["texture"]).abs().max())
        print(f"[oracle] cup low_hbm: max|texture - plain bake's| {diff:.3e} "
              f"(tol {LOW_HBM_TOL}); bake {low['bake_s']:.3f}s against "
              f"{results['priority_k1']['bake_s']:.3f}s", flush=True)
        if not diff <= LOW_HBM_TOL:
            raise AssertionError(f"oracle cup: low_hbm texture differs by {diff}")
        for method in ("reproject_blending", "kdtree"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = bake_texture(scene["mesh"], scene["views"], scene["c2ws"],
                               scene["intr"], uv_size=uv_size, method=method)
            tex = out["texture"]
            finite = bool(torch.isfinite(tex).all())
            torch.cuda.synchronize()
            print(f"[oracle] cup method={method}: {time.perf_counter() - t0:.3f}s, "
                  f"texture {tuple(tex.shape)} finite {finite}", flush=True)
            if tuple(tex.shape) != (uv_size, uv_size, 3) or not finite:
                raise AssertionError(f"oracle cup {method}: texture not a finite "
                                     f"{uv_size}²")


def _named_leaves(tree, prefix=""):
    """("/a/0/b", leaf) of a tree of dicts and lists."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
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

    b1_record, b1_ms = check_flash_attention(attn, torch,
                                             usage["flash_fwd_kernel<128>"])
    records = [b1_record]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    records += check_flash_backward(attn, torch, usage)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    records.append(check_flash_qk8(attn, torch, usage["flash_qk8_kernel"], b1_ms))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    records.append(check_flash_attention_d64(attn, torch,
                                             usage["flash_fwd_kernel<64>"]))
    time_w8a8(torch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    _reset(attn)
    launches, pipe = run_main_path(attn, torch)
    torch.cuda.synchronize()
    serve = _counts(attn)
    if launches != serve[0] or launches == 0 or serve[1:] != (0, 0, 0, 0):
        return fail(f"launches B1/B2a/B2b/B3/B1(D=64) {serve} on the serving "
                    f"path")
    torch.cuda.empty_cache()

    _reset(attn)
    run_training(attn, torch, pipe)
    torch.cuda.synchronize()
    train = _counts(attn)
    if 0 in train[:3] or train[3:] != (0, 0):
        return fail(f"launches B1/B2a/B2b/B3/B1(D=64) {train} on the training "
                    f"path")
    print(f"[train] launches B1/B2a/B2b {train[0]}/{train[1]}/{train[2]} in "
          f"{TRAIN_STEPS} steps", flush=True)
    torch.cuda.empty_cache()

    # phase 9 runs here, while the serving phase's FLUX trees are resident
    _reset(attn)
    run_ltm_path(attn, torch, pipe)
    torch.cuda.synchronize()
    ltm = _counts(attn)
    if ltm[0] == 0 or ltm[1:] != (0, 0, 0, 0):
        return fail(f"launches B1/B2a/B2b/B3/B1(D=64) {ltm} on the LTM path")
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    models = os.path.join(tmp, "models")
    try:
        _reset(attn)
        run_checkpoint(torch, pipe, models)
        # the CLI and the int8 job need the card to themselves
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        run_sd3_checkpoint(torch, models)
        gc.collect()
        torch.cuda.empty_cache()
        if _counts(attn) != (0, 0, 0, 0, 0):
            return fail(f"launches {_counts(attn)} while writing the checkpoint")

        _reset(attn)
        run_cli(attn, torch, models)
        torch.cuda.synchronize()
        cli = _counts(attn)
        if cli[0] == 0 or cli[4] == 0 or cli[1:4] != (0, 0, 0):
            return fail(f"launches B1/B2a/B2b/B3/B1(D=64) {cli} on the CLI path")
        gc.collect()
        torch.cuda.empty_cache()

        _reset(attn)
        run_int8_path(attn, torch, models)
        torch.cuda.synchronize()
        int8 = _counts(attn)
        if int8[3] == 0 or int8[:3] != (0, 0, 0) or int8[4]:
            return fail(f"launches B1/B2a/B2b/B3/B1(D=64) {int8} on the int8 "
                        f"serving path")
        gc.collect()
        torch.cuda.empty_cache()

        _reset(attn)
        run_sr_options(attn, torch, models)
        torch.cuda.synchronize()
        sr_options = _counts(attn)
        if sr_options[4] == 0 or sr_options[:4] != (0, 0, 0, 0):
            return fail(f"launches B1/B2a/B2b/B3/B1(D=64) {sr_options} on the "
                        f"SR options")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    _reset(attn)
    run_oracle(torch)
    torch.cuda.synchronize()
    oracle = _counts(attn)
    if oracle != (0, 0, 0, 0, 0):
        return fail(f"launches B1/B2a/B2b/B3/B1(D=64) {oracle} on the oracle "
                    f"bakes")

    paths = ("serve", "train", "ltm", "cli", "int8_serve", "sr_options",
             "oracle")
    for rec, *n in zip(records, serve, train, ltm, cli, int8, sr_options,
                       oracle):
        rec["launches"] = sum(n)
        rec["launches_by_path"] = dict(zip(paths, n))
    keys = ("ms", "plain_ms", "bound_ms", "max_abs_err", "library_ms")
    bad = [r for r in records if not all(
        (k == "library_ms" and r[k] is None)
        or (isinstance(r[k], (int, float)) and math.isfinite(r[k]))
        for k in keys)]
    if bad:
        return fail(f"bad kernel records {bad}")
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    for line in result_lines(records, card, torch.cuda.get_device_name(0),
                             torch.cuda.device_count()):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
