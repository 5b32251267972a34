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
   S = 13824 and 12800, plus a ragged S = 1000; B1 also at FastTexture's
   S = 4608 and 16896 and at a Redux job's S = 14041, its plain version a
   head at a time, as at every S), with its time, the plain
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
   tensor-core, SFU (exp) and memory times; B2a and B2b at D = 64 (their
   second instantiation, the TSD-SR trainer's backward) at
   [1, 1178, 24, 64] and [8, 1178, 24, 64], each gradient within 2 % of
   its largest reference value, each kernel's line giving its time, bound
   (tensor cores, SFU exp, memory), the plain version's time and its
   ptxas report, the pair's line its time against
   ``scaled_dot_product_attention``'s backward; and one
   W8A8 projection ([13312, 3072] @ [3072, 12288], ``torch._int_mm``)
   timed beside the same product in bf16 (context, not a gate);
12. matting (right after phase 3): ISNet ``IsnetConfig.rmbg14()`` and
   BiRefNet ``BiRefNetConfig.rmbg20()`` (Swin-L, about 220 M parameters)
   from seeded state dicts in the checkpoints' naming, each forward at a
   256² input on the card held to the same module on the CPU with the same
   parameters (f32, TF32 off, max|dlogit| <= ``MATTING_TOL`` of the
   largest CPU logit), then the remover at its 1024² on a 512² synthetic
   image: the seconds of two calls, the peak, a finite matte of the
   image's size; no kernel launches;
4. serving path: ``CustomRGBTextureFullPipeline(random_weights=True,
   async_io=True)`` at full FLUX.1-dev width and depth with the FLUX VAE
   answers two jobs (a 20,480-face icosphere and a torus, synthetic
   reference images) on ``DEFAULT_CONFIG`` with ``num_inference_steps=4``
   instead of 28 to fit the time limit; each job (its writes flushed) must
   write its GLB, bake a finite 2048² texture and launch B1 exactly
   57 x 4 x 2 = 456 times;
13. job server (right after phase 4): ``unitex_torch.serving.serve`` over
   the resident phase-4 pipeline answers the same two jobs submitted over
   HTTP, the icosphere by path and the torus inlined as base64: both must
   reach ``done``, the GLBs fetched from ``/jobs/<id>/result`` must hold
   finite 2048² textures, and the two must launch B1 exactly 2 x 456
   times and nothing else; the line gives their wall time beside the sum
   of their stage times;
18. texture tools (after phase 13, on the resident phase-4 FLUX.1-dev
   trees and the icosphere job's GLB): FastTexture's ``inpaint_texture``
   on the job's texture halved to 1024², a centred disc of a quarter of
   the texels regenerated at strength 1 in 4 steps (exactly 4 x 57 = 228
   launches of B1, S = 4096 + 512; the kept texels bit for bit the input,
   the output finite in [0, 1]) and ``upscale_texture`` to 2048² at
   strength 0.3 of 28 steps (t_start 20: exactly 8 x 57 = 456 launches,
   S = 16384 + 512; the VAE encodes and decodes 2048² untiled, the peak
   printed and under 80 GB); then ``refine_texture`` (6 views of 512² of
   the GLB on a ring, a 512² texture, 200 steps: the last loss below the
   first) and ``refine_poses`` (a smooth texture, the estimates turned by
   0.05 rad, 100 steps: the rotation error must fall), each with its ms a
   step; ``ray_triangle_intersect`` of 512² pixel rays against
   ``make_icosphere(5)`` held to the rasterizer's triangle ids (the same
   triangle on at least 99.9 % of the pixels both hit), ``self_rt`` (2048
   points x 32 rays: inside all inner, outside none) and
   ``sphere_rt_views``, each with its seconds; ``unified_rgb_render`` and
   ``unified_pbr_render`` of the GLB on the v1 and v2 sweeps (8 frames of
   512² each), ``render_scene`` of the GLB and a moved icosphere (both
   object ids seen) and ``export_turntable`` to a PNG grid (3 x 3 of 512²)
   and a height-sweep GIF (9 frames); no attention launch outside
   FastTexture;
19. Redux and the field tools (after phase 18, on the same trees and the
   icosphere job's GLB, reference image and cache): SigLIP so400m (27
   layers of 16 heads of 72, 384², f32) from a seeded tree on the job's
   reference image (729 tokens of 1152, finite, seconds and peak, no
   attention launch: its S = 729 takes the plain attention), a depth-2
   copy on the card against the CPU (within ``SIGLIP_TOL`` of the largest
   CPU value); the tree under HF names with a 16-head ``config.json`` in
   ``<tmp>/siglip`` and a seeded Redux projection in ``<tmp>/flux/redux``,
   read back by ``ReduxConditioner`` on the card leaf for leaf, its own
   tower taken; the Redux job: the texture pass (adapters merged as the
   pipeline merges them) on the job's control strip and dual image with
   the [1, 729, 4096] Redux tokens as ``prompt_embeds``, 4 steps: exactly
   4 x 57 = 228 launches of B1, each at S = 14041, a finite strip in
   [0, 1]; then, each against the CPU on the card: ``knn`` with k = 16
   over 65536 x 65536 points (2048 queries on the CPU, the same indices
   where the distances are not tied within 1 ulp), ``query_ball`` (cap
   32), ``grid_sample_3d``, ``triplane_query`` and
   ``splat_points_to_grid`` (R = 128) within ``FIELD_TOL``; a field
   evaluated on the card at 128³ exported as an isosurface GLB and read
   back; ``uv_dilation`` and ``disk_blur`` on the job's 2048² texture;
   ``get_visible_faces`` on the six condition views; the mesh viewer over
   local HTTP on the card (a 512² PNG of each mode, ms a frame, 400 for a
   bad mode); ``roundtrip_oracle`` with its defaults beside ORACLE_r05's
   sphere, ``compare_golden`` of the job's cache against itself (the 120
   dB cap, SSIM 1), ``check_meshes`` and ``merge_reports`` over the
   phase's GLBs; the phase's wall as ``[redux] phase 19``;
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
7. CLI (after the seeded full-width RMBG-2.0 state dict is written to
   ``<tmp>/models/briaai/RMBG-2.0/model.safetensors``, its bytes printed):
   ``unitex_torch.run.main`` in process on the icosphere job with
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
   colour fix and gives the bake's seconds on the 2048² views; the CLI's
   pipeline must matte with ``BirefnetRemover``, called once, and the
   line gives the ``preprocess_reference_image`` seconds;
15. FLUX launcher (after phase 7, from the same ``<tmp>``):
   ``unitex_torch.scripts.train_flux_lora.main`` in process with
   ``--pretrain-models <tmp> --optimizer prodigy --preconditioning-loss
   --learning-rate 1.0 --lr-scheduler constant --max-train-steps 2`` at
   full FLUX.1-dev width on the launcher's synthetic data: each step must
   give a finite loss and launch B1 114 times and B2a and B2b 57 times
   each at D = 128 and nothing else, the first must move the LoRA ``b``
   leaves off 0, and the peak (the VAE decode under autograd at the 1024
   x 1536 grid among it, its blocks checkpointed) must stay under 80 GB;
8. int8 serving path from the checkpoint, with RMBG-1.4's seeded state
   dict added beside RMBG-2.0's:
   ``CustomRGBTextureFullPipeline(int8_serving=True, pretrain_models=<tmp>)``
   (W8A8 FLUX.1-dev, each bf16 kernel dropped as it is quantized) with
   ``attn_qk8=True`` set on its ``flux_cfg`` answers the icosphere job on
   the 4-step config: a GLB and a finite 2048² texture, 456 launches of B3
   and none of B1, the peak under 80 GB; it must matte with
   ``IsnetRemover`` (``build_background_remover`` tries RMBG-1.4 first);
11. SR options (after phase 8, from ``<tmp>/sd3``): one 512² view
   through ``TSDSRPipeline`` in bf16 and with ``TSDSRConfig(
   int8_serving=True, host_params=True, stage_pack_int4=True)``, each a
   finite 2048² image with 4 x 24 = 96 launches of B1 at D = 64, the
   staging seconds and the staged tree's bytes printed, and the PSNR
   between the two (random weights: printed, not gated);
14. TSD-SR training (after phase 11, from ``<tmp>/sd3``):
   ``unitex_torch.scripts.train_tsdsr.main`` in process on a synthetic
   folder of three 640² HR and 160² LR PNGs with ``--pretrain <tmp>
   --gt-size 512 --batch 1 --rank 64 --steps 2``: each step must give
   finite ``loss``, ``tsd_loss``, ``data_loss`` and ``reg_loss`` and
   launch B1, B2a and B2b at D = 64 exactly 24 x 5 = 120, 24 x 2 = 48 and
   48 times and nothing else (the student, the two teacher CFG forwards,
   the regularizer's CFG forward and its own phase; the student's and the
   regularizer's backward), the first must move the ``b`` leaves of both
   adapters off 0, the final checkpoint must read back leaf for leaf and
   the peak stay under 80 GB; the lines split each step into the VAE
   encodes, the student forward and backward, the teacher and
   regularizer forwards, the regularizer's forward and backward and the
   optimizers.  ``<tmp>`` is then deleted;
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
   ``kdtree`` bake (a finite texture, their seconds);
16. LTM trainer (after phase 10): ``unitex_torch.scripts.train_ltm.main``
   in process at the recipe's width (``--config large``, a bank of 40 x
   16384 points, 4096 queries) for 500 of its 20000 steps, logged every
   100: finite losses, 8 fixed batches' loss below the seeded initial
   tree's, the npz read back leaf for leaf and taken by
   ``RGBTextureFullPipeline(ltm_params=...)``; the
   bank's host seconds, seconds a step, the peak and each eval's hole
   PSNR beside the k=8 IDW fill's (printed, not gated); one more step
   traced by ``utils/profiling.profiled`` under ``annotate``: the trace's
   bytes, its CUDA kernel events (at least one), their busy time over
   their span (the device's idle share in the step) and the annotation;
   ``device_memory_stats()``; no attention kernel launches;
17. text encoders: seeded CLIP-L and T5-XXL (4.7 B parameters, f32) on
   the card: finite forwards on [2, 77] and [2, 512] ids (seconds, peak),
   depth-2 copies on [1, 64] ids within 1e-4 of the CPU's largest value
   (TF32 off), the HF-named state dicts converted back leaf for leaf
   equal, and the backend ``build_text_encoders`` picks here; no
   attention kernel launches.

The output ends with three lines: the kernels' JSON record
(``{"kernels": [...]}``), the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or run
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import gc
import glob
import io
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
# B1 also at FastTexture's S: the inpaint at 1024² and the upscale to
# 2048² (image tokens + 512 prompt tokens), and at a Redux job's: 6144
# noise + 6144 control + 1024 dual + 729 image-prompt tokens, the first
# length that is no multiple of 64 (109 full key tiles of 128 and one of 89)
REDUX_S = 6144 + 6144 + 1024 + 729
B1_SHAPES = ATTN_SHAPES + (4608, 16896, REDUX_S)
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
# the matting forwards on the card (f32, TF32 off) against the same module
# on the CPU: max|dlogit| <= 1e-3 of the largest CPU logit.  Both are f32;
# cuDNN's and the CPU's convolutions sum in other orders (about 1e-6 of a
# logit a layer), while a wrong tap, window or fold moves logits by tens
# of per cent.
MATTING_TOL = 1e-3
MATTING_SEEDS = {"isnet": 21, "birefnet": 22}   # the seeded state dicts


KERNEL_FUNCTIONS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                    "flash_bwd_dq_kernel", "flash_qk8_kernel")
# B1 at the SD3 transformer's head width: 24 heads of 64, S = 32² latent
# patches + 154 prompt tokens; batches of 8 latent tiles and the 2x3 grid's
# last chunk of 6
SD3_H, SD3_D, SD3_S = 24, 64, 32 * 32 + 154
SD3_BATCHES = (8, 6)
# B2a/B2b at D = 64: the TSD-SR trainer's backward (one 512² crop), and a
# batch of 8
SD3_BWD_BATCHES = (1, 8)


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
    each time.  Returns B1's record (at S = 13824, its error the largest
    over every S), its ms at each S, and its record at the Redux job's
    ``REDUX_S``."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, D = 1, 24, 128
    record = redux = None
    worst = 0.0
    ms_at = {}
    for S in B1_SHAPES:
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
        rec = {
            "name": "flash_attn_fwd", "route": "cuda",
            "source": "unitex_torch/csrc/flash_attn_fwd.cu",
            "replaces": "unitex_tpu/ops/attention.py:49",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_BF16_FLOPS
            >= nbytes / PEAK_BYTES else "bytes",
            "library_ms": lib_ms,
        }
        if S == ATTN_SHAPES[0]:
            record = rec
        elif S == REDUX_S:
            redux = dict(rec, name=f"flash_attn_fwd (S={S}, Redux)",
                         max_abs_err=err_o)
        del q, k, v, out, lse
    record["max_abs_err"] = worst
    return record, ms_at, redux


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
                ("flash_attn_bwd_dkv", "flash_bwd_dkv_kernel<128>", 8, 2,
                 ms_dkv),
                ("flash_attn_bwd_dq", "flash_bwd_dq_kernel<128>", 6, 1, ms_dq)):
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


def check_flash_backward_d64(attn, torch, ptxas: dict) -> list:
    """B2a and B2b at D = 64 (their second instantiation, the TSD-SR
    trainer's backward through SD3's 24 heads of 64) against the plain
    backward (f32 on the same bf16 inputs, one head at a time) at
    [B, 1178, 24, 64] for each batch of ``SD3_BWD_BATCHES``, each gradient
    within ``GRAD_REL`` of its largest reference value.  Each kernel's
    bound is the larger of the tensor-core time (8·B·H·S²·D operations for
    B2a, 6·B·H·S²·D for B2b), the SFU time of its B·H·S² exponentials and
    the memory time; the pair is timed against
    ``scaled_dot_product_attention``'s backward.  Returns their records
    (the first batch's times)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(6)
    H, D, S = SD3_H, SD3_D, SD3_S
    records = {}
    worst = {"dkv": 0.0, "dq": 0.0}
    for B in SD3_BWD_BATCHES:
        q, k, v, g = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                      .to(torch.bfloat16) for _ in range(4))
        out, lse = attn.flash_attention(q, k, v)
        drow = attn._row_dot(g, out)
        before = (attn.launches_bwd_dkv_d64, attn.launches_bwd_dq_d64)
        dk, dv = attn.flash_attention_bwd_dkv(q, k, v, g, lse, drow)
        dq = attn.flash_attention_bwd_dq(q, k, v, g, lse, drow)
        torch.cuda.synchronize()
        if (attn.launches_bwd_dkv_d64, attn.launches_bwd_dq_d64) != (
                before[0] + 1, before[1] + 1):
            raise AssertionError("the backward at D = 64 did not count one "
                                 "launch of each D = 64 instantiation")
        got = {"dq": dq, "dk": dk, "dv": dv}
        err = dict.fromkeys(got, 0.0)
        ref_max = dict.fromkeys(got, 0.0)
        lse_bh = lse.reshape(B, H, S)

        def plain_head(h):
            sl = slice(h, h + 1)
            return dict(zip(("dq", "dk", "dv"), attn.attention_backward_reference(
                q[:, :, sl].float(), k[:, :, sl].float(), v[:, :, sl].float(),
                out[:, :, sl].float(), lse_bh[:, h].contiguous(),
                g[:, :, sl].float())))

        for h in range(H):
            ref = plain_head(h)
            for name, x in got.items():
                err[name] = max(err[name], (x[:, :, h:h + 1].float() - ref[name])
                                .abs().max().item())
                ref_max[name] = max(ref_max[name], ref[name].abs().max().item())
        torch.cuda.synchronize()
        bad = [n for n in got if not err[n] <= GRAD_REL * ref_max[n]]
        if bad:
            raise AssertionError(
                f"flash backward D=64 B={B}: " + ", ".join(
                    f"max|d{n}|={err[n]:.3e} (tol {GRAD_REL * ref_max[n]:.3e})"
                    for n in got))
        worst["dkv"] = max(worst["dkv"], err["dk"], err["dv"])
        worst["dq"] = max(worst["dq"], err["dq"])
        ms_dkv = cuda_ms(lambda: attn.flash_attention_bwd_dkv(q, k, v, g, lse, drow),
                         100)
        ms_dq = cuda_ms(lambda: attn.flash_attention_bwd_dq(q, k, v, g, lse, drow),
                        100)
        plain_ms = cuda_ms(lambda: [plain_head(h) for h in range(H)], 2)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        gt = g.transpose(1, 2)

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qt, kt, vt).backward(gt)
            qt.grad = kt.grad = vt.grad = None

        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                             100)
        lib_ms = cuda_ms(sdpa_fwd_bwd, 100) - fwd_ms
        bsd = B * S * H * D
        in_bytes = 4 * bsd * 2 + 2 * B * H * S * 4   # q, k, v, dO; lse, Drow
        t_exp = B * H * S * S / SFU_EXP_RATE
        for name, fn, mult, n_out, ms in (
                ("flash_attn_bwd_dkv_d64", "flash_bwd_dkv_kernel<64>", 8, 2,
                 ms_dkv),
                ("flash_attn_bwd_dq_d64", "flash_bwd_dq_kernel<64>", 6, 1,
                 ms_dq)):
            flops = mult * B * H * S * S * D
            t_ops = max(flops / PEAK_BF16_FLOPS, t_exp)
            nbytes = in_bytes + n_out * bsd * 2
            bound_ms = max(t_ops, nbytes / PEAK_BYTES) * 1e3
            print(f"[kernels] {name} [{B}, {S}, {H}, {D}]: ms={ms:.4f} "
                  f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} (tensor "
                  f"cores {flops / PEAK_BF16_FLOPS * 1e3:.4f}, exp on the SFUs "
                  f"{t_exp * 1e3:.4f}, memory {nbytes / PEAK_BYTES * 1e3:.4f}; "
                  f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of the "
                  f"bound); ptxas: {ptxas[fn]}", flush=True)
            if name not in records:
                records[name] = {
                    "name": name, "route": "cuda",
                    "source": "unitex_torch/csrc/flash_attn_bwd.cu",
                    "replaces": "unitex_tpu/ops/attention.py:" + (
                        "235" if "dkv" in name else "278"),
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "operations" if t_ops >= nbytes / PEAK_BYTES
                    else "bytes",
                    "library_ms": lib_ms,
                }
        print(f"[kernels] flash backward D=64 [{B}, {S}, {H}, {D}]: B2a+B2b="
              f"{ms_dkv + ms_dq:.4f} ms plain_ms={plain_ms:.3f} library_ms "
              f"(sdpa backward)={lib_ms:.4f} ({(ms_dkv + ms_dq) / lib_ms:.3f}x "
              f"the library's time) " + " ".join(
                  f"max|d{n}|={err[n]:.3e} (tol {GRAD_REL * ref_max[n]:.3e})"
                  for n in got), flush=True)
        del q, k, v, g, out, lse, lse_bh, drow, dq, dk, dv, got, qt, kt, vt, gt
        torch.cuda.empty_cache()
    records["flash_attn_bwd_dkv_d64"]["max_abs_err"] = worst["dkv"]
    records["flash_attn_bwd_dq_d64"]["max_abs_err"] = worst["dq"]
    return [records["flash_attn_bwd_dkv_d64"], records["flash_attn_bwd_dq_d64"]]


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


def run_main_path(attn, torch, keep_dir=None):
    """The serving path; returns (B1 launches, the pipeline).  With
    ``keep_dir`` the icosphere job's GLB, reference image and cache are
    copied there as ``icosphere.glb``, ``icosphere.png`` and
    ``icosphere_cache/``."""
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
                                        async_io=True, device="cuda")
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
            wall_returned = time.perf_counter() - t0
            pipe.flush_io()   # async_io: the GLB is written on a thread
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
            print(f"[main] job {name}: wall {wall:.2f}s (GLB write "
                  f"flushed; {wall_returned:.2f}s to the call's return) stages "
                  + " ".join(f"{k}={v:.3f}s" for k, v in stages.items())
                  + f" peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
                  f" flash_attn_fwd launches {n}", flush=True)
            if not os.path.exists(glb):
                raise AssertionError(f"job {name}: no GLB at {glb}")
            if keep_dir is not None and name == "icosphere":
                shutil.copy(glb, os.path.join(keep_dir, "icosphere.glb"))
                shutil.copy(img_path, os.path.join(keep_dir, "icosphere.png"))
                shutil.copytree(os.path.join(out_dir, "cache"),
                                os.path.join(keep_dir, "icosphere_cache"))
            if tuple(tex.shape) != (2048, 2048, 3) or not bool(
                    torch.isfinite(tex).all()):
                raise AssertionError(
                    f"job {name}: texture {tuple(tex.shape)} not a finite 2048²")
            if n != per_job:
                raise AssertionError(
                    f"job {name}: {n} flash_attn_fwd launches, expected {per_job}")
    return total, pipe


def matting_model(torch, name: str, device: str = "cuda", cfg=None):
    """(config, seeded state dict on ``device``, converter, forward,
    remover class) of the matting model ``name`` ("isnet": RMBG-1.4,
    "birefnet": RMBG-2.0), at full width unless ``cfg`` is given."""
    from unitex_torch.image import isnet
    from unitex_torch.models import birefnet

    if name == "isnet":
        default, sd_fn, convert, forward, remover = (
            isnet.IsnetConfig.rmbg14, isnet.isnet_state_dict,
            isnet.convert_isnet_torch, isnet.isnet_forward, isnet.IsnetRemover)
    else:
        default, sd_fn, convert, forward, remover = (
            birefnet.BiRefNetConfig.rmbg20, birefnet.birefnet_state_dict,
            birefnet.convert_birefnet_torch, birefnet.birefnet_forward,
            birefnet.BirefnetRemover)
    cfg = cfg or default()
    gen = torch.Generator(device=device).manual_seed(MATTING_SEEDS[name])
    return cfg, sd_fn(gen, cfg), convert, forward, remover


def run_matting(torch, device: str = "cuda", configs=None,
                forward_size: int = 256) -> None:
    """Phase 12: ISNet (RMBG-1.4) and BiRefNet (RMBG-2.0) at full width
    from their seeded state dicts: the forward at ``forward_size``² on the
    card against the same parameters on the CPU, then the remover at its
    1024² on a 512² synthetic image (seconds of a first and a second call,
    peak, a finite matte of the image's size).  ``device``, ``configs``
    (tiny ones) and a smaller ``forward_size`` let it rehearse on the
    CPU."""
    import numpy as np
    from PIL import Image

    from unitex_torch.utils.params import tree_to

    yy, xx = np.mgrid[:512, :512]
    img = np.stack([xx // 2, yy // 2, 255 - xx // 2], -1).astype(np.uint8)
    img[(yy - 256) ** 2 + (xx - 256) ** 2 < 160 ** 2] = (200, 60, 30)
    image = Image.fromarray(img)
    x = np.random.default_rng(7).normal(
        size=(1, forward_size, forward_size, 3)).astype(np.float32)
    for name in ("isnet", "birefnet"):
        cfg, sd, convert, forward, remover_cls = matting_model(
            torch, name, device, (configs or {}).get(name))
        params = convert(sd, cfg, device)
        del sd
        n_params = sum(leaf.numel() for _, leaf in _named_leaves(params))

        def logits(out):
            return out[0] if isinstance(out, list) else out

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            got = logits(forward(params, cfg,
                                 torch.from_numpy(x).to(device))).cpu()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.no_grad():
            want = logits(forward(tree_to(params, "cpu"), cfg,
                                  torch.from_numpy(x)))
        t_cpu = time.perf_counter() - t0
        err = float((got - want).abs().max())
        limit = MATTING_TOL * float(want.abs().max())
        print(f"[matting] {name} ({n_params / 1e6:.1f} M parameters): "
              f"{forward_size}² "
              f"forward max|dlogit| {err:.3e} (limit {limit:.3e}); card "
              f"{t_card:.3f}s (first call), CPU {t_cpu:.3f}s", flush=True)
        if not math.isfinite(err) or err > limit:
            raise AssertionError(f"matting {name}: card forward off the CPU's "
                                 f"by {err} > {limit}")
        remover = remover_cls(params, cfg)
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            matte = remover(image)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        m = np.asarray(matte)
        print(f"[matting] {name} remover at {cfg.size}² on a 512² image: "
              f"{secs[0]:.3f}s first call, {secs[1]:.3f}s second; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; matte "
              f"{matte.mode} {matte.size} mean {m.mean():.1f}", flush=True)
        if matte.mode != "L" or matte.size != image.size or not np.isfinite(
                m.astype(np.float32)).all():
            raise AssertionError(f"matting {name}: matte {matte.mode} "
                                 f"{matte.size}")
        del params, remover
        gc.collect()
        torch.cuda.empty_cache()


def write_matting_checkpoint(root: str, name: str, sd) -> int:
    """The state dict ``sd`` of matting model ``name`` ("isnet" or
    "birefnet") as ``<root>/briaai/RMBG-{1.4,2.0}/model.safetensors``, where
    ``build_background_remover`` looks; returns its bytes."""
    from safetensors.torch import save_file

    d = os.path.join(root, "briaai",
                     "RMBG-1.4" if name == "isnet" else "RMBG-2.0")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "model.safetensors")
    save_file({k: v.contiguous().cpu() for k, v in sd.items()}, path)
    nbytes = os.path.getsize(path)
    print(f"[matting] wrote {path}: {nbytes} bytes", flush=True)
    return nbytes


def run_serving(attn, torch, pipe) -> None:
    """Phase 13: ``unitex_torch.serving.serve`` over the resident phase-4
    pipeline (``async_io=True``) answers two jobs over HTTP, the icosphere
    by path and the torus inlined as base64; each must reach ``done``, its
    GLB from ``/jobs/<id>/result`` must hold a finite texture of the
    config's atlas (2048²), and the two must launch B1 exactly 2 x 456
    times (57 blocks x 4 steps x 2 passes a job) and nothing else."""
    import base64
    import threading
    import urllib.request

    import numpy as np

    from unitex_torch.geometry.io.mesh_io import load_mesh
    from unitex_torch.serving import serve

    cfg = pipe.flux_cfg
    per_job = ((cfg.num_layers + cfg.num_single_layers)
               * pipe.config.diffusion.num_inference_steps * 2)
    uv = pipe.config.bake.uv_size

    def request(url, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(url, data=data, headers={
            "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.read()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as d:
        jobs = make_assets(d)
        httpd = serve(pipe, os.path.join(d, "work"), port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            before = _counts(attn)
            t0 = time.perf_counter()
            ids = []
            for i, (name, mesh_path, img_path) in enumerate(jobs):
                if i == 0:
                    body = {"image_path": img_path, "mesh_path": mesh_path}
                else:
                    with open(img_path, "rb") as f:
                        img = base64.b64encode(f.read()).decode()
                    with open(mesh_path, "rb") as f:
                        mesh = base64.b64encode(f.read()).decode()
                    body = {"image_b64": img, "mesh_b64": mesh,
                            "mesh_ext": ".obj"}
                body["name"] = name
                ids.append(json.loads(request(base + "/jobs", body))["id"])
            recs = {}
            while len(recs) < len(ids):
                for job_id in ids:
                    rec = json.loads(request(f"{base}/jobs/{job_id}"))
                    if rec["status"] in ("done", "failed"):
                        recs[job_id] = rec
                time.sleep(0.1)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            n = tuple(a - b for a, b in zip(_counts(attn), before))
            stage_sum = sum(r.get("preprocess_s", 0.0) + r.get("device_s", 0.0)
                            for r in recs.values())
            print(f"[serve] two HTTP jobs: wall {wall:.2f}s, sum of their "
                  f"stages {stage_sum:.2f}s ("
                  + ", ".join(f"{r['name']} {r['status']} preprocess "
                              f"{r.get('preprocess_s', 0):.2f}s device "
                              f"{r.get('device_s', 0):.2f}s"
                              for r in recs.values())
                  + f"); launches B1 {n[0]}", flush=True)
            for job_id in ids:
                rec = recs[job_id]
                if rec["status"] != "done":
                    raise AssertionError(f"serve: job {rec}")
                glb = os.path.join(d, f"{job_id}.glb")
                with open(glb, "wb") as f:
                    f.write(request(f"{base}/jobs/{job_id}/result"))
                tex = load_mesh(glb).texture
                if tex is None or tex.shape[:2] != (uv, uv) or not \
                        np.isfinite(tex.astype(np.float32)).all():
                    raise AssertionError(f"serve: job {rec['name']} texture "
                                         f"{None if tex is None else tex.shape}")
            if not _only(n, B1=2 * per_job):
                raise AssertionError(f"serve: launches {COUNTED} {n}, expected "
                                     f"B1 {2 * per_job} and nothing else")
        finally:
            httpd.jobs.stop()
            httpd.shutdown()
            httpd.server_close()


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
    from unitex_torch.models.birefnet import BirefnetRemover
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
        # the CLI's pipeline and the mattes its learned remover makes
        pipes, mattes = [], []
        pipe_cls, matte = run.CustomRGBTextureFullPipeline, BirefnetRemover.__call__

        class Seen(pipe_cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                pipes.append(self)

        def counted(self, image):
            mattes.append(image.size)
            return matte(self, image)

        run.CustomRGBTextureFullPipeline, BirefnetRemover.__call__ = Seen, counted
        try:
            run.main(["--image", img_path, "--mesh", mesh_path, "--out", out,
                      "--pretrain-models", root, "--fast-steps",
                      str(FAST_STEPS), "--super-resolution"])
        finally:
            run.CustomRGBTextureFullPipeline = pipe_cls
            BirefnetRemover.__call__ = matte
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
        rembg = type(pipes[0].rembg).__name__ if pipes else None
        print(f"[cli] matting: {rembg} from <root>/briaai/RMBG-2.0, called on "
              f"{mattes}; preprocess_reference_image "
              f"{rec['preprocess_reference_image']:.3f}s", flush=True)
        if rembg != "BirefnetRemover" or len(mattes) != 1:
            raise AssertionError(f"cli: matting by {rembg}, {len(mattes)} "
                                 f"calls of BirefnetRemover")
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
        if not _only(n, B1=per_job, B1_d64=per_sr):
            raise AssertionError(f"cli: launches {COUNTED} {n}, expected B1 "
                                 f"{per_job}, B1(D=64) {per_sr}, nothing else")
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


# the kernels in the order of ``_counts`` and of the records
COUNTED = ("B1", "B2a", "B2b", "B3", "B1(D=64)", "B2a(D=64)", "B2b(D=64)")
NONE = (0,) * len(COUNTED)


def _counts(attn) -> tuple:
    """Launches of B1 (D = 128), B2a, B2b, B3, then B1, B2a and B2b at
    D = 64."""
    return (attn.launches, attn.launches_bwd_dkv, attn.launches_bwd_dq,
            attn.launches_qk8, attn.launches_d64, attn.launches_bwd_dkv_d64,
            attn.launches_bwd_dq_d64)


def _reset(attn) -> None:
    attn.launches = attn.launches_bwd_dkv = attn.launches_bwd_dq = 0
    attn.launches_qk8 = attn.launches_d64 = 0
    attn.launches_bwd_dkv_d64 = attn.launches_bwd_dq_d64 = 0


def _only(n: tuple, **want: int) -> bool:
    """Whether the counts ``n`` are ``want`` (by name: B1, B2a, B2b, B3,
    B1_d64, B2a_d64, B2b_d64; a value of -1 means "at least one") and 0
    elsewhere."""
    names = ("B1", "B2a", "B2b", "B3", "B1_d64", "B2a_d64", "B2b_d64")
    for name, got in zip(names, n):
        w = want.get(name, 0)
        if (got == 0) if w == -1 else (got != w):
            return False
    return True


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
    # build_background_remover tries RMBG-1.4 first
    if type(pipe.rembg).__name__ != "IsnetRemover":
        raise AssertionError(f"int8: matting by {type(pipe.rembg).__name__}, "
                             f"expected IsnetRemover")
    n_q, n_f = count_quantized(pipe.transformer_params)
    print(f"[int8] init (checkpoint streamed in bf16 + W8A8 quantization) "
          f"{time.perf_counter() - t0:.2f}s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; serving tree "
          f"{_tree_bytes(pipe.transformer_params) / 2**30:.2f} GiB ({n_q / 1e9:.3f} "
          f"G int8 elements, {n_f / 1e9:.3f} G float elements in leaves of 2+ "
          f"axes); attn_qk8=True; matting by IsnetRemover", flush=True)
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
        if not _only(n, B3=per_job):
            raise AssertionError(
                f"int8 job {name}: launches {COUNTED} {n}, expected B3 "
                f"{per_job} and nothing else")
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
        if not _only(n, B1_d64=per_view):
            raise AssertionError(f"sr {name}: launches {COUNTED} {n}, expected "
                                 f"B1(D=64) {per_view} and nothing else")
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
    want = (2 * n_blocks, n_blocks, n_blocks, 0, 0, 0, 0)
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


TSD_STEPS = 2
TSD_TIMERS = ("tsd_vae_encode", "tsd_student_forward",
              "tsd_teacher_reg_forwards", "tsd_student_backward",
              "tsd_optimizer_student",
              "tsd_reg_forward", "tsd_reg_backward", "tsd_optimizer_reg")


def write_sr_pairs(d: str, n: int = 3, hr: int = 640, scale: int = 4):
    """``n`` synthetic HR images of ``hr``² and their LR of ``hr/scale``²
    (MATLAB bicubic) as PNGs under ``d/{hr,lr}``; returns the folders."""
    import numpy as np
    from PIL import Image

    from unitex_torch.image.matlab import imresize

    rng = np.random.default_rng(7)
    dirs = {k: os.path.join(d, k) for k in ("hr", "lr")}
    for path in dirs.values():
        os.makedirs(path, exist_ok=True)
    yy, xx = np.mgrid[:hr, :hr] / (hr - 1.0)
    for i in range(n):
        f = rng.uniform(4, 16, size=3)
        img = np.stack([0.5 + 0.4 * np.sin(f[c] * xx + c) * np.cos(f[2 - c] * yy)
                        for c in range(3)], axis=-1).astype(np.float32)
        lr = np.clip(imresize(img, 1.0 / scale), 0, 1)
        for key, x in (("hr", img), ("lr", lr)):
            Image.fromarray(np.round(x * 255).astype(np.uint8)).save(
                os.path.join(dirs[key], f"{i:03d}.png"))
    return dirs["lr"], dirs["hr"]


def run_tsdsr_training(attn, torch, root: str) -> None:
    """Phase 14: ``unitex_torch.scripts.train_tsdsr.main`` in process from
    the seeded SD3-medium checkpoint under ``root`` on synthetic 640² / 160²
    pairs at 512² crops, rank 64, two steps.  Each step must give finite
    losses and launch B1, B2a and B2b at D = 64 exactly 24 x 5, 24 x 2 and
    24 x 2 times and nothing else; the first must move the ``b`` leaves of
    both adapters off 0; the final checkpoint must read back leaf for leaf;
    the peak must stay under 80 GB."""
    from unitex_torch.models.sd3.config import SD3Config
    from unitex_torch.scripts import train_tsdsr
    from unitex_torch.utils.timer import CPUTimer

    layers = SD3Config.sd3_medium().num_layers
    # student, two teacher CFG forwards, the regularizer's CFG forward and
    # its own phase forward; the backward of the student and the regularizer
    want = (0, 0, 0, 0, 5 * layers, 2 * layers, 2 * layers)
    d = tempfile.mkdtemp(prefix="chip_smoke_tsdsr_")
    try:
        lr_dir, hr_dir = write_sr_pairs(os.path.join(d, "data"))
        out = os.path.join(d, "run")
        steps = []
        t_last = [time.perf_counter()]
        before = [_counts(attn)]

        def on_step(it, state, metrics):
            torch.cuda.synchronize()
            now = time.perf_counter()
            n = tuple(a - b for a, b in zip(_counts(attn), before[0]))
            rec = CPUTimer.records
            b_max = {tree: max(float(leaf.detach().abs().max()) for path, leaf
                               in _named_leaves(getattr(state, tree))
                               if path.endswith("/b"))
                     for tree in ("student_lora", "reg_lora")}
            vals = {k: float(v) for k, v in metrics.items()}
            print(f"[tsdsr] step {it}: " + " ".join(
                f"{k} {v:.6f}" for k, v in vals.items())
                + f"; {now - t_last[0]:.3f}s "
                + ("since the call, the load included" if not steps
                   else "since the last step") + " (" + " ".join(
                    f"{k[4:]}={rec[k]:.3f}s" for k in TSD_TIMERS)
                + f") launches {COUNTED} {n} max|b| student "
                f"{b_max['student_lora']:.3e} reg {b_max['reg_lora']:.3e}",
                flush=True)
            if not all(math.isfinite(v) for v in vals.values()):
                raise AssertionError(f"tsdsr step {it}: losses {vals}")
            if n != want:
                raise AssertionError(f"tsdsr step {it}: launches {n}, "
                                     f"expected {want}")
            if min(b_max.values()) == 0.0:
                raise AssertionError(f"tsdsr step {it}: a LoRA's b leaves are "
                                     f"still 0 ({b_max})")
            steps.append(now - t_last[0])
            t_last[0] = now
            before[0] = _counts(attn)

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train_tsdsr.main(
            ["--lr-dir", lr_dir, "--hr-dir", hr_dir, "--pretrain", root,
             "--gt-size", "512", "--batch", "1", "--rank", "64", "--steps",
             str(TSD_STEPS), "--log-every", "1", "--output-dir", out],
            on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ckpt = os.path.join(out, "checkpoints", f"checkpoint-{TSD_STEPS}",
                            "state.pt")
        saved = dict(_named_leaves(torch.load(ckpt, map_location="cpu",
                                              weights_only=True)))
        live = dict(_named_leaves({"student_lora": state.student_lora,
                                   "reg_lora": state.reg_lora}))
        same = saved.keys() == live.keys() and all(
            torch.equal(saved[k], live[k].detach().cpu()) for k in live)
        print(f"[tsdsr] SD3-medium from <root>/sd3, 512² crops (S = "
              f"{SD3_S}), rank 64: {len(steps)} steps in {wall:.2f}s with "
              f"set-up (steps " + ", ".join(f"{t:.3f}s" for t in steps)
              + f"); peak {peak / 2**30:.2f} GiB; checkpoint {ckpt} "
              f"({os.path.getsize(ckpt)} bytes, {len(live)} leaves) read back "
              f"{'equal' if same else 'DIFFERENT'}", flush=True)
        if len(steps) != TSD_STEPS:
            raise AssertionError(f"tsdsr: {len(steps)} steps")
        if not same:
            raise AssertionError("tsdsr: the checkpoint does not read back")
        if peak >= PEAK_LIMIT:
            raise AssertionError(f"tsdsr: peak {peak} bytes")
    finally:
        shutil.rmtree(d, ignore_errors=True)


FLUX_LAUNCHER_STEPS = 2


def run_flux_launcher(attn, torch, root: str) -> None:
    """Phase 15: ``unitex_torch.scripts.train_flux_lora.main`` in process
    with ``--pretrain-models <root> --optimizer prodigy
    --preconditioning-loss`` at full FLUX.1-dev width on the launcher's
    synthetic data, two steps.  Each must give a finite loss and launch B1
    114 times (57 forward, 57 recomputed) and B2a and B2b 57 times each at
    D = 128 and nothing else; the first must move the LoRA ``b`` leaves off
    0; the peak (the VAE decode under autograd at the 1024 x 1536 grid
    among it) must stay under 80 GB."""
    from unitex_torch.models.flux.config import FluxConfig
    from unitex_torch.scripts import train_flux_lora

    cfg = FluxConfig.flux1_dev()
    n_blocks = cfg.num_layers + cfg.num_single_layers
    want = (2 * n_blocks, n_blocks, n_blocks, 0, 0, 0, 0)
    d = tempfile.mkdtemp(prefix="chip_smoke_flux_launcher_")
    try:
        steps = []
        t_last = [time.perf_counter()]
        before = [_counts(attn)]

        def on_step(step, state, loss):
            torch.cuda.synchronize()
            now = time.perf_counter()
            n = tuple(a - b for a, b in zip(_counts(attn), before[0]))
            loss = float(loss)
            b_max = max(float(leaf.detach().abs().max()) for path, leaf in
                        _named_leaves(state.lora) if path.endswith("/b"))
            d_est = float(state.opt_state["estim_lr"])
            since = ("since the call, the load included" if not steps
                     else "since the last step")
            print(f"[flux_launcher] step {step}: loss {loss:.6f} "
                  f"{now - t_last[0]:.3f}s {since} (batch and step) peak so far "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                  f"launches {COUNTED} {n} max|lora b| {b_max:.3e} prodigy d "
                  f"{d_est:.3e}", flush=True)
            if not math.isfinite(loss):
                raise AssertionError(f"flux launcher step {step}: loss {loss}")
            if n != want:
                raise AssertionError(f"flux launcher step {step}: launches "
                                     f"{n}, expected {want}")
            if b_max == 0.0:
                raise AssertionError(f"flux launcher step {step}: the LoRA b "
                                     f"leaves are still 0")
            steps.append(now - t_last[0])
            t_last[0] = now
            before[0] = _counts(attn)

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_flux_lora.main(
            ["--pretrain-models", root, "--optimizer", "prodigy",
             "--preconditioning-loss", "--learning-rate", "1.0",
             "--lr-scheduler", "constant", "--max-train-steps",
             str(FLUX_LAUNCHER_STEPS), "--output-dir", os.path.join(d, "out")],
            on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        print(f"[flux_launcher] FLUX.1-dev from <root>/flux (remat, rank 16, "
              f"Prodigy lr 1.0, preconditioning loss weight 1): "
              f"{len(steps)} steps in {wall:.2f}s with loading (steps "
              + ", ".join(f"{t:.3f}s" for t in steps)
              + f"); peak {peak / 2**30:.2f} GiB", flush=True)
        if len(steps) != FLUX_LAUNCHER_STEPS:
            raise AssertionError(f"flux launcher: {len(steps)} steps")
        if peak >= PEAK_LIMIT:
            raise AssertionError(f"flux launcher: peak {peak} bytes")
    finally:
        shutil.rmtree(d, ignore_errors=True)


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
                if not _only(n, B1=per_job):
                    raise AssertionError(f"ltm job {name}: launches {COUNTED} "
                                         f"{n}, expected B1 {per_job} and "
                                         f"nothing else")
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


LTM_TRAIN_ARGS = ("--config", "large", "--bank-meshes", "40", "--bank-points",
                  "16384", "--n-query", "4096", "--steps", "500",
                  "--log-every", "100")


LTM_FIXED_BATCHES = 8


def run_ltm_training(torch, device: str = "cuda",
                     args=LTM_TRAIN_ARGS) -> None:
    """Phase 16: ``unitex_torch.scripts.train_ltm.main`` in process at the
    recipe's full width (``LTMConfig.large()``, a bank of 40 meshes x 16384
    points, 4096 queries), 500 steps logged every 100 to fit the time
    limit (the recipe runs 20000).  Every logged loss must be finite.  A
    logged loss is one batch's, and batches' losses differ several-fold
    while 500 steps move a fixed batch's by a few per cent, so learning
    is gated on ``LTM_FIXED_BATCHES`` fixed batches of the training
    meshes: their summed loss (the encoder's mean, no noise) under the
    final tree must be below the seeded initial tree's.  The npz must read
    back through ``load_params`` leaf for leaf equal to the best state and
    be taken by ``RGBTextureFullPipeline(ltm_params=...)`` (no FLUX tree:
    its LTM loader only).  One more train step runs inside
    ``profiled(...)`` under ``annotate("ltm_train_step")``: the trace must
    hold the annotation and, on the card, at least one kernel event.  The
    hole PSNRs are printed beside the k=8 IDW fill's, not gated."""
    from unitex_torch.models.ltm import init_ltm_params, ltm_vae_loss
    from unitex_torch.pipeline import RGBTextureFullPipeline
    from unitex_torch.scripts import train_ltm
    from unitex_torch.training.ltm import ltm_train_step, sample_device_batch
    from unitex_torch.utils.param_cache import load_params
    from unitex_torch.utils.profiling import (
        annotate, device_memory_stats, profiled,
    )

    cuda = device == "cuda"
    d = tempfile.mkdtemp(prefix="chip_smoke_ltm_train_")
    try:
        npz = os.path.join(d, "ltm.npz")
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train_ltm.main(list(args) + ["--out", npz, "--report",
                                           os.path.join(d, "report.json"),
                                           "--device", device])
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        log, elapsed = out["log"], out["elapsed"]
        for rec in log:
            print(f"[ltm_train] step {rec['step']}: loss {rec['loss']} hole "
                  f"PSNR {rec['holdout_hole_psnr_db']} dB, IDW k=8 "
                  f"{rec['idw_k8_hole_psnr_db']} dB", flush=True)
        per_step = ((elapsed[-1] - elapsed[0])
                    / max(1, log[-1]["step"] - log[0]["step"]))
        print(f"[ltm_train] {out['cfg']}: bank {tuple(out['bank'].shape)} "
              f"built in {out['bank_seconds']:.3f}s on the host; "
              f"{log[-1]['step']} steps in {wall:.2f}s with set-up; "
              f"{per_step:.5f}s a step after the first eval (evals "
              f"included); best hole PSNR {out['best_psnr']:.2f} dB at step "
              f"{out['best_step']}; peak {peak / 2**30:.2f} GiB", flush=True)
        losses = [rec["loss"] for rec in log]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"ltm_train: losses {losses}")
        state, cfg, tcfg = out["state"], out["cfg"], out["tcfg"]
        fgen = torch.Generator(device=device).manual_seed(99)
        n_train = out["bank"].shape[0] - 1      # the last mesh is held out
        fixed = [sample_device_batch(out["bank"][i % n_train], tcfg.n_query,
                                     out["curriculum"], generator=fgen)
                 for i in range(LTM_FIXED_BATCHES)]
        # the seeded tree ``main`` started from
        init = init_ltm_params(torch.Generator(device=device).manual_seed(0),
                               cfg, device=device)

        def fixed_loss(params):
            with torch.no_grad():
                return sum(float(ltm_vae_loss(
                    params, cfg, b["points"], b["colors"], b["valid"],
                    b["query_points"], b["query_colors"],
                    kl_weight=tcfg.kl_weight)) for b in fixed)

        before, after = fixed_loss(init), fixed_loss(state.params)
        print(f"[ltm_train] logged loss first {losses[0]}, last {losses[-1]} "
              f"(one batch each); {LTM_FIXED_BATCHES} fixed batches' summed "
              f"loss {before:.6e} at init, {after:.6e} after "
              f"{log[-1]['step']} steps ({100 * (after / before - 1):+.2f} %)",
              flush=True)
        if not (math.isfinite(after) and after < before):
            raise AssertionError(f"ltm_train: the fixed batches' loss {after} "
                                 f"is not below the initial {before}")
        saved = dict(_named_leaves(load_params(npz)))
        best = dict(_named_leaves(out["best_params"]))
        same = saved.keys() == best.keys() and all(
            torch.equal(saved[k], best[k]) for k in best)
        pipe = RGBTextureFullPipeline(ltm_params=npz, device=device)
        taken = (pipe.ltm_cfg == out["cfg"] and all(
            torch.equal(leaf.cpu(), best[k])
            for k, leaf in _named_leaves(pipe.ltm_params)))
        print(f"[ltm_train] {os.path.getsize(npz)} bytes, {len(best)} leaves: "
              f"read back {'equal' if same else 'DIFFERENT'}; the pipeline's "
              f"LTM loader {'took it' if taken else 'DIFFERS'}", flush=True)
        if not (same and taken):
            raise AssertionError("ltm_train: the checkpoint does not read back")
        del pipe

        gen = torch.Generator(device=device).manual_seed(7)
        batch = sample_device_batch(out["bank"][0], tcfg.n_query,
                                    out["curriculum"], generator=gen)
        trace_dir = os.path.join(d, "trace")
        with profiled(trace_dir, "ltm_train_step"):
            with annotate("ltm_train_step"):
                ltm_train_step(state, batch, cfg, tcfg, out["tx"], generator=gen)
        path = os.path.join(trace_dir, "ltm_train_step.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name") for e in events}
        kern = [e for e in events if e.get("cat") == "kernel"]
        kernels = len(kern)
        idle = ""
        if kern:
            # the card's busy time (kernels may overlap: an upper bound)
            # over the span from the first kernel's start to the last's end
            busy = sum(e["dur"] for e in kern)
            span = (max(e["ts"] + e["dur"] for e in kern)
                    - min(e["ts"] for e in kern))
            idle = (f" (kernels {busy / 1e3:.3f} ms busy in a {span / 1e3:.3f} ms "
                    f"span: idle share {max(0.0, 1 - busy / span):.3f})")
        print(f"[ltm_train] trace of one step: {os.path.getsize(path)} bytes, "
              f"{len(events)} events, {kernels} CUDA kernel events{idle}, "
              f"annotation {'present' if 'ltm_train_step' in names else 'MISSING'}; "
              f"device_memory_stats {device_memory_stats()}", flush=True)
        if "ltm_train_step" not in names or (cuda and kernels < 1):
            raise AssertionError("ltm_train: the trace lacks the annotation "
                                 "or a kernel event")
        if peak >= PEAK_LIMIT:
            raise AssertionError(f"ltm_train: peak {peak} bytes")
    finally:
        shutil.rmtree(d, ignore_errors=True)


# the CLIP text tower's and the T5 encoder's HF names of the tree's leaves
_CLIP_BLOCK = {"ln1": "layer_norm1", "q": "self_attn.q_proj",
               "k": "self_attn.k_proj", "v": "self_attn.v_proj",
               "out": "self_attn.out_proj", "ln2": "layer_norm2",
               "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
_CLIP_TOP = {"token_embedding": "embeddings.token_embedding",
             "position_embedding": "embeddings.position_embedding",
             "final_ln": "final_layer_norm"}
_T5_BLOCK = {"ln_attn": "layer.0.layer_norm", "q": "layer.0.SelfAttention.q",
             "k": "layer.0.SelfAttention.k", "v": "layer.0.SelfAttention.v",
             "o": "layer.0.SelfAttention.o", "ln_ff": "layer.1.layer_norm",
             "wo": "layer.1.DenseReluDense.wo",
             "wi_0": "layer.1.DenseReluDense.wi_0",
             "wi_1": "layer.1.DenseReluDense.wi_1",
             "wi": "layer.1.DenseReluDense.wi"}
_T5_TOP = {"embedding": "shared",
           "relative_bias": "encoder.block.0.layer.0.SelfAttention."
                            "relative_attention_bias",
           "final_ln": "encoder.final_layer_norm"}


def text_state_dict(params, kind: str) -> dict:
    """The HF state dict (``CLIPTextModel`` for ``kind="clip"``,
    ``T5EncoderModel`` for ``"t5"``) of a text-encoder tree, the inverse
    of ``models/text.convert_*``: linear kernels [d_in, d_out] ->
    ``.weight`` [d_out, d_in], stacked blocks -> one entry a layer.  The
    tensors are views of the tree's."""
    block, top, pre, blocks = (
        (_CLIP_BLOCK, _CLIP_TOP, "text_model.", "text_model.encoder.layers")
        if kind == "clip" else (_T5_BLOCK, _T5_TOP, "", "encoder.block"))
    sd = {}
    for path, leaf in _named_leaves(params):
        parts = path.strip("/").split("/")
        field = "bias" if parts[-1] == "bias" else "weight"
        if parts[-1] == "kernel":
            leaf = leaf.transpose(-1, -2)
        if parts[0] == "blocks":
            for i in range(leaf.shape[0]):
                sd[f"{blocks}.{i}.{block[parts[1]]}.{field}"] = leaf[i]
        else:
            sd[f"{pre}{top[parts[0]]}.{field}"] = leaf
    return sd


def _depth(tree, n: int):
    """The first ``n`` layers of a text-encoder tree (views)."""
    return {k: ({b: ({f: x[:n] for f, x in v.items()} if isinstance(v, dict)
                     else v[:n]) for b, v in tree[k].items()}
                if k == "blocks" else tree[k]) for k in tree}


TEXT_TOL = 1e-4   # depth-2 trees, the card against the CPU, of max|ref|
_TEXT_SHAPE_FIELDS = {
    "clip": ("vocab_size", "hidden_size", "mlp_dim", "num_layers"),
    "t5": ("vocab_size", "d_model", "d_kv", "d_ff", "num_layers", "num_heads",
           "relative_buckets", "gated_act")}


def run_text(torch, device: str = "cuda", clip_cfg=None, t5_cfg=None) -> None:
    """Phase 17: the seeded CLIP-L (``CLIPTextConfig.clip_l()``) and T5
    v1.1 XXL (``T5EncoderConfig.t5_v1_1_xxl()``, 4.7 B parameters, f32,
    about 19 GB) trees on the card.  Forwards on fixed ids, [2, 77] with
    an EOS and [2, 512], must be finite (seconds and peak printed).  A
    depth-2 copy of each tree on [1, 64] ids is held between the card and
    the CPU, TF32 off: max|Δ| <= ``TEXT_TOL`` (1e-4) of the largest CPU
    value, for CLIP's hidden states and pooled output and T5's hidden
    states (both f32; the sums run in other orders, about 1e-6 of a value,
    while a wrong mask, bias or scale moves them by tens of per cent).
    The HF-named state dicts of the seeded trees must convert back through
    ``convert_*`` and ``*_config_from_sd`` leaf for leaf equal; the line
    says which backend ``build_text_encoders`` picks on this machine."""
    import numpy as np

    from unitex_torch.models.text import (
        CLIPTextConfig, T5EncoderConfig, clip_config_from_sd,
        clip_text_forward, convert_clip_text, convert_t5_encoder,
        init_clip_text_params, init_t5_encoder_params, t5_config_from_sd,
        t5_encoder_forward,
    )
    from unitex_torch.models.text_encoders import build_text_encoders
    from unitex_torch.utils.params import tree_to

    cuda = device == "cuda"
    clip_cfg = clip_cfg or CLIPTextConfig.clip_l()
    t5_cfg = t5_cfg or T5EncoderConfig.t5_v1_1_xxl()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    rng = np.random.default_rng(17)

    def ids(shape, vocab, eos=None):
        a = rng.integers(0, vocab - 1 if eos is not None else vocab, shape)
        if eos is not None:
            a[:, shape[1] // 2:] = eos          # the padding is EOS too
            a[0, 3] = eos                       # an early EOS: pooled there
        return torch.as_tensor(a, device=device)

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device)
    t0 = time.perf_counter()
    clip = init_clip_text_params(gen.manual_seed(31), clip_cfg, device=device)
    t5 = init_t5_encoder_params(gen.manual_seed(32), t5_cfg, device=device)
    sync()
    init_s = time.perf_counter() - t0
    n_t5 = sum(x.numel() for _, x in _named_leaves(t5))
    clip_ids = ids((2, clip_cfg.max_positions), clip_cfg.vocab_size,
                   clip_cfg.eos_token_id)
    t5_ids = ids((2, 512), t5_cfg.vocab_size)
    times = {}
    with torch.no_grad():
        for name, fn in (("clip", lambda: clip_text_forward(clip, clip_cfg,
                                                             clip_ids)),
                         ("t5", lambda: (t5_encoder_forward(t5, t5_cfg,
                                                            t5_ids),))):
            for call in ("first", "second"):
                t0 = time.perf_counter()
                outs = fn()
                sync()
                times[f"{name} {call}"] = time.perf_counter() - t0
            shapes = [tuple(o.shape) for o in outs]
            finite = all(bool(torch.isfinite(o).all()) for o in outs)
            print(f"[text] {name} forward {shapes}: first "
                  f"{times[f'{name} first']:.4f}s, second "
                  f"{times[f'{name} second']:.4f}s, finite {finite}", flush=True)
            if not finite:
                raise AssertionError(f"text: {name} forward not finite")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"[text] seeded trees: CLIP-L {clip_cfg.num_layers} layers, T5 "
          f"{t5_cfg.num_layers} layers ({n_t5 / 1e9:.3f} B parameters, "
          f"{4 * n_t5 / 1e9:.2f} GB f32) made in {init_s:.3f}s; peak "
          f"{peak / 2**30:.2f} GiB", flush=True)

    # depth 2, the card against the CPU
    small = {"clip": _depth(clip, 2), "t5": _depth(t5, 2)}
    x_ids = ids((1, 64), clip_cfg.vocab_size, clip_cfg.eos_token_id)
    t_ids = ids((1, 64), t5_cfg.vocab_size)
    with torch.no_grad():
        dev_out = {"clip": clip_text_forward(small["clip"], clip_cfg, x_ids),
                   "t5": (t5_encoder_forward(small["t5"], t5_cfg, t_ids),)}
        cpu_out = {"clip": clip_text_forward(tree_to(small["clip"], "cpu"),
                                             clip_cfg, x_ids.cpu()),
                   "t5": (t5_encoder_forward(tree_to(small["t5"], "cpu"),
                                             t5_cfg, t_ids.cpu()),)}
    for name in ("clip", "t5"):
        for got, want in zip(dev_out[name], cpu_out[name]):
            err = float((got.cpu() - want).abs().max())
            ref = float(want.abs().max())
            print(f"[text] {name} depth 2 {tuple(want.shape)}: max|Δ| {err:.3e} "
                  f"against max|ref| {ref:.3e} (limit {TEXT_TOL * ref:.3e})",
                  flush=True)
            if not err <= TEXT_TOL * ref:
                raise AssertionError(f"text: {name} on {device} differs from "
                                     f"the CPU by {err}")
    del small, dev_out, cpu_out

    # the HF names and back
    for name, tree, cfg, conv, from_sd in (
            ("clip", clip, clip_cfg, convert_clip_text, clip_config_from_sd),
            ("t5", t5, t5_cfg, convert_t5_encoder, t5_config_from_sd)):
        sd = text_state_dict(tree, name)
        back_cfg = from_sd(sd)
        back = conv(sd, back_cfg, device=device)
        want, got = dict(_named_leaves(tree)), dict(_named_leaves(back))
        same = want.keys() == got.keys() and all(
            torch.equal(got[k], want[k]) for k in want)
        # the fields a state dict's shapes define
        cfg_same = all(getattr(back_cfg, f) == getattr(cfg, f)
                       for f in _TEXT_SHAPE_FIELDS[name])
        print(f"[text] {name}: {len(sd)} HF-named tensors -> {len(got)} leaves "
              f"{'equal' if same else 'DIFFERENT'}; config from the shapes "
              f"{'equal' if back_cfg == cfg else back_cfg}", flush=True)
        if not (same and cfg_same):
            raise AssertionError(f"text: the {name} state dict does not "
                                 f"convert back")
        del sd, back, want, got
    del clip, t5
    gc.collect()

    root = tempfile.mkdtemp(prefix="chip_smoke_text_")
    try:
        enc = build_text_encoders(root, device=device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[text] build_text_encoders on this machine (no tokenizer or "
          f"weight files under the root): "
          f"{type(enc).__name__ if enc is not None else 'None: zero embeddings'}",
          flush=True)


def _named_leaves(tree, prefix=""):
    """("/a/0/b", leaf) of a tree of dicts and lists (``None``, an absent
    branch, has no leaf)."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            yield from _named_leaves(v, f"{prefix}/{k}")
    elif tree is not None:
        yield prefix, tree


# phase 18: the texture tools on the serving phase's resident FLUX trees
TOOLS_TEX = 1024          # FastTexture's texture side (the job's 2048² atlas halved)
TOOLS_STEPS = 4           # the inpaint's steps (of 28 in serving), strength 1
UPSCALE_STEPS, UPSCALE_STRENGTH = 28, 0.3   # t_start = 20: 8 steps run
TOOLS_TXT = 512           # the zero prompt's tokens


def view_rays(torch, c2w, intr, H: int, W: int):
    """World-space rays [H·W, 3] (origins, unit directions) through the
    pixel centres of a perspective camera, row-major, row 0 at the top:
    the rasterizer's pixels (ndc = (p + 0.5) / size · 2 − 1, the y row of
    the projection negated, the camera looking along −z)."""
    dev = c2w.device
    ys = ((torch.arange(H, device=dev) + 0.5) / H * 2 - 1)
    xs = ((torch.arange(W, device=dev) + 0.5) / W * 2 - 1)
    ndc_y, ndc_x = torch.meshgrid(ys, xs, indexing="ij")
    d = torch.stack([(ndc_x + 2 * intr[0, 2] - 1) / (2 * intr[0, 0]),
                     (2 * intr[1, 2] - 1 - ndc_y) / (2 * intr[1, 1]),
                     -torch.ones_like(ndc_x)], -1).reshape(-1, 3)
    d = d @ c2w[:3, :3].T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return c2w[:3, 3].expand_as(d).contiguous(), d


def _rotation_error(torch, a, b) -> float:
    """Sum over views of ‖R_a − R_b‖_F."""
    return float(torch.linalg.norm(a[:, :3, :3] - b[:, :3, :3], dim=(1, 2)).sum())


def run_texture_tools(attn, torch, pipe, glb: str, device: str = "cuda",
                      tex_size: int = TOOLS_TEX, view: int = 512,
                      refine_steps: int = 200, pose_steps: int = 100,
                      rt_size: int = 512, ico: int = 5, frames: int = 8) -> None:
    """Phase 18: the texture tools of the port on the resident FLUX trees
    of ``pipe`` and the icosphere job's GLB ``glb``.  FastTexture inpaints
    a disc of about a quarter of the job's texture (halved to
    ``tex_size``²) at strength 1 in ``TOOLS_STEPS`` steps (B1 57 times a
    step, S = (tex_size / 16)² + 512) and upscales it x2 at strength 0.3
    of 28 steps (8 run, S = (tex_size / 8)² + 512); then texture and pose
    refinement, ray tracing against the rasterizer, visibility, the
    unified RGB / PBR renders, a two-object scene and the turntable
    export, each with no attention launch."""
    import numpy as np

    from unitex_torch.camera.generator import (
        generate_intrinsics, generate_orbit_views_c2ws,
    )
    from unitex_torch.geometry.io.mesh_io import load_mesh
    from unitex_torch.geometry.mesh import Mesh
    from unitex_torch.geometry.primitives import make_icosphere
    from unitex_torch.ops.raytrace import ray_triangle_intersect
    from unitex_torch.ops.visibility import self_rt, sphere_rt_views
    from unitex_torch.render.renderer import render_views
    from unitex_torch.render.scene import SceneObject, render_scene
    from unitex_torch.render.unify import unified_pbr_render, unified_rgb_render
    from unitex_torch.render.video import export_turntable
    from unitex_torch.texture.fast_texture import inpaint_texture, upscale_texture
    from unitex_torch.texture.refine import (
        PoseRefineConfig, TextureRefineConfig, refine_poses, refine_texture,
    )
    from unitex_torch.utils.resize import resize_bilinear

    dev = torch.device(device)
    cfg = pipe.flux_cfg
    blocks = cfg.num_layers + cfg.num_single_layers
    gen = torch.Generator(device=dev).manual_seed(18)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def launches_since(before):
        sync()
        return tuple(a - b for a, b in zip(_counts(attn), before))

    def put(x, dtype):
        return None if x is None else torch.from_numpy(
            np.ascontiguousarray(x, dtype)).to(dev)

    host = load_mesh(glb)
    mesh = Mesh(put(host.vertices, np.float32), put(host.faces, np.int64),
                uv=put(host.uv, np.float32), faces_uv=put(host.faces_uv, np.int64))
    atlas = put(host.texture[..., :3], np.float32) / 255.0
    texture = torch.clamp(resize_bilinear(atlas, tex_size, tex_size), 0.0, 1.0)

    # FastTexture, inpaint: a disc of a quarter of the texels, from noise
    yy, xx = torch.meshgrid(torch.arange(tex_size, device=dev),
                            torch.arange(tex_size, device=dev), indexing="ij")
    r = tex_size * math.sqrt(0.25 / math.pi)
    mask = ((yy - tex_size / 2 + 0.5) ** 2 + (xx - tex_size / 2 + 0.5) ** 2
            < r * r).float()
    tokens = (tex_size // (2 * pipe.vae_cfg.downscale)) ** 2 + TOOLS_TXT
    before = _counts(attn)
    t0 = time.perf_counter()
    out = inpaint_texture(pipe.transformer_params, cfg, pipe.vae_params,
                          pipe.vae_cfg, gen, texture, mask, strength=1.0,
                          num_inference_steps=TOOLS_STEPS, device=dev)
    n = launches_since(before)
    secs = time.perf_counter() - t0
    keep = mask == 0
    print(f"[tools] inpaint {tex_size}² (mask {float(mask.mean()):.4f} of the "
          f"texels, S = {tokens}): {secs:.3f}s, B1 launches {n[0]}", flush=True)
    if not _only(n, B1=blocks * TOOLS_STEPS):
        raise AssertionError(f"tools: inpaint launches {COUNTED} {n}, expected "
                             f"B1 {blocks * TOOLS_STEPS}")
    if tuple(out.shape) != (tex_size, tex_size, 3) or not bool(
            torch.isfinite(out).all()) or float(out.min()) < 0 or float(out.max()) > 1:
        raise AssertionError(f"tools: inpaint output {tuple(out.shape)} not a "
                             f"finite image in [0, 1]")
    if not torch.equal(out[keep], texture[keep]):
        raise AssertionError("tools: inpaint changed a kept texel")

    # FastTexture, upscale x2 at strength 0.3: t_start = 20 of 28
    t_start = UPSCALE_STEPS - int(round(UPSCALE_STEPS * UPSCALE_STRENGTH))
    runs = UPSCALE_STEPS - t_start
    tokens_up = (2 * tex_size // (2 * pipe.vae_cfg.downscale)) ** 2 + TOOLS_TXT
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = _counts(attn)
    t0 = time.perf_counter()
    up = upscale_texture(pipe.transformer_params, cfg, pipe.vae_params,
                         pipe.vae_cfg, gen, texture, scale=2,
                         strength=UPSCALE_STRENGTH,
                         num_inference_steps=UPSCALE_STEPS, device=dev)
    n = launches_since(before)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    print(f"[tools] upscale {tex_size}² -> {2 * tex_size}² (strength "
          f"{UPSCALE_STRENGTH}, {runs} of {UPSCALE_STEPS} steps, S = "
          f"{tokens_up}, VAE untiled): {secs:.3f}s, peak "
          f"{peak / 2**30:.2f} GiB, B1 launches {n[0]}", flush=True)
    if not _only(n, B1=blocks * runs):
        raise AssertionError(f"tools: upscale launches {COUNTED} {n}, expected "
                             f"B1 {blocks * runs}")
    if tuple(up.shape) != (2 * tex_size, 2 * tex_size, 3) or not bool(
            torch.isfinite(up).all()):
        raise AssertionError(f"tools: upscale output {tuple(up.shape)}")
    if peak > PEAK_LIMIT:
        raise AssertionError(f"tools: upscale peak {peak / 1e9:.1f} GB")
    del out, up
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    before = _counts(attn)
    intr = generate_intrinsics(49.1, 49.1, fov=True, degree=True, device=dev)
    # a ring at height 0: its rotations are orthonormal (above or below it
    # the generator's x axis is not unit, and the 6D pose parameters
    # would start off the camera they describe)
    c2ws = generate_orbit_views_c2ws(7, radius=2.8, height=0.0, device=dev)[:6]

    def render_targets(tex, poses):
        o = render_views(mesh, poses, intr, (view, view), perspective=True,
                         map_attr=tex, render_uv=True, render_map_attr=True)
        return o.map_attr * o.alpha + (1.0 - o.alpha)

    # texture refinement: the job's texture seen from 6 views, from grey
    targets = render_targets(atlas, c2ws)
    sync()
    t0 = time.perf_counter()
    tex, losses = refine_texture(
        mesh, c2ws, intr, targets, perspective=True,
        cfg=TextureRefineConfig(texture_size=view, steps=refine_steps))
    sync()
    secs = time.perf_counter() - t0
    first, last = float(losses[0]), float(losses[-1])
    print(f"[tools] refine_texture 6 x {view}² views, {view}² texture, "
          f"{refine_steps} steps: {secs / refine_steps * 1e3:.2f} ms a step, "
          f"loss {first:.5f} -> {last:.5f}", flush=True)
    if not (bool(torch.isfinite(losses).all()) and last < first
            and bool(torch.isfinite(tex).all())):
        raise AssertionError(f"tools: refine_texture loss {first} -> {last}")

    # pose refinement: a smooth texture, targets from the true poses, the
    # estimates turned by 0.05 rad about the vertical
    u = torch.linspace(0, 1, view, device=dev)
    gy, gx = torch.meshgrid(u, u, indexing="ij")
    smooth = torch.stack([0.5 + 0.4 * torch.sin(6 * gx), 0.5 + 0.4 * torch.cos(5 * gy),
                          0.5 + 0.4 * torch.sin(4 * (gx + gy))], -1)
    targets = render_targets(smooth, c2ws)
    a = 0.05
    turn = torch.tensor([[math.cos(a), -math.sin(a), 0.0],
                         [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]],
                        device=dev)
    start = c2ws.clone()
    start[:, :3, :3] = turn @ c2ws[:, :3, :3]
    sync()
    t0 = time.perf_counter()
    poses, losses = refine_poses(mesh, start, intr, targets, smooth,
                                 perspective=True,
                                 cfg=PoseRefineConfig(steps=pose_steps))
    sync()
    secs = time.perf_counter() - t0
    err0, err1 = _rotation_error(torch, start, c2ws), _rotation_error(torch, poses, c2ws)
    print(f"[tools] refine_poses 6 x {view}², {pose_steps} steps: "
          f"{secs / pose_steps * 1e3:.2f} ms a step, loss {float(losses[0]):.5f}"
          f" -> {float(losses[-1]):.5f}, rotation error {err0:.5f} -> "
          f"{err1:.5f}", flush=True)
    if not (bool(torch.isfinite(losses).all()) and err1 < err0):
        raise AssertionError(f"tools: refine_poses rotation error {err0} -> {err1}")

    # ray tracing against the rasterizer on the icosphere
    sphere = make_icosphere(ico)
    sv, sf = put(sphere.vertices, np.float32), put(sphere.faces, np.int64)
    cam = generate_orbit_views_c2ws(1, radius=2.8, height=0.0, device=dev)
    rays_o, rays_d = view_rays(torch, cam[0], intr, rt_size, rt_size)
    sync()
    t0 = time.perf_counter()
    hits = ray_triangle_intersect(rays_o, rays_d, sv, sf)
    sync()
    secs = time.perf_counter() - t0
    rast = render_views(Mesh(sv, sf), cam, intr, (rt_size, rt_size),
                        perspective=True)
    tri = rast.tri.reshape(-1)
    both = hits.hit & (tri >= 0)
    same = both & (hits.tri == tri)
    either = hits.hit | (tri >= 0)
    share = float(same.sum()) / max(float(both.sum()), 1.0)
    print(f"[tools] ray_triangle_intersect {rt_size}² rays x {sf.shape[0]} "
          f"faces: {secs:.3f}s; both hit {int(both.sum())} of "
          f"{int(either.sum())} pixels hit by either, the same triangle on "
          f"{share:.6f} of them ({int(both.sum() - same.sum())} differ)",
          flush=True)
    if share < 0.999 or float(both.sum()) < 0.99 * float(either.sum()):
        raise AssertionError(f"tools: ray tracing agrees with the rasterizer "
                             f"on {share} of the pixels both hit")

    # visibility: points inside the sphere see it all round, outside not
    d = torch.randn((2048, 3), generator=gen, device=dev)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    pts = torch.cat([d[:1024] * 0.5, d[1024:] * 1.5])
    sync()
    t0 = time.perf_counter()
    inner = self_rt(pts, sv, sf, n_rays=32, generator=gen)
    sync()
    t_self = time.perf_counter() - t0
    t0 = time.perf_counter()
    views = sphere_rt_views(sv, sf, n_cameras=6)
    sync()
    t_views = time.perf_counter() - t0
    print(f"[tools] self_rt 2048 points x 32 rays: {t_self:.3f}s, inner "
          f"{int(inner[:1024].sum())}/1024 inside, {int(inner[1024:].sum())}"
          f"/1024 outside; sphere_rt_views(6): {t_views:.4f}s, triangles "
          f"{views.tolist()}", flush=True)
    if not (bool(inner[:1024].all()) and not bool(inner[1024:].any())
            and bool((views >= 0).all())):
        raise AssertionError("tools: visibility")

    # the renders of the GLB, a two-object scene and the turntable export
    t0 = time.perf_counter()
    for cams in ("v1", "v2"):
        rgb = unified_rgb_render(glb, n_frames=frames, size=view, cameras=cams,
                                 device=dev)
        pbr = unified_pbr_render(glb, n_frames=frames, size=view, cameras=cams,
                                 device=dev)
        for k, x in [("rgb", rgb)] + [(f"pbr {k}", v) for k, v in pbr.items()]:
            if x.shape != (frames, view, view, 3) or x.dtype != np.uint8:
                raise AssertionError(f"tools: unified {cams} {k} {x.shape}")
    sync()
    t_unify = time.perf_counter() - t0
    move = torch.eye(4, device=dev)
    move[:3, :3] *= 0.4
    move[:3, 3] = torch.tensor([0.0, 0.0, 1.2], device=dev)
    ico3 = make_icosphere(3)
    objects = [SceneObject(mesh, texture=atlas),
               SceneObject(Mesh(put(ico3.vertices, np.float32),
                                put(ico3.faces, np.int64)), transform=move)]
    t0 = time.perf_counter()
    scene = render_scene(objects, c2ws[:4], intr, (view, view))
    sync()
    t_scene = time.perf_counter() - t0
    ids = set(torch.unique(scene["object_id"]).tolist())
    if not (bool(torch.isfinite(scene["rgb"]).all()) and {0, 1} <= ids):
        raise AssertionError(f"tools: scene object ids {ids}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        from PIL import Image

        t0 = time.perf_counter()
        grid = export_turntable(glb, os.path.join(tmp, "turntable.png"),
                                n_frames=frames, size=view, device=dev)
        t_grid = time.perf_counter() - t0
        t0 = time.perf_counter()
        sweep = export_turntable(glb, os.path.join(tmp, "sweep.gif"),
                                 n_frames=9, size=view, height_sweep=True,
                                 device=dev)
        t_sweep = time.perf_counter() - t0
        cols = int(math.ceil(math.sqrt(frames)))
        rows = int(math.ceil(frames / cols))
        with Image.open(grid) as im:
            grid_size = im.size
        with Image.open(sweep) as im:
            sweep_frames = im.n_frames
    print(f"[tools] renders: unified RGB + PBR, v1 and v2, {frames} x {view}² "
          f"each {t_unify:.3f}s; scene of 2 objects x 4 views {t_scene:.3f}s "
          f"(ids {sorted(ids)}); turntable grid {grid_size} {t_grid:.3f}s; "
          f"height sweep GIF of {sweep_frames} frames {t_sweep:.3f}s", flush=True)
    if grid_size != (cols * view, rows * view) or sweep_frames != 9:
        raise AssertionError(f"tools: turntable {grid_size}, {sweep_frames} frames")
    n = launches_since(before)
    if n != NONE:
        raise AssertionError(f"tools: launches {COUNTED} {n} outside FastTexture")



# phase 19: Redux and the field tools, on the serving phase's resident FLUX
# trees and the icosphere job's GLB, reference image and cache
SIGLIP_TOL = 1e-4    # the depth-2 tower, the card against the CPU, of max|ref|
SEARCH_N = 65536     # queries and references of the k = 16 search
SEARCH_CPU = 2048    # of them held against the CPU
FIELD_TOL = 1e-5     # volume queries and blurs, the card against the CPU, of max|ref|
DILATE_ITERS = 8     # uv_dilation passes held against the CPU
ORACLE_GAP_DB = 1.0  # the round trip against ORACLE_r05.json, else explained


def siglip_state_dict(params) -> dict:
    """The HF ``SiglipVisionModel`` state dict (``vision_model.*``) of a
    SigLIP tree, the inverse of ``models/siglip.convert_siglip_vision``:
    linear kernels -> ``.weight`` [d_out, d_in], the HWIO patch conv ->
    OIHW, stacked blocks -> one entry a layer (views of the tree)."""
    names = {"ln1": "layer_norm1", "q": "self_attn.q_proj",
             "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "out": "self_attn.out_proj", "ln2": "layer_norm2",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    pe = params["patch_embedding"]
    sd = {"vision_model.embeddings.patch_embedding.weight": pe["w"].permute(3, 2, 0, 1),
          "vision_model.embeddings.patch_embedding.bias": pe["b"],
          "vision_model.embeddings.position_embedding.weight":
              params["position_embedding"],
          "vision_model.post_layernorm.weight": params["post_layernorm"]["weight"],
          "vision_model.post_layernorm.bias": params["post_layernorm"]["bias"]}
    for path, leaf in _named_leaves(params["blocks"]):
        block, field = path.strip("/").split("/")
        if field == "kernel":
            leaf = leaf.transpose(-1, -2)
        for i in range(leaf.shape[0]):
            sd[f"vision_model.encoder.layers.{i}.{names[block]}."
               f"{'bias' if field == 'bias' else 'weight'}"] = leaf[i]
    return sd


def _rel(a, b) -> float:
    """max|a - b| over max|b| (b the reference)."""
    return float((a.float() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1e-30)


def _search_agrees(torch, d_dev, i_dev, d_ref, i_ref) -> float:
    """The share of (query, slot) pairs whose index matches the CPU's, a
    mismatch forgiven where the CPU's squared distance there is tied,
    within 1 ulp, with a neighbouring slot's or with the card's."""
    d2, r2 = d_dev.double() ** 2, d_ref.double() ** 2
    ulp = 2.0 ** -23 * torch.clamp(r2, min=1e-30)
    tied = (r2 - d2).abs() <= 2 * ulp
    near = torch.zeros_like(tied)
    near[:, 1:] |= (r2[:, 1:] - r2[:, :-1]).abs() <= 2 * ulp[:, 1:]
    near[:, :-1] |= (r2[:, 1:] - r2[:, :-1]).abs() <= 2 * ulp[:, :-1]
    ok = (i_dev == i_ref) | (tied & near)
    return float(ok.double().mean())


def run_redux_tools(attn, torch, pipe, keep: str, device: str = "cuda",
                    siglip_cfg=None, steps: int = STEPS,
                    search_n: int = SEARCH_N, search_cpu: int = SEARCH_CPU,
                    grid: int = 128, frame: int = 512, oracle=()) -> None:
    """Phase 19: the Redux image prompt and the field, search and viewer
    tools on the resident FLUX trees of ``pipe`` and the icosphere job's
    files in ``keep`` (``icosphere.glb``, ``icosphere.png``, its
    ``icosphere_cache/``).  SigLIP (``siglip_cfg``, so400m by default)
    from a seeded tree: its forward on the job's reference image (729
    tokens of 1152, finite, no attention kernel), its depth-2 copy on the
    card against the CPU; the tree and a seeded Redux projection written
    under HF names to ``<tmp>/siglip`` and ``<tmp>/flux/redux`` and read
    back by ``ReduxConditioner`` on the card (leaf for leaf, the port's
    own tower); then the Redux job: the texture pass of ``pipe`` (its
    adapters merged as the pipeline merges them) on the job's control
    strip and dual image with the Redux tokens as ``prompt_embeds``,
    ``steps`` steps, exactly 57 launches of B1 a step, each at the job's S
    (``REDUX_S`` at full size), a finite strip in [0, 1].  Then on the
    card, each against the CPU: ``knn`` (k = 16) and ``query_ball`` (cap
    32) over ``search_n`` points (``search_cpu`` queries on the CPU),
    ``grid_sample_3d``, ``triplane_query``, ``splat_points_to_grid`` (R =
    ``grid``), ``uv_dilation`` (``DILATE_ITERS`` passes; until full on the
    card alone) and ``disk_blur`` on the job's texture, the isosurface of
    a field evaluated on the card at ``grid``³ exported to a GLB and read
    back, ``get_visible_faces`` on the six condition views; the viewer
    over local HTTP (a ``frame``² PNG of each mode, 400 for a bad mode);
    ``roundtrip_oracle`` (``oracle``: its arguments, the defaults at full
    size) beside ORACLE_r05.json's sphere, ``compare_golden`` of the job's
    cache against itself, ``check_meshes`` and ``merge_reports`` over the
    phase's GLBs.  No attention launch outside the Redux job."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    from PIL import Image
    from safetensors.torch import save_file

    from unitex_torch.geometry.io.mesh_io import load_mesh
    from unitex_torch.geometry.mesh import Mesh
    from unitex_torch.models.flux.lora import merge_lora
    from unitex_torch.models.flux.pipeline import FluxPipelineConfig, run_flux_pipeline
    from unitex_torch.models.flux.redux import ReduxConditioner, init_redux_params
    from unitex_torch.models.siglip import (
        SiglipVisionConfig, init_siglip_params, preprocess_siglip, siglip_forward,
    )
    from unitex_torch.ops.image_ops import disk_blur, uv_dilation
    from unitex_torch.ops.knn import knn, query_ball
    from unitex_torch.render.conditioning import condition_cameras, grid_to_strip
    from unitex_torch.render.field_vis import create_grid, export_isosurface
    from unitex_torch.render.renderer import get_visible_faces, get_visible_vertices
    from unitex_torch.render.renderer_inverse import uv_render
    from unitex_torch.render.viewer import MODES, serve
    from unitex_torch.render.volume import (
        grid_sample_3d, splat_points_to_grid, triplane_query,
    )
    from unitex_torch.scripts import (
        check_meshes, compare_golden, merge_reports, roundtrip_oracle,
    )
    from unitex_torch.utils.image_io import load_image
    from unitex_torch.utils.params import tree_to

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = siglip_cfg or SiglipVisionConfig.so400m_384()
    gen = torch.Generator(device=dev).manual_seed(19)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak():
        return torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0

    def launches_since(before):
        sync()
        return tuple(a - b for a, b in zip(_counts(attn), before))

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    glb = os.path.join(keep, "icosphere.glb")
    cache = os.path.join(keep, "icosphere_cache")
    image = Image.open(os.path.join(keep, "icosphere.png")).convert("RGB")
    before = _counts(attn)

    # SigLIP at full width from the seeded tree
    tree = init_siglip_params(gen, cfg, device=dev)
    n_params = sum(t.numel() for _, t in _named_leaves(tree))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    feats, secs = timed(lambda: siglip_forward(tree, cfg,
                                               preprocess_siglip(image, cfg, dev)))
    n = launches_since(before)
    print(f"[redux] siglip {n_params} parameters ({cfg.num_layers} layers of "
          f"{cfg.num_heads} heads of {cfg.hidden_size // cfg.num_heads}, "
          f"{cfg.image_size}² input): forward {secs:.3f}s, peak {peak():.2f} "
          f"GiB, output {tuple(feats.shape)}, launches {COUNTED} {n}", flush=True)
    if tuple(feats.shape) != (1, cfg.num_patches, cfg.hidden_size) or not bool(
            torch.isfinite(feats).all()) or n != NONE:
        raise AssertionError(f"redux: siglip output {tuple(feats.shape)}, launches {n}")
    shallow = dataclasses.replace(cfg, num_layers=2)
    two = _depth(tree, 2)
    px = preprocess_siglip(image, shallow, dev)
    on_dev = siglip_forward(two, shallow, px)
    on_cpu = siglip_forward(tree_to(two, "cpu"), shallow, px.cpu())
    err = _rel(on_dev.cpu(), on_cpu)
    print(f"[redux] siglip depth 2, {device} against the CPU: max|d| / max|ref| "
          f"{err:.3e} (tol {SIGLIP_TOL})", flush=True)
    if not err <= SIGLIP_TOL:
        raise AssertionError(f"redux: siglip depth 2 off the CPU by {err}")
    del on_dev, on_cpu, two

    # the checkpoint chain: HF names on disk, read back by the conditioner
    fcfg = pipe.flux_cfg
    proj = init_redux_params(gen, cfg.hidden_size, fcfg.joint_attention_dim,
                             device=dev)
    root = tempfile.mkdtemp(prefix="chip_smoke_redux_")
    try:
        t0 = time.perf_counter()
        os.makedirs(os.path.join(root, "siglip"))
        os.makedirs(os.path.join(root, "flux", "redux"))
        save_file({k: v.contiguous().cpu() for k, v in siglip_state_dict(tree).items()},
                  os.path.join(root, "siglip", "model.safetensors"))
        with open(os.path.join(root, "siglip", "config.json"), "w") as f:
            json.dump({"num_attention_heads": cfg.num_heads,
                       "hidden_act": cfg.hidden_act,
                       "layer_norm_eps": cfg.layer_norm_eps}, f)
        save_file({f"redux_{k}.{'weight' if leaf == 'kernel' else 'bias'}":
                   (v.t() if leaf == "kernel" else v).contiguous().cpu()
                   for k in ("up", "down") for leaf, v in proj[k].items()},
                  os.path.join(root, "flux", "redux", "model.safetensors"))
        t_write = time.perf_counter() - t0
        cond, t_load = timed(lambda: ReduxConditioner(pretrain_root=root, device=dev))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    pairs = [(tree, cond.tower[0] if cond.tower else None), (proj, cond.params)]
    same = all(b is not None and len(list(_named_leaves(a))) == len(list(_named_leaves(b)))
               and all(torch.equal(x, y) for (_, x), (_, y) in
                       zip(_named_leaves(a), _named_leaves(b))) for a, b in pairs)
    # the shapes give the input side as 27 patches of 14 (378), as in the
    # JAX package; the rest of the config is the tree's
    read = cond.tower[1] if cond.tower else None
    print(f"[redux] checkpoint: wrote <tmp>/siglip and <tmp>/flux/redux in "
          f"{t_write:.2f}s, ReduxConditioner read them in {t_load:.2f}s: backend "
          f"{cond.backend}, heads {read.num_heads if read else None}, input side "
          f"{read.image_size if read else None}, both trees leaf for leaf equal "
          f"{same}", flush=True)
    if cond.backend != "port" or not same or dataclasses.replace(
            read, image_size=cfg.image_size) != cfg or read.num_patches != cfg.num_patches:
        raise AssertionError(f"redux: conditioner backend {cond.backend}, config "
                             f"{read}, trees equal {same}")
    del tree, proj, feats

    # the Redux job: the texture pass with the Redux tokens as the prompt
    embeds, ids = cond(image)
    del cond
    dcfg = pipe.config.diffusion
    pipe_cfg = FluxPipelineConfig(
        height=dcfg.height, width=dcfg.width, num_inference_steps=steps,
        guidance_scale=dcfg.guidance_scale,
        max_sequence_length=dcfg.max_sequence_length)
    grid_img = 0.5 * load_image(os.path.join(cache, "mv_normal.png")) \
        + 0.5 * load_image(os.path.join(cache, "mv_ccm.png"))
    control = grid_to_strip(torch.from_numpy(grid_img).to(dev))
    dual = torch.from_numpy(load_image(os.path.join(cache, "processed_image.png"))).to(dev)
    vs = pipe.vae_cfg.downscale
    tokens = 2 * (dcfg.height // (2 * vs)) * (dcfg.width // (2 * vs)) \
        + (dual.shape[0] // (2 * vs)) * (dual.shape[1] // (2 * vs)) + embeds.shape[1]
    blocks = fcfg.num_layers + fcfg.num_single_layers
    seen = []
    launch = attn.flash_attention

    def recorded(q, k, v):
        seen.append(tuple(q.shape))
        return launch(q, k, v)

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    params = merge_lora(pipe.transformer_params,
                        [(pipe.texture_lora, 1.0), (pipe.delight_lora, 0.0)])
    before = _counts(attn)
    attn.flash_attention = recorded
    try:
        strip, secs = timed(lambda: run_flux_pipeline(
            params, fcfg, pipe.vae_params, pipe.vae_cfg, gen, pipe_cfg,
            control_image=control, dual_image=dual, prompt_embeds=embeds,
            device=dev))
    finally:
        attn.flash_attention = launch
    del params
    n = launches_since(before)
    lengths = sorted({shape[1] for shape in seen})
    print(f"[redux] job: prompt_embeds {tuple(embeds.shape)} (txt_ids "
          f"{tuple(ids.shape)}), {steps} steps, S = {tokens}: {secs:.3f}s, peak "
          f"{peak():.2f} GiB, B1 launches {n[0]} at S {lengths}", flush=True)
    want = blocks * steps if cuda else 0
    if not _only(n, B1=want) or len(seen) != want or (cuda and lengths != [tokens]):
        raise AssertionError(f"redux: launches {COUNTED} {n} at S {lengths}, "
                             f"expected B1 {want} at S = {tokens}")
    if cuda and siglip_cfg is None and tokens != REDUX_S:
        raise AssertionError(f"redux: S = {tokens}, expected {REDUX_S}")
    if tuple(strip.shape) != (dcfg.height, dcfg.width, 3) or not bool(
            torch.isfinite(strip).all()) or float(strip.min()) < 0 or float(strip.max()) > 1:
        raise AssertionError(f"redux: strip {tuple(strip.shape)} not finite in [0, 1]")
    del strip, embeds, control, dual
    if cuda:
        torch.cuda.empty_cache()

    before = _counts(attn)
    # search: k = 16 and balls of cap 32 over search_n points
    pts = torch.randn((2, search_n, 3), generator=gen, device=dev)
    q, ref = pts[0], pts[1]
    (d_dev, i_dev), t_knn = timed(lambda: knn(q, ref, k=16, chunk=16384))
    d_cpu, i_cpu = knn(q[:search_cpu].cpu(), ref.cpu(), k=16)
    agree = _search_agrees(torch, d_dev[:search_cpu].cpu(), i_dev[:search_cpu].cpu(),
                           d_cpu, i_cpu)
    radius = 0.1
    (b_idx, b_mask, b_cnt), t_ball = timed(
        lambda: query_ball(q, ref, radius, cap=32, chunk=16384))
    c_idx, c_mask, c_cnt = query_ball(q[:search_cpu].cpu(), ref.cpu(), radius, cap=32)
    counts_equal = float((b_cnt[:search_cpu].cpu() == c_cnt).double().mean())
    print(f"[search] knn k=16 {search_n} x {search_n}: {t_knn:.3f}s, {search_cpu} "
          f"queries against the CPU: indices agree (ties of 1 ulp forgiven) on "
          f"{agree:.6f}; query_ball cap 32, r {radius}: {t_ball:.3f}s, in-radius "
          f"counts {int(b_cnt.min())}-{int(b_cnt.max())} (mean "
          f"{float(b_cnt.float().mean()):.2f}), {counts_equal:.6f} of them the "
          f"CPU's", flush=True)
    if not (agree == 1.0 and bool(torch.isfinite(d_dev).all())
            and counts_equal >= 0.999 and int(b_mask.sum(1).max()) <= 32):
        raise AssertionError(f"search: knn agreement {agree}, counts {counts_equal}")
    del pts, q, ref, d_dev, i_dev, b_idx, b_mask, b_cnt

    # volume queries and the splat, against the CPU
    vol = torch.randn((grid // 2, grid // 2, grid // 2, 4), generator=gen, device=dev)
    planes = torch.randn((3, grid, grid, 8), generator=gen, device=dev)
    coords = torch.rand((1 << 20, 3), generator=gen, device=dev) * 2.2 - 1.1
    vals = torch.randn((1 << 20, 3), generator=gen, device=dev)
    checks = {}
    for name, fn, args in (
            ("grid_sample_3d", grid_sample_3d, (vol, coords)),
            ("grid_sample_3d aligned", lambda v, c: grid_sample_3d(v, c, True),
             (vol, coords)),
            ("triplane_query", triplane_query, (planes, coords)),
            ("splat_points_to_grid", lambda c, v: splat_points_to_grid(c, v, grid),
             (coords, vals))):
        out, secs = timed(lambda: fn(*args))
        ref_out = fn(*(a.cpu() for a in args))
        checks[name] = (_rel(out.cpu(), ref_out), secs)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"volume: {name} not finite")
    print("[volume] " + ", ".join(f"{k} {e:.2e} of max|ref| ({s * 1e3:.2f} ms)"
                                  for k, (e, s) in checks.items())
          + f" (tol {FIELD_TOL}; 2^20 points, R = {grid})", flush=True)
    if not all(e <= FIELD_TOL for e, _ in checks.values()):
        raise AssertionError(f"volume: {checks}")
    del vol, planes, coords, vals

    # a field on the card, browsed as an isosurface GLB
    work = tempfile.mkdtemp(prefix="chip_smoke_fields_")
    try:
        def ellipsoid(x, y, z):
            return 0.5 - (x * x + 1.3 * y * y + z * z) + 0.1 * x * y * z

        iso_glb = os.path.join(work, "isosurface.glb")
        _, t_iso = timed(lambda: export_isosurface(ellipsoid, iso_glb,
                                                   resolution=grid, device=dev))
        back = load_mesh(iso_glb)
        print(f"[fields] isosurface of a field on {device} at {grid}³: "
              f"{back.vertices.shape[0]} vertices, {back.faces.shape[0]} faces, "
              f"{t_iso:.3f}s to the GLB, read back by load_mesh", flush=True)
        values = create_grid(ellipsoid, 8, 8, 8, device=dev)
        if back.faces.shape[0] < 1000 or not np.isfinite(back.vertices).all() \
                or values.dtype != np.float32:
            raise AssertionError(f"fields: isosurface {back.faces.shape}")

        # the job's texture: dilation and blur, against the CPU
        host = load_mesh(glb)

        def put(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(dev)

        mesh = Mesh(put(host.vertices, np.float32), put(host.faces, np.int64),
                    uv=put(host.uv, np.float32), faces_uv=put(host.faces_uv, np.int64))
        tex = put(host.texture[..., :3], np.float32) / 255.0
        mask = uv_render(mesh, tex.shape[0])["mask"]
        part, t_part = timed(lambda: uv_dilation(tex, mask, max_iters=DILATE_ITERS))
        full, t_full = timed(lambda: uv_dilation(tex, mask))
        blur, t_blur = timed(lambda: disk_blur(tex, 4))
        e_part = _rel(part.cpu(), uv_dilation(tex.cpu(), mask.cpu(),
                                              max_iters=DILATE_ITERS))
        e_blur = _rel(blur.cpu(), disk_blur(tex.cpu(), 4))
        print(f"[fields] texture {tuple(tex.shape)} ({float(mask.float().mean()):.4f}"
              f" charted): uv_dilation {DILATE_ITERS} passes {t_part * 1e3:.2f} ms "
              f"({e_part:.2e} of max|ref| off the CPU), until full {t_full:.3f}s; "
              f"disk_blur r 4 {t_blur * 1e3:.2f} ms ({e_blur:.2e}); tol "
              f"{FIELD_TOL}", flush=True)
        if not (e_part <= FIELD_TOL and e_blur <= FIELD_TOL
                and bool(torch.isfinite(full).all()) and float(full.min()) >= 0
                and float(full.max()) <= 1):
            raise AssertionError(f"fields: dilation {e_part}, blur {e_blur}")
        del tex, mask, part, full, blur

        cam = pipe.config.camera
        c2ws, intr = condition_cameras(cam.radius, cam.ortho_scale, device=dev)
        cam_size = (cam.view_size, cam.view_size)
        # the views see the mesh as the job rendered it
        scaled = Mesh(mesh.vertices * pipe.config.mesh.scale_to, mesh.faces)
        fvis, t_vis = timed(lambda: get_visible_faces(
            scaled, c2ws, intr, cam_size, perspective=cam.perspective))
        vvis = get_visible_vertices(scaled, c2ws, intr, cam_size,
                                    perspective=cam.perspective)
        per_view = fvis.float().mean(1).tolist()
        union = float(fvis.any(0).float().mean())
        print(f"[fields] get_visible_faces, 6 condition views of {cam_size[0]}²: "
              f"{t_vis:.3f}s, faces seen per view "
              f"{[round(v, 4) for v in per_view]}, by any {union:.4f}; vertices "
              f"by any {float(vvis.any(0).float().mean()):.4f}", flush=True)
        if min(per_view) < 0.05 or union < 0.9:
            raise AssertionError(f"fields: visible faces {per_view}, {union}")

        # the viewer over local HTTP, on the card
        httpd = serve(glb, port=0, poll=0.1, device=dev)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=120) as r:
                return r.status, r.read()

        try:
            get(f"/render?mode=rgb&size={frame}")     # first use
            times, frames = {}, {}
            for mode in MODES:
                t0 = time.perf_counter()
                status, body = get(f"/render?mode={mode}&az=30&el=20&size={frame}")
                times[mode] = (time.perf_counter() - t0) * 1e3
                frames[mode] = np.asarray(Image.open(io.BytesIO(body)))
                if status != 200 or frames[mode].shape != (frame, frame, 3):
                    raise AssertionError(f"viewer: {mode} {status} "
                                         f"{frames[mode].shape}")
            try:
                get("/render?mode=depth")
                bad = 200
            except urllib.error.HTTPError as e:
                bad = e.code
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        print(f"[viewer] {frame}² PNG frames over HTTP on {device}: " + ", ".join(
            f"{m} {t:.1f} ms" for m, t in times.items())
              + f"; a bad mode answers {bad}", flush=True)
        if not (frames["rgb"] != 255).any() or bad != 400:
            raise AssertionError(f"viewer: rgb frame blank or bad mode {bad}")

        # the scripts: the round trip, the golden report, the mesh tools
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            t0 = time.perf_counter()
            report = roundtrip_oracle.main([*oracle, "--device", device])
            t_rt = time.perf_counter() - t0
        rec = oracle_record("sphere", "priority_k1")
        gaps = {k: report[k] - rec[k] for k in ("texture_psnr_visible",
                                                "rerender_psnr")}
        print(f"[scripts] roundtrip_oracle {' '.join(oracle) or '(defaults)'}: "
              f"{report['faces']} faces, texture_psnr_visible "
              f"{report['texture_psnr_visible']} (JAX {rec['texture_psnr_visible']},"
              f" {gaps['texture_psnr_visible']:+.2f}), rerender_psnr "
              f"{report['rerender_psnr']} (JAX {rec['rerender_psnr']}, "
              f"{gaps['rerender_psnr']:+.2f}) in {t_rt:.2f}s", flush=True)
        if not all(math.isfinite(report[k]) for k in gaps):
            raise AssertionError(f"scripts: roundtrip report {report}")
        if not oracle and max(abs(g) for g in gaps.values()) > ORACLE_GAP_DB:
            print(f"[scripts] roundtrip_oracle: a gap above {ORACLE_GAP_DB} dB "
                  f"to the JAX record (see PERF.md)", flush=True)
        with contextlib.redirect_stdout(io.StringIO()):
            golden = compare_golden.main([cache, cache, "--device", device])
        scored = {k: v for k, v in golden["artifacts"].items() if v}
        print(f"[scripts] compare_golden of the job's cache against itself: "
              f"{len(scored)} artifacts, worst PSNR {golden['worst_psnr']} dB (the"
              f" cap), SSIM {sorted({v['ssim'] for v in scored.values()})}",
              flush=True)
        if not scored or golden["worst_psnr"] != 120.0 or any(
                v["ssim"] not in (1.0, None) for v in scored.values()):
            raise AssertionError(f"scripts: compare_golden {golden}")
        shutil.copy(glb, os.path.join(work, "icosphere.glb"))
        with contextlib.redirect_stdout(io.StringIO()):
            check_meshes.main([os.path.join(work, "*.glb"), "--out",
                               os.path.join(work, "meshes.csv")])
        with open(os.path.join(work, "meshes.csv")) as f:
            rows = list(csv.DictReader(f))
        for name in ("icosphere", "isosurface"):
            with open(os.path.join(work, f"{name}.json"), "w") as f:
                json.dump({name: {"status": "ok", "seconds": t_iso}}, f)
        with contextlib.redirect_stdout(io.StringIO()):
            merge_reports.main([os.path.join(work, "*.json"), "--mesh-root", work,
                                "--out", os.path.join(work, "merged"),
                                "--fail-key", "status"])
        with open(os.path.join(work, "merged.json")) as f:
            merged = json.load(f)
        print(f"[scripts] check_meshes: {[(r['path'].rsplit('/', 1)[-1], r['V'], r['F']) for r in rows]};"
              f" merge_reports: {sorted((k, v['faces']) for k, v in merged.items())}",
              flush=True)
        faces = {os.path.basename(r["path"]): int(r["F"]) for r in rows}
        if faces != {"icosphere.glb": int(host.faces.shape[0]),
                     "isosurface.glb": int(back.faces.shape[0])} or {
                k: v["faces"] for k, v in merged.items()} != {
                "icosphere": faces["icosphere.glb"],
                "isosurface": faces["isosurface.glb"]}:
            raise AssertionError(f"scripts: meshes {rows}, merged {merged}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n = launches_since(before)
    if n != NONE:
        raise AssertionError(f"redux: launches {COUNTED} {n} outside the Redux job")


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

    b1_record, b1_ms, b1_redux = check_flash_attention(
        attn, torch, usage["flash_fwd_kernel<128>"])
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
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    records += check_flash_backward_d64(attn, torch, usage)
    time_w8a8(torch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # phase 12: the learned matting models on the card
    _reset(attn)
    run_matting(torch)
    torch.cuda.synchronize()
    matting = _counts(attn)
    if matting != NONE:
        return fail(f"launches {COUNTED} {matting} in the matting models")

    tools_dir = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    _reset(attn)
    launches, pipe = run_main_path(attn, torch, keep_dir=tools_dir)
    torch.cuda.synchronize()
    serve = _counts(attn)
    if launches != serve[0] or not _only(serve, B1=-1):
        return fail(f"launches {COUNTED} {serve} on the serving path")
    torch.cuda.empty_cache()

    # phase 13: the job server over HTTP on the resident phase-4 pipeline
    _reset(attn)
    run_serving(attn, torch, pipe)
    torch.cuda.synchronize()
    http = _counts(attn)
    if not _only(http, B1=-1):
        return fail(f"launches {COUNTED} {http} on the job server")
    torch.cuda.empty_cache()

    # phase 18: the texture tools on the resident FLUX trees and the
    # icosphere job's GLB
    _reset(attn)
    t0 = time.perf_counter()
    try:
        run_texture_tools(attn, torch, pipe,
                          os.path.join(tools_dir, "icosphere.glb"))
        torch.cuda.synchronize()
        tools = _counts(attn)
        print(f"[tools] phase 18 {time.perf_counter() - t0:.1f}s", flush=True)
        if not _only(tools, B1=-1):
            return fail(f"launches {COUNTED} {tools} in the texture tools")
        gc.collect()
        torch.cuda.empty_cache()

        # phase 19: the Redux image prompt and the field, search and
        # viewer tools on the same trees and job
        _reset(attn)
        t0 = time.perf_counter()
        run_redux_tools(attn, torch, pipe, tools_dir)
        torch.cuda.synchronize()
        redux = _counts(attn)
        print(f"[redux] phase 19 {time.perf_counter() - t0:.1f}s", flush=True)
        if not _only(redux, B1=57 * STEPS):
            return fail(f"launches {COUNTED} {redux} in phase 19")
    finally:
        shutil.rmtree(tools_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    _reset(attn)
    run_training(attn, torch, pipe)
    torch.cuda.synchronize()
    train = _counts(attn)
    if not _only(train, B1=-1, B2a=-1, B2b=-1):
        return fail(f"launches {COUNTED} {train} on the training path")
    print(f"[train] launches B1/B2a/B2b {train[0]}/{train[1]}/{train[2]} in "
          f"{TRAIN_STEPS} steps", flush=True)
    torch.cuda.empty_cache()

    # phase 9 runs here, while the serving phase's FLUX trees are resident
    _reset(attn)
    run_ltm_path(attn, torch, pipe)
    torch.cuda.synchronize()
    ltm = _counts(attn)
    if not _only(ltm, B1=-1):
        return fail(f"launches {COUNTED} {ltm} on the LTM path")
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
        # RMBG-2.0 weights for the CLI: its pipeline mattes with BiRefNet
        write_matting_checkpoint(models, "birefnet",
                                 matting_model(torch, "birefnet")[1])
        if _counts(attn) != NONE:
            return fail(f"launches {_counts(attn)} while writing the checkpoint")

        _reset(attn)
        run_cli(attn, torch, models)
        torch.cuda.synchronize()
        cli = _counts(attn)
        if not _only(cli, B1=-1, B1_d64=-1):
            return fail(f"launches {COUNTED} {cli} on the CLI path")
        gc.collect()
        torch.cuda.empty_cache()

        # phase 15: the FLUX launcher's Prodigy, preconditioning loss and
        # --pretrain-models, from the same checkpoint
        _reset(attn)
        run_flux_launcher(attn, torch, models)
        torch.cuda.synchronize()
        flux_launcher = _counts(attn)
        if not _only(flux_launcher, B1=-1, B2a=-1, B2b=-1):
            return fail(f"launches {COUNTED} {flux_launcher} on the FLUX "
                        f"launcher")
        gc.collect()
        torch.cuda.empty_cache()

        # RMBG-1.4 weights beside them: the int8 pipeline mattes with ISNet
        write_matting_checkpoint(models, "isnet",
                                 matting_model(torch, "isnet")[1])
        _reset(attn)
        run_int8_path(attn, torch, models)
        torch.cuda.synchronize()
        int8 = _counts(attn)
        if not _only(int8, B3=-1):
            return fail(f"launches {COUNTED} {int8} on the int8 serving path")
        gc.collect()
        torch.cuda.empty_cache()

        _reset(attn)
        run_sr_options(attn, torch, models)
        torch.cuda.synchronize()
        sr_options = _counts(attn)
        if not _only(sr_options, B1_d64=-1):
            return fail(f"launches {COUNTED} {sr_options} on the SR options")
        gc.collect()
        torch.cuda.empty_cache()

        # phase 14: the TSD-SR trainer from the SD3 checkpoint
        _reset(attn)
        run_tsdsr_training(attn, torch, models)
        torch.cuda.synchronize()
        tsdsr = _counts(attn)
        if not _only(tsdsr, B1_d64=-1, B2a_d64=-1, B2b_d64=-1):
            return fail(f"launches {COUNTED} {tsdsr} on the TSD-SR trainer")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    _reset(attn)
    run_oracle(torch)
    torch.cuda.synchronize()
    oracle = _counts(attn)
    if oracle != NONE:
        return fail(f"launches {COUNTED} {oracle} on the oracle bakes")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 16: the LTM trainer at full width, with a profiled step
    _reset(attn)
    run_ltm_training(torch)
    torch.cuda.synchronize()
    if _counts(attn) != NONE:
        return fail(f"launches {COUNTED} {_counts(attn)} in the LTM trainer")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 17: CLIP-L and T5-XXL on the card
    _reset(attn)
    run_text(torch)
    torch.cuda.synchronize()
    if _counts(attn) != NONE:
        return fail(f"launches {COUNTED} {_counts(attn)} in the text encoders")

    paths = ("matting", "serve", "http_serve", "texture_tools", "redux",
             "train", "ltm", "cli", "flux_launcher", "int8_serve", "sr_options",
             "tsdsr_train", "oracle")
    for rec, *n in zip(records, matting, serve, http, tools, redux, train, ltm,
                       cli, flux_launcher, int8, sr_options, tsdsr, oracle):
        rec["launches"] = sum(n)
        rec["launches_by_path"] = dict(zip(paths, n))
    # B1 at the Redux job's S: its launches are the Redux job's, all at
    # that S (phase 19 checks each launch's length)
    b1_redux["launches"] = redux[0]
    b1_redux["launches_by_path"] = {"redux": redux[0]}
    records.append(b1_redux)
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
