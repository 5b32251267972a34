"""FLUX LoRA training launcher, single GPU (port of the LoRA subset of
scripts/train_flux_lora.py).

    python -m unitex_torch.scripts.train_flux_lora --tiny --device cpu
    python -m unitex_torch.scripts.train_flux_lora --output-dir lora_out

Flow-match LoRA training of the texture/delight adapters with
checkpointing, LR schedules, AdamW or Prodigy, the optional
preconditioning pixel loss (``--preconditioning-loss``, weighted by
``--preconditioning-loss-weight``) and JSONL logging, on the synthetic
geometry-rendered stream or a pre-rendered dataset directory.  The full
model is FLUX.1-dev with ``remat=True``, read from
``<--pretrain-models>/flux/{transformer,vae}`` (diffusers safetensors)
or, without that flag, random trees made on the device from ``--seed``.
With ``--pretrain-models`` the trigger prompt ``--prompt`` is embedded
once by CLIP-L and T5-XXL on the device (``models/text_encoders``); with
no text-encoder weights (or tokenizers), an empty prompt, or embeddings
whose widths the model does not take, the prompt embeddings are zeros,
as in the JAX launcher.

Not ported, and refused with a message: ``--pipe`` and ``--data-mesh`` >
1 (multi-GPU), ``--full-finetune`` and ``--bf16-compute``.  The option
that only the pipeline-parallel branch reads (``--pipe-n-micro``) is not
taken.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def build_batch(
    examples: List[Dict[str, np.ndarray]],
    vae_params,
    vae_cfg,
    prompt_embeds: torch.Tensor,
    pooled_embeds: torch.Tensor,
    grad_accum: int = 1,
    pixel_values: bool = False,
) -> Dict[str, torch.Tensor]:
    """One step's batch from dataset examples, on the device of
    ``prompt_embeds`` ([S_t, D] and [D_p], broadcast over the batch):
    VAE-encode target and control, pack the control tokens with ids offset
    past the noise grid (and the dual stream's, when every example has
    one), as inference lays them out; ``pixel_values`` adds the target
    images (the preconditioning loss's).  With ``grad_accum`` > 1 every
    leaf gets a leading microbatch axis [A, B, ...]."""
    from ..models.flux.pipeline import latent_image_ids, pack_latents
    from ..models.flux.vae import vae_encode

    dev = prompt_embeds.device

    def images(key):
        return torch.as_tensor(np.stack([e[key] for e in examples]),
                               dtype=torch.float32, device=dev)

    def encode(key):
        return vae_encode(vae_params, vae_cfg, images(key) * 2.0 - 1.0)

    latents = encode("target")
    ctrl_lat = encode("control")
    HL, WL = latents.shape[1], latents.shape[2]
    CH, CW = ctrl_lat.shape[1], ctrl_lat.shape[2]
    cond_tokens = pack_latents(ctrl_lat)
    # ids from the control latent's own dims, offset past the noise grid
    cond_ids = latent_image_ids(CH // 2, CW // 2, offset_y=HL // 2, device=dev)
    if all("dual" in e for e in examples):
        # reference-image tokens, offset like inference's dual stream
        dual_lat = encode("dual")
        DH, DW = dual_lat.shape[1], dual_lat.shape[2]
        cond_tokens = torch.cat([cond_tokens, pack_latents(dual_lat)], dim=1)
        cond_ids = torch.cat([
            cond_ids,
            latent_image_ids(DH // 2, DW // 2, offset_x=WL // 2,
                             offset_y=HL // 2, device=dev),
        ], dim=0)
    elif any("dual" in e for e in examples):
        # conditioning must have one shape per step: drop the dual stream
        print("warning: batch mixes samples with/without the dual "
              "reference image; dual tokens dropped this step")
    n = latents.shape[0]
    batch = {
        "latents": latents,
        "cond_tokens": cond_tokens,
        "cond_ids": cond_ids,
        "prompt_embeds": prompt_embeds.expand(n, *prompt_embeds.shape),
        "pooled_embeds": pooled_embeds.expand(n, *pooled_embeds.shape),
    }
    if pixel_values:
        batch["pixel_values"] = images("target")
    if grad_accum > 1:
        # [A*B, ...] -> [A, B, ...]; cond_ids is per-sequence and broadcasts
        batch = {
            k: (v.expand(grad_accum, *v.shape) if k == "cond_ids" else
                v.reshape(grad_accum, n // grad_accum, *v.shape[1:]))
            for k, v in batch.items()
        }
    return batch


def _refuse_deferred(args) -> None:
    deferred = {
        "--pipe (pipeline parallelism)": bool(args.pipe),
        "--data-mesh > 1 (data parallelism)": args.data_mesh > 1,
        "--full-finetune": args.full_finetune,
        "--bf16-compute": args.bf16_compute,
    }
    on = [k for k, v in deferred.items() if v]
    if on:
        raise NotImplementedError(f"not ported: {', '.join(on)}")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pretrain-models", default=None)
    ap.add_argument("--output-dir", default="lora_out")
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--learning-rate", type=float, default=1e-4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "prodigy"])
    ap.add_argument("--lr-scheduler", default="constant_with_warmup")
    ap.add_argument("--warmup-steps", type=int, default=100)
    ap.add_argument("--max-train-steps", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--drop-rate", type=float, default=0.0)
    ap.add_argument("--preconditioning-loss", action="store_true",
                    help="add a pixel-space MSE on the VAE-decoded x0 "
                         "prediction")
    ap.add_argument("--preconditioning-loss-weight", type=float, default=1.0)
    ap.add_argument("--prior-preservation", action="store_true",
                    help="batch halves are [instance; prior] (needs an even "
                         "--batch-size)")
    ap.add_argument("--prior-loss-weight", type=float, default=1.0)
    ap.add_argument("--checkpoint-every", type=int, default=250)
    ap.add_argument("--checkpoints-total-limit", type=int, default=3)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--pipe", type=int, default=0)
    ap.add_argument("--data-dir", default=None,
                    help="pre-rendered dataset root (DirectoryTextureDataset); "
                         "default: the synthetic geometry-rendered stream")
    ap.add_argument("--mode", default="texture", choices=["texture", "delight"])
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches accumulated per optimizer step")
    ap.add_argument("--full-finetune", action="store_true")
    ap.add_argument("--bf16-compute", action="store_true")
    ap.add_argument("--tiny", action="store_true", help="tiny model smoke run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--validation-steps", type=int, default=0,
                    help="render a validation image every N steps")
    ap.add_argument("--prompt", default="[MVFLUX]",
                    help="trigger prompt embedded by the CLIP-L/T5 encoders "
                         "when --pretrain-models holds their weights; '' or "
                         "missing weights -> the zero embeddings inference "
                         "runs with")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def prompt_embeddings(args, cfg, dev):
    """(sequence [S_t, D], pooled [D_p]) on ``dev``: ``--prompt`` through
    the text encoders of ``--pretrain-models``, or zeros (the encoders
    freed once the prompt is embedded)."""
    from ..models.text_encoders import build_text_encoders

    if args.prompt and args.pretrain_models:
        enc = build_text_encoders(args.pretrain_models, device=dev)
        if enc is not None:
            seq, pooled = enc([args.prompt])
            del enc
            if (seq.shape[-1] == cfg.joint_attention_dim
                    and pooled.shape[-1] == cfg.pooled_projection_dim):
                return seq[0], pooled[0]
            print("[launcher] text-encoder dims do not match the model "
                  "config; using zero embeddings")
    return (torch.zeros((512, cfg.joint_attention_dim), device=dev),
            torch.zeros((cfg.pooled_projection_dim,), device=dev))


def full_size():
    """(config, VAE config, view size) of the full model: FLUX.1-dev with
    ``remat=True``, its VAE, 512² views."""
    from ..models.flux.config import FluxConfig
    from ..models.flux.vae import VAEConfig

    return (dataclasses.replace(FluxConfig.flux1_dev(), remat=True),
            VAEConfig.flux(), 512)


def main(argv: Optional[List[str]] = None,
         on_step: Optional[Callable] = None):
    """Train; ``on_step(step, state, loss)`` is called after each step (a
    caller's hook for its own checks).  Returns the final train state."""
    args = parse_args(argv)
    _refuse_deferred(args)
    if args.prior_preservation and args.batch_size % 2:
        raise ValueError("--prior-preservation needs an even --batch-size "
                         "([instance; prior])")

    from ..models.flux.config import FluxConfig
    from ..models.flux.model import init_flux_params
    from ..models.flux.vae import VAEConfig, init_vae_params
    from ..training.checkpoint import CheckpointManager
    from ..training.data import DirectoryTextureDataset, SyntheticTextureDataset
    from ..training.flux_lora import (
        FluxLoraTrainConfig,
        create_train_state,
        train_step,
        train_step_accum,
    )
    from ..utils.logging import MetricLogger
    from ..utils.precision import resolve_device

    dev = resolve_device(args.device)
    if args.tiny:
        cfg = dataclasses.replace(FluxConfig.tiny(), remat=True)
        vae_cfg = VAEConfig.tiny()
        view_size = 32
    else:
        cfg, vae_cfg, view_size = full_size()
    gen = torch.Generator(device=dev)
    if args.pretrain_models and not args.tiny:
        # as the JAX launcher: --tiny trains the seeded tiny trees
        from ..models.flux.loader import load_flux_transformer, load_vae

        root = os.path.join(args.pretrain_models, "flux")
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        tparams = load_flux_transformer(os.path.join(root, "transformer"),
                                        cfg, device=dev, dtype=dtype)
        vparams = load_vae(os.path.join(root, "vae"), vae_cfg, device=dev,
                           dtype=torch.float32)
    else:
        tparams = init_flux_params(gen.manual_seed(args.seed), cfg, device=dev)
        vparams = init_vae_params(gen.manual_seed(args.seed + 1), vae_cfg,
                                  device=dev)

    tcfg = FluxLoraTrainConfig(
        rank=args.rank,
        learning_rate=args.learning_rate,
        optimizer=args.optimizer,
        lr_scheduler=args.lr_scheduler,
        warmup_steps=args.warmup_steps,
        max_train_steps=args.max_train_steps,
        drop_rate=args.drop_rate,
        prior_preservation=args.prior_preservation,
        prior_loss_weight=args.prior_loss_weight,
        preconditioning_loss=args.preconditioning_loss,
        preconditioning_loss_weight=args.preconditioning_loss_weight,
    )
    loss_vae = ({"vae_params": vparams, "vae_cfg": vae_cfg}
                if args.preconditioning_loss else {})
    mgr = CheckpointManager(args.output_dir, args.checkpoint_every,
                            args.checkpoints_total_limit)
    state, tx = create_train_state(gen.manual_seed(args.seed + 2), tparams, tcfg,
                                   device=dev)
    restored = mgr.restore_latest(state.lora)
    if restored is not None:
        print(f"resumed LoRA from step {mgr.latest_step()}")
        with torch.no_grad():
            for dst, src in _pairs(state.lora, restored):
                dst.copy_(src)
        state.step = mgr.latest_step()

    # fixed-prompt conditioning, computed once
    seq_e, pooled_e = prompt_embeddings(args, cfg, dev)

    logger = MetricLogger(args.output_dir)
    if args.data_dir:
        ds = iter(DirectoryTextureDataset(args.data_dir, mode=args.mode,
                                          seed=args.seed))
    else:
        ds = iter(SyntheticTextureDataset(view_size=view_size, seed=args.seed,
                                          device=str(dev)))

    for step in range(state.step, args.max_train_steps):
        examples = [next(ds) for _ in range(args.batch_size * args.grad_accum)]
        batch = build_batch(examples, vparams, vae_cfg, seq_e, pooled_e,
                            args.grad_accum, args.preconditioning_loss)
        step_gen = torch.Generator(device=dev).manual_seed(1000 + step)
        if args.grad_accum > 1:
            state, loss = train_step_accum(state, tparams, batch, step_gen,
                                           cfg, tcfg, tx, **loss_vae)
        else:
            state, loss = train_step(state, tparams, batch, step_gen, cfg,
                                     tcfg, tx, **loss_vae)
        if on_step is not None:
            on_step(step, state, loss)
        logger.log(step, {"loss": float(loss)})
        if step % 10 == 0:
            print(f"step {step}: loss {float(loss):.4f}")
        if mgr.should_save(step):
            mgr.save(step, state.lora)
        if args.validation_steps and step > 0 and step % args.validation_steps == 0:
            _validate(args, step, tparams, state.lora, cfg, vparams, vae_cfg,
                      examples[0]["control"], dev)
    mgr.save(args.max_train_steps, state.lora)
    logger.close()
    return state


def _pairs(a, b):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k])
    else:
        yield a, b


def _validate(args, step, tparams, lora, cfg, vparams, vae_cfg, control, dev):
    """Render one validation image with the adapter merged (the reference
    trainer's ``log_validation``)."""
    from ..models.flux.lora import merge_lora
    from ..models.flux.pipeline import FluxPipelineConfig, run_flux_pipeline
    from ..utils.image_io import save_image

    merged = merge_lora(tparams, [(lora, 1.0)])
    gh, gw = control.shape[:2]
    img = run_flux_pipeline(
        merged, cfg, vparams, vae_cfg,
        torch.Generator(device=dev).manual_seed(args.seed),
        FluxPipelineConfig(height=gh, width=gw, num_inference_steps=8,
                           max_sequence_length=8 if args.tiny else 512),
        control_image=torch.as_tensor(control, device=dev), device=dev,
    )
    save_image(os.path.join(args.output_dir, f"validation_{step}.png"),
               img.cpu().numpy())


if __name__ == "__main__":
    main()
