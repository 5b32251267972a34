"""FLUX LoRA and full fine-tuning launcher, on one GPU or across the
ranks of ``torchrun`` (port of scripts/train_flux_lora.py).

    python -m unitex_torch.scripts.train_flux_lora --tiny --device cpu
    python -m unitex_torch.scripts.train_flux_lora --output-dir lora_out
    torchrun --nproc-per-node 4 -m unitex_torch.scripts.train_flux_lora \
        --data-mesh 2 --output-dir lora_out          # data 2 x model 2
    torchrun --nproc-per-node 4 -m unitex_torch.scripts.train_flux_lora \
        --pipe 2 --pipe-n-micro 2 --batch-size 4     # data 2 x pipe 2
    torchrun --nproc-per-node 4 -m unitex_torch.scripts.train_flux_lora \
        --full-finetune --bf16-compute --data-mesh 2  # ZeRO-1

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

With more than one rank (``WORLD_SIZE`` from ``torchrun``; over gloo with
``--device cpu``) the launcher builds the JAX launcher's meshes
(``parallel/mesh.py``): ``(data = --data-mesh) x model`` with the trees
cut tensor-parallel, or with ``--pipe P`` a ``data x pipe`` mesh whose
block stacks run the GPipe schedule in ``--pipe-n-micro`` microbatches
(``models/flux/pp.py``).  ``--full-finetune`` trains every parameter
(f32 masters, ``--bf16-compute`` for bf16 compute) with the optimizer
state cut over ``data`` (ZeRO-1, ``training/full_finetune.py``).  Every
rank draws the whole batch alike; rank 0 alone writes checkpoints (the
whole adapter or tree, which any mesh, or one card, resumes from), logs
and validation images.
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
    ap.add_argument("--data-mesh", type=int, default=1,
                    help="data-parallel size (the other ranks: model)")
    ap.add_argument("--pipe", type=int, default=0,
                    help="pipeline stages: the mesh becomes data x pipe and "
                         "the block stacks run a GPipe schedule")
    ap.add_argument("--pipe-n-micro", type=int, default=0,
                    help="GPipe microbatches (default: one sample per data "
                         "row)")
    ap.add_argument("--data-dir", default=None,
                    help="pre-rendered dataset root (DirectoryTextureDataset); "
                         "default: the synthetic geometry-rendered stream")
    ap.add_argument("--mode", default="texture", choices=["texture", "delight"])
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches accumulated per optimizer step")
    ap.add_argument("--full-finetune", action="store_true",
                    help="full-parameter fine-tuning with ZeRO-1 optimizer-"
                         "state sharding instead of LoRA")
    ap.add_argument("--bf16-compute", action="store_true",
                    help="bf16 forward/backward over f32 master weights "
                         "(full fine-tuning only)")
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


def _check(args, world: int) -> int:
    """The JAX launcher's checks of the options against each other and the
    world; returns the data axis' size under ``--pipe`` (1 without)."""
    if args.full_finetune and args.grad_accum > 1:
        raise ValueError("--grad-accum composes with LoRA training only")
    if args.full_finetune and args.preconditioning_loss:
        raise ValueError("--preconditioning-loss composes with LoRA training "
                         "only (the full step does not thread the frozen VAE)")
    if args.prior_preservation and args.batch_size % 2:
        raise ValueError("--prior-preservation needs an even --batch-size "
                         "([instance; prior])")
    pipe_data = 1
    if args.pipe:
        if args.full_finetune:
            raise ValueError("--pipe composes with LoRA training")
        if world <= 1 or world % args.pipe:
            raise ValueError(f"{world} ranks not divisible by --pipe "
                             f"{args.pipe} (--pipe needs torchrun's ranks)")
        pipe_data = world // args.pipe
        if args.data_mesh not in (1, pipe_data):
            raise ValueError(
                f"--data-mesh {args.data_mesh} conflicts with --pipe "
                f"{args.pipe}: the data axis is world // pipe = {pipe_data}")
        if args.batch_size % pipe_data:
            raise ValueError(f"--batch-size {args.batch_size} not divisible "
                             f"by the data axis {pipe_data}")
        n_micro = args.pipe_n_micro or max(1, args.batch_size // pipe_data)
        if args.batch_size % n_micro or (args.batch_size // n_micro) % pipe_data:
            raise ValueError(
                f"--batch-size {args.batch_size} / --pipe-n-micro {n_micro} "
                f"microbatches must shard over the data axis {pipe_data}")
    elif world > 1 and (world % args.data_mesh
                        or args.batch_size % args.data_mesh):
        raise ValueError(f"{world} ranks or --batch-size {args.batch_size} "
                         f"not divisible by --data-mesh {args.data_mesh}")
    return pipe_data


def main(argv: Optional[List[str]] = None,
         on_step: Optional[Callable] = None):
    """Train; ``on_step(step, state, loss)`` is called after each step (a
    caller's hook for its own checks).  Returns the final train state."""
    args = parse_args(argv)

    from ..models.flux.config import FluxConfig
    from ..models.flux.lora import init_lora_params
    from ..models.flux.model import init_flux_params, tp_config
    from ..models.flux.vae import VAEConfig, init_vae_params
    from ..parallel.mesh import default_device, make_mesh, world_size_from_env
    from ..parallel.sharding import shard_flux_params, shard_hook, unshard_tree
    from ..training.checkpoint import CheckpointManager
    from ..training.data import DirectoryTextureDataset, SyntheticTextureDataset
    from ..training.flux_lora import (
        FluxLoraTrainConfig,
        _leaves,
        make_optimizer,
        train_step,
        train_step_accum,
    )
    from ..training.full_finetune import (
        FullTrainState,
        create_full_state,
        full_train_step,
        gathered_params,
        shard_opt_state_zero,
    )
    from ..utils.logging import MetricLogger

    world = world_size_from_env()
    pipe_data = _check(args, world)
    dev = default_device(args.device)
    mesh = None
    if args.pipe:
        mesh = make_mesh(data=pipe_data, pipe=args.pipe, model=1, device=dev)
        print(f"[launcher] effective mesh: data={pipe_data} x pipe={args.pipe}")
    elif world > 1:
        mesh = make_mesh(data=args.data_mesh, model=-1, device=dev)
    root = mesh is None or mesh.is_root
    tp = mesh is not None and not args.pipe
    if args.tiny:
        cfg = dataclasses.replace(FluxConfig.tiny(), remat=True)
        vae_cfg = VAEConfig.tiny()
        view_size = 32
    else:
        cfg, vae_cfg, view_size = full_size()
    hook = shard_hook(mesh) if tp else None
    dtype = None
    if args.full_finetune:
        dtype = torch.float32   # the f32 masters
    elif cfg.dtype == "bfloat16":
        dtype = torch.bfloat16
    gen = torch.Generator(device=dev)
    if args.pretrain_models and not args.tiny:
        # as the JAX launcher: --tiny trains the seeded tiny trees
        from ..models.flux.loader import load_flux_transformer, load_vae

        path = os.path.join(args.pretrain_models, "flux")
        tparams = load_flux_transformer(os.path.join(path, "transformer"),
                                        cfg, device=dev, dtype=dtype,
                                        mesh=mesh if tp else None)
        vparams = load_vae(os.path.join(path, "vae"), vae_cfg, device=dev,
                           dtype=torch.float32)
    else:
        tparams = init_flux_params(gen.manual_seed(args.seed), cfg, device=dev,
                                   dtype=dtype, hook=hook)
        vparams = init_vae_params(gen.manual_seed(args.seed + 1), vae_cfg,
                                  device=dev)
    step_cfg = tp_config(cfg, mesh.group("model")) if tp else cfg
    data_axis = mesh.group("data") if tp else None

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
        pipe_axis=mesh.group("pipe") if args.pipe else None,
        pipe_n_micro=args.pipe_n_micro or max(1, args.batch_size // pipe_data),
        pipe_data_axis=(mesh.group("data") if args.pipe and pipe_data > 1
                        else None),
    )
    loss_vae = ({"vae_params": vparams, "vae_cfg": vae_cfg}
                if args.preconditioning_loss else {})
    mgr = CheckpointManager(args.output_dir, args.checkpoint_every,
                            args.checkpoints_total_limit)
    tx = make_optimizer(tcfg)
    if args.full_finetune:
        if mesh is not None:
            for leaf in _leaves(tparams):
                leaf.requires_grad_(True)
            opt, zero = shard_opt_state_zero(tparams, mesh, tx)
            state = FullTrainState(step=0, params=tparams, opt_state=opt,
                                   zero=zero)
        else:
            state, tx = create_full_state(tparams, tcfg)
        trained = state.params

        def export(st):
            return gathered_params(st, mesh if tp else None)

        def cut(whole):
            return shard_flux_params(whole, mesh) if tp else whole
    else:
        # the adapter is drawn on the whole kernels' shapes, then cut, so
        # every mesh starts from the same adapter
        from ..models.flux.model import flux_param_shapes
        from ..training.flux_lora import TrainState

        lora = init_lora_params(gen.manual_seed(args.seed + 2),
                                flux_param_shapes(cfg), rank=tcfg.rank,
                                device=dev)
        if args.pipe:
            from ..models.flux.pp import (
                gather_stages,
                prepare_flux_params_pp,
                prepare_lora_pp,
                strip_lora_padding,
            )

            tparams = prepare_flux_params_pp(tparams, mesh)

            def cut(whole):
                return prepare_lora_pp(whole, mesh)

            def export(st):
                return strip_lora_padding(gather_stages(st.lora, mesh), cfg)
        elif tp:
            def cut(whole):
                return shard_flux_params(whole, mesh)

            def export(st):
                return unshard_tree(st.lora, mesh.group("model"))
        else:
            def cut(whole):
                return whole

            def export(st):
                return st.lora
        lora = cut(lora)
        for leaf in _leaves(lora):
            leaf.requires_grad_(True)
        state = TrainState(step=0, lora=lora, opt_state=tx.init(lora))
        trained = state.lora
    latest = mgr.latest_step()
    if latest is not None:
        restored = cut(mgr.restore_latest(export(state)))
        what = "full params" if args.full_finetune else "LoRA"
        if root:
            print(f"resumed {what} from step {latest}")
        with torch.no_grad():
            for dst, src in zip(_leaves(trained), _leaves(restored)):
                dst.copy_(src)
        state.step = latest

    # fixed-prompt conditioning, computed once
    seq_e, pooled_e = prompt_embeddings(args, cfg, dev)

    logger = MetricLogger(args.output_dir) if root else None
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
        if args.full_finetune:
            state, loss = full_train_step(state, batch, step_gen, step_cfg,
                                          tcfg, tx, args.bf16_compute,
                                          data_axis=data_axis)
        elif args.grad_accum > 1:
            state, loss = train_step_accum(state, tparams, batch, step_gen,
                                           step_cfg, tcfg, tx, **loss_vae,
                                           data_axis=data_axis)
        else:
            state, loss = train_step(state, tparams, batch, step_gen, step_cfg,
                                     tcfg, tx, **loss_vae, data_axis=data_axis)
        if on_step is not None:
            on_step(step, state, loss)
        if root:
            logger.log(step, {"loss": float(loss)})
            if step % 10 == 0:
                print(f"step {step}: loss {float(loss):.4f}")
        if mgr.should_save(step):
            whole = export(state)
            if root:
                mgr.save(step, whole)
        if args.validation_steps and step > 0 and step % args.validation_steps == 0:
            _validate(args, step, tparams, state, step_cfg, vparams, vae_cfg,
                      examples[0]["control"], dev, tcfg, root)
    whole = export(state)
    if root:
        mgr.save(args.max_train_steps, whole)
        logger.close()
    return state


def _validate(args, step, tparams, state, cfg, vparams, vae_cfg, control, dev,
              tcfg, root):
    """Render one validation image with the adapter merged, or the fully
    fine-tuned tree (the reference trainer's ``log_validation``); every
    rank denoises, rank 0 writes the image.  Under ``--pipe`` through the
    pipelined forward, one microbatch."""
    import functools

    from ..models.flux.lora import merge_lora
    from ..models.flux.pipeline import (
        FluxPipelineConfig,
        flux_decode,
        flux_denoise,
        flux_inputs,
    )
    from ..utils.image_io import save_image

    with torch.no_grad():
        merged = (state.params if args.full_finetune
                  else merge_lora(tparams, [(state.lora, 1.0)]))
        forward_fn = None
        if tcfg.pipe_axis is not None:
            from ..models.flux.pp import flux_forward_pp

            # the batch is 1 here: one microbatch, no data cut
            forward_fn = functools.partial(flux_forward_pp, n_micro=1,
                                           pipe_axis=tcfg.pipe_axis)
        gh, gw = control.shape[:2]
        pipe_cfg = FluxPipelineConfig(height=gh, width=gw,
                                      num_inference_steps=8,
                                      max_sequence_length=8 if args.tiny else 512)
        inputs = flux_inputs(cfg, vparams, vae_cfg,
                             torch.Generator(device=dev).manual_seed(args.seed),
                             pipe_cfg, control_image=torch.as_tensor(
                                 control, device=dev), device=dev)
        tokens = flux_denoise(merged, cfg, inputs, pipe_cfg,
                              forward_fn=forward_fn)
        img = flux_decode(vparams, vae_cfg, tokens, pipe_cfg)
    if root:
        save_image(os.path.join(args.output_dir, f"validation_{step}.png"),
                   img.float().cpu().numpy())


if __name__ == "__main__":
    main()
