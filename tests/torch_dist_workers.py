"""Multi-rank runs for the port's tests: gloo workers in spawned processes.

:func:`spawn` starts one process per rank (``torch.multiprocessing``'s
``spawn`` context, one PyTorch thread each), joined by a ``FileStore``
under the test's own directory, so pytest-xdist workers never share a
port.  Each rank runs a worker function of this module, which imports no
JAX: it reads the parent's numpy inputs, runs the port across the ranks
and returns a dict of numpy arrays, saved as ``rank<r>.npz``.
:meth:`Spawned.join` waits for every rank under one deadline, kills the
ranks still alive when it passes, and raises if any rank failed: a hang
fails its test instead of cutting the run.
"""

from __future__ import annotations

import dataclasses
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT = 120.0   # seconds for all ranks of one spawn


# ------------------------------------------------------------- numpy trees


def flatten(tree, prefix: str = "") -> dict:
    """{"a/0/c": numpy array} of a nested dict (or list) of tensors or
    arrays (bfloat16 ones widened to float32, exactly); ``None`` leaves
    are left out."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(flatten(v, path))
        elif torch.is_tensor(v):
            v = v.detach()
            out[path] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        elif v is not None:
            out[path] = np.asarray(v)
    return out


def unflatten(flat: dict, prefix: str) -> dict:
    """The nested dict of tensors under ``prefix/`` of a flat dict, a node
    whose keys are 0, 1, ... as a list."""
    out: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *parents, leaf = key[len(prefix) + 1:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.array(value))

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(out)


# ------------------------------------------------------------------ spawn


@dataclasses.dataclass
class Spawned:
    procs: list
    out_dir: str
    deadline: float

    def join(self) -> list:
        """Every rank's results, in rank order; raises if a rank failed or
        the deadline passed (the ranks still alive are killed)."""
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        alive = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in self.procs]
        errors = [open(path).read() for path in (
            os.path.join(self.out_dir, f"rank{r}.err")
            for r in range(len(self.procs))) if os.path.exists(path)]
        if alive or any(codes):
            raise AssertionError(f"ranks {alive} timed out, exit codes {codes}"
                                 + "".join("\n" + e for e in errors))
        return [dict(np.load(os.path.join(self.out_dir, f"rank{r}.npz")))
                for r in range(len(self.procs))]


def spawn(worker: str, world: int, out_dir: str, inputs: dict,
          timeout: float = JOIN_TIMEOUT) -> Spawned:
    """Start ``world`` ranks of the worker function named ``worker`` on the
    numpy ``inputs``; :meth:`Spawned.join` collects them."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "inputs.npz"), **inputs)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(worker, r, world, out_dir),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return Spawned(procs, out_dir, time.monotonic() + timeout)


def _entry(worker: str, rank: int, world: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(out_dir, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
        with torch.no_grad():
            result = globals()[worker](rank, inputs, out_dir)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **result)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def _mesh(**axes):
    from unitex_torch.parallel.mesh import make_mesh

    return make_mesh(device="cpu", **axes)


def _prefixed(prefix: str, tree: dict) -> dict:
    return {f"{prefix}/{k}": v for k, v in flatten(tree).items()}


def _flux_args(inputs: dict):
    """The FLUX forward's tensors of the inputs (``x/*``)."""
    names = ("hidden", "context", "timestep", "pooled", "img_ids", "txt_ids",
             "guidance")
    return [torch.from_numpy(inputs[f"x/{n}"]) for n in names]


def _sd3_args(inputs: dict):
    names = ("latents", "context", "timestep", "pooled")
    return [torch.from_numpy(inputs[f"sd3x/{n}"]) for n in names]


# ---------------------------------------------------------------- workers


def parallel_worker(rank: int, inputs: dict, out_dir: str) -> dict:
    """Tensor parallelism at model = 4 and at data 2 x model 2: the meshes'
    coordinates, FLUX's and its adapters' slices, the TP FLUX forward with
    the adapters merged per block, the TP SD3 forward."""
    from unitex_torch.models.flux.config import FluxConfig
    from unitex_torch.models.flux.model import flux_forward, tp_config
    from unitex_torch.models.sd3 import model as sd3
    from unitex_torch.models.sd3.config import SD3Config
    from unitex_torch.parallel.sharding import shard_flux_params, shard_sd3_params

    flux, lora = unflatten(inputs, "flux"), unflatten(inputs, "lora")
    sd3_tree = unflatten(inputs, "sd3")
    out = {}
    for name, mesh in (("tp4", _mesh(data=1, model=4)),
                       ("tp2", _mesh(data=2, model=2))):
        out[f"{name}/coords"] = np.array(
            [mesh.index(a) for a in ("data", "seq", "model")])
        out[f"{name}/model_ranks"] = np.array(
            dist.get_process_group_ranks(mesh.group("model")))
        out[f"{name}/data_ranks"] = np.array(
            dist.get_process_group_ranks(mesh.group("data")))
        shard, shard_lora = shard_flux_params(flux, mesh), shard_flux_params(lora, mesh)
        out.update(_prefixed(f"{name}/flux", shard))
        out.update(_prefixed(f"{name}/lora", shard_lora))
        cfg = tp_config(FluxConfig.tiny(), mesh.group("model"))
        out[f"{name}/forward"] = flux_forward(
            shard, cfg, *_flux_args(inputs), lora=shard_lora).numpy()
        out[f"{name}/sd3"] = sd3.sd3_forward(
            shard_sd3_params(sd3_tree, mesh),
            tp_config(SD3Config.tiny(), mesh.group("model")),
            *_sd3_args(inputs)).numpy()
    try:
        _mesh(data=3)
    except ValueError as e:
        out["bad_mesh"] = np.array(str(e))
    return out


def ring_worker(rank: int, inputs: dict, out_dir: str) -> dict:
    """Ring and Ulysses on whole tensors at n = 4 and n = 2 (data 2 x
    seq 2), the Ulysses exchange's order, and "auto" with heads that do
    not divide the group."""
    from unitex_torch.ops import ring_attention as ra

    q, k, v = (torch.from_numpy(inputs[n]) for n in ("q", "k", "v"))
    out = {}
    for n, mesh in ((4, _mesh(seq=4, model=1)), (2, _mesh(data=2, seq=2, model=1))):
        group = mesh.group("seq")
        out[f"ring{n}"] = ra.ring_attention(q, k, v, group).numpy()
        out[f"ulysses{n}"] = ra.ulysses_attention(q, k, v, group).numpy()
        s = q.shape[1] // n
        block = q[:, mesh.index("seq") * s:(mesh.index("seq") + 1) * s]
        out[f"gathered{n}"] = ra._heads_to_sequence(block, group).numpy()
        out[f"round_trip{n}"] = ra._sequence_to_heads(
            ra._heads_to_sequence(block, group), group).numpy()
    # 6 heads over 4 ranks: "auto" takes the ring
    group = _mesh(seq=4, model=1).group("seq")
    q6, k6, v6 = (torch.from_numpy(inputs[n]) for n in ("q6", "k6", "v6"))
    s = q6.shape[1] // 4
    r = dist.get_rank(group)
    local = [x[:, r * s:(r + 1) * s] for x in (q6, k6, v6)]
    out["auto6"] = ra.sequence_parallel_attention(*local, group, "auto").numpy()
    out["ring6"] = ra.ring_attention_local(*local, group).numpy()
    return out


def sp_worker(rank: int, inputs: dict, out_dir: str) -> dict:
    """``flux_forward_sp`` (Ulysses and ring at n = 4, Ulysses at n = 2,
    SP x TP on seq 2 x model 2), ``sd3_forward_sp`` and the SR stage on a
    data 2 x model 2 mesh."""
    from unitex_torch.models.flux.config import FluxConfig
    from unitex_torch.models.flux.sp import flux_forward_sp
    from unitex_torch.models.sd3.config import SD3Config
    from unitex_torch.models.sd3.model import sd3_forward_sp
    from unitex_torch.parallel.sharding import shard_flux_params

    flux, cfg = unflatten(inputs, "flux"), FluxConfig.tiny()
    args = _flux_args(inputs)
    out = {}
    seq4 = _mesh(seq=4, model=1).group("seq")
    out["ulysses4"] = flux_forward_sp(flux, cfg, *args, seq_axis=seq4,
                                      sp_mode="ulysses").numpy()
    out["ring4"] = flux_forward_sp(flux, cfg, *args, seq_axis=seq4,
                                   sp_mode="ring").numpy()
    out["ulysses2"] = flux_forward_sp(
        flux, cfg, *args, seq_axis=_mesh(data=2, seq=2, model=1).group("seq"),
        sp_mode="ulysses").numpy()
    sxt = _mesh(seq=2, model=2)
    out["sp_tp"] = flux_forward_sp(
        shard_flux_params(flux, sxt), cfg, *args, seq_axis=sxt.group("seq"),
        tp_axis=sxt.group("model")).numpy()
    try:
        flux_forward_sp(flux, cfg, *args, kv_keep_idx=torch.arange(4),
                        seq_axis=seq4)
    except ValueError as e:
        out["kv_refused"] = np.array(str(e))
    out["sd3_sp"] = sd3_forward_sp(unflatten(inputs, "sd3"), SD3Config.tiny(),
                                   *_sd3_args(inputs), seq_axis=seq4).numpy()

    out["sr"] = _sr_stage(inputs, _mesh(data=2, model=2)).numpy()
    return out


def pipeline_worker(rank: int, inputs: dict, out_dir: str) -> dict:
    """The texturing job, tiny and weightless, with no mesh given: the
    pipeline finds the running group (``torchrun``'s case) and builds its
    own ``(data 1, model = world)`` mesh."""
    out = {}
    for name in ("tiny", "weightless"):
        tex = _pipeline_job(inputs, out_dir, name)
        if tex is not None:
            out[f"texture_{name}"] = tex
    return out


# -------------------------------------------- the SR stage and the pipeline


SR_KW = dict(upscale=4, latent_tile=16, latent_overlap=4, vae_encoder_tile=64,
             vae_decoder_tile=32, tile_batch=6, vae_decode_dtype="float32")


def _sr_stage(inputs: dict, mesh=None, **cfg):
    """The tiny TSD-SR stage (tests/test_torch_sr.py's tiling, f32) on the
    input image, on ``mesh`` or on one rank; ``cfg``: more
    ``TSDSRConfig`` fields."""
    from unitex_torch.models.flux.vae import VAEConfig
    from unitex_torch.models.sd3 import sr_pipeline as sr
    from unitex_torch.models.sd3.config import SD3Config

    pipe = sr.TSDSRPipeline(
        None, cfg=sr.TSDSRConfig(**SR_KW, **cfg), sd3_cfg=SD3Config.tiny(),
        transformer_params=unflatten(inputs, "sd3"),
        vae_params=unflatten(inputs, "sd3vae"), mesh=mesh, device="cpu")
    pipe.vae_cfg = VAEConfig.tiny()
    root = mesh is None or mesh.is_root
    return pipe(torch.from_numpy(inputs["sr_image"]) if root else None)


def pipeline_config():
    """tests/test_torch_pipeline.py's small config, 2 denoise steps."""
    from unitex_torch import config as c

    return c.PipelineConfig(
        camera=c.CameraConfig(view_size=32),
        mesh=c.MeshConfig(min_faces=500, max_faces=2000, uv_size=64,
                          shape_bucket=0),
        bake=c.BakeConfig(uv_size=64),
        diffusion=c.DiffusionConfig(height=32, width=192, dual_size=16,
                                    num_inference_steps=2,
                                    max_sequence_length=8))


def _pipeline_job(inputs: dict, out_dir: str, name: str):
    """One texturing job of the tiny pipeline (``name`` "tiny": the tiny
    FLUX, VAE and adapters; "weightless": none), across the running
    process group if there is one; rank 0's texture, None on the other
    ranks."""
    from unitex_torch.models.flux.config import FluxConfig
    from unitex_torch.models.flux.vae import VAEConfig
    from unitex_torch.pipeline import CustomRGBTextureFullPipeline

    pipe = CustomRGBTextureFullPipeline(config=pipeline_config(), seed=63,
                                        device="cpu")
    if name == "tiny":
        pipe.flux_cfg, pipe.vae_cfg = FluxConfig.tiny(), VAEConfig.tiny()
        pipe.set_flux_trees(unflatten(inputs, "flux"),
                            unflatten(inputs, "vae"),
                            unflatten(inputs, "lora"),
                            unflatten(inputs, "lora2"))
    job_dir = os.path.join(out_dir, f"job_{name}")
    _, glb = pipe(job_dir, str(inputs["image_path"]), str(inputs["mesh_path"]))
    if glb is None:
        return None
    pipe.flush_io()
    assert os.path.exists(glb)
    return pipe.last_texture.numpy()


# ----------------------------------------------------------- training


def _train_args(inputs: dict, prefix: str = "b"):
    """(batch, [draws of step 1, draws of step 2]) of the training inputs."""
    batch = {k: torch.from_numpy(inputs[f"{prefix}/{k}"]) for k in
             ("latents", "cond_tokens", "cond_ids", "prompt_embeds",
              "pooled_embeds")}
    draws = []
    for s in (0, 1):
        d = {"u": inputs[f"d{s}/u"], "noise": inputs[f"d{s}/noise"]}
        if f"d{s}/keep_idx" in inputs:
            d["keep_idx"] = inputs[f"d{s}/keep_idx"]
        draws.append(d)
    return batch, draws


def _lora_tcfg(**kw):
    from unitex_torch.training.flux_lora import FluxLoraTrainConfig

    return FluxLoraTrainConfig(**{**TRAIN_KW, **kw})


# the training cases' optimizer settings (tests/test_torch_tp_train.py);
# the clip is active on the tiny model's gradients
TRAIN_KW = dict(rank=2, learning_rate=1e-3, adam_eps=1e-4, max_grad_norm=0.05,
                drop_rate=0.25)
FULL_KW = dict(rank=2, learning_rate=1e-4, max_grad_norm=0.1, drop_rate=0.25)


def _requires_grad(tree):
    from unitex_torch.training.flux_lora import _leaves

    for leaf in _leaves(tree):
        leaf.requires_grad_(True)
    return tree


def _lora_steps(inputs, mesh, data_axis, tp: bool, tcfg=None, cut=None):
    """Two LoRA train steps on this rank's part of the inputs' trees:
    the losses, and the whole adapter and Adam moments after them."""
    from unitex_torch.models.flux.config import FluxConfig
    from unitex_torch.models.flux.model import tp_config
    from unitex_torch.parallel.sharding import shard_flux_params, unshard_tree
    from unitex_torch.training.flux_lora import TrainState, make_optimizer, train_step

    tcfg = tcfg or _lora_tcfg()
    cfg = FluxConfig.tiny()
    base, lora = unflatten(inputs, "flux"), unflatten(inputs, "lora")
    if tp:
        cfg = tp_config(cfg, mesh.group("model"))
        base, lora = shard_flux_params(base, mesh), shard_flux_params(lora, mesh)
    if cut is not None:
        base, lora = cut(base, lora)
    lora = _requires_grad(_clone_tree(lora))
    tx = make_optimizer(tcfg)
    state = TrainState(step=0, lora=lora, opt_state=tx.init(lora))
    batch, draws = _train_args(inputs)
    losses = []
    for d in draws:
        state, loss = train_step(state, base, batch, None, cfg, tcfg, tx,
                                 draws=d, data_axis=data_axis)
        losses.append(float(loss))
    trees = {"lora": state.lora, "mu": state.opt_state["mu"],
             "nu": state.opt_state["nu"]}
    if tp:
        trees = {k: unshard_tree(v, mesh.group("model")) for k, v in trees.items()}
    return np.array(losses), trees


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def _zero_steps(inputs, mesh, tp: bool, bf16: bool, ckpt: str = None):
    """Two ZeRO-1 full fine-tuning steps: the losses, the whole parameters
    and moments after them, and each moment leaf's share of its
    parameter's (local) size."""
    from unitex_torch.models.flux.config import FluxConfig
    from unitex_torch.models.flux.model import tp_config
    from unitex_torch.parallel.sharding import gather, shard_flux_params, unshard_tree
    from unitex_torch.training.flux_lora import (
        FluxLoraTrainConfig,
        _leaves,
        _map,
        make_optimizer,
    )
    from unitex_torch.training.full_finetune import (
        FullTrainState,
        full_train_step,
        gathered_params,
        shard_opt_state_zero,
    )

    tcfg = FluxLoraTrainConfig(**FULL_KW)
    cfg = FluxConfig.tiny()
    params = _clone_tree(unflatten(inputs, "flux"))
    if tp:
        cfg = tp_config(cfg, mesh.group("model"))
        params = shard_flux_params(params, mesh)
    _requires_grad(params)
    tx = make_optimizer(tcfg)
    opt, zero = shard_opt_state_zero(params, mesh, tx, tp=tp)
    state = FullTrainState(step=0, params=params, opt_state=opt, zero=zero)
    batch, draws = _train_args(inputs)
    losses = []
    for d in draws:
        state, loss = full_train_step(state, batch, None, cfg, tcfg, tx,
                                      bf16_compute=bf16, draws=d,
                                      data_axis=mesh.group("data"))
        losses.append(float(loss))
    dims, group = zero
    share = np.array([m.numel() / p.numel() for m, p in zip(
        _leaves(state.opt_state["mu"]), _leaves(state.params))])
    has_dim = np.array([d is not None for d in dims])
    out = {"params": gathered_params(state, mesh if tp else None)}
    for name in ("mu", "nu"):
        it = iter(dims)
        whole = _map(lambda m: m if (d := next(it)) is None
                     else gather(m.contiguous(), group, d), state.opt_state[name])
        out[name] = unshard_tree(whole, mesh.group("model")) if tp else whole
    if ckpt is not None and mesh.is_root:
        from unitex_torch.training.checkpoint import CheckpointManager

        CheckpointManager(ckpt, 1).save(2, out["params"])
    return np.array(losses), out, share, has_dim


def pipeline_stage(params, h, aux, shared):
    """A stage of the schedule tests: one nonlinear layer of its own."""
    return torch.tanh(h @ params) * aux


def _pipeline_grads(inputs) -> dict:
    """``pipeline_apply`` (``gpipe_local``) and ``gpipe_chain_local`` at
    pipe 4 on three
    microbatches through :func:`pipeline_stage` (stage ``s`` of phase
    ``a`` holds ``W[a, s]``): each rank's output and the gradients of
    ``sum(w * out)`` for its weights and the input."""
    from unitex_torch.parallel.pipeline import gpipe_chain_local, pipeline_apply

    p4 = _mesh(data=1, pipe=4, model=1)
    group, s = p4.group("pipe"), p4.index("pipe")
    W, w = (torch.from_numpy(inputs[f"pipe/{n}"]) for n in ("W", "w"))
    aux = torch.from_numpy(inputs["pipe/aux"])
    out = {}
    for name in ("gpipe", "chain"):
        wa, wb = (W[a, s].clone().requires_grad_(True) for a in (0, 1))
        x = torch.from_numpy(inputs["pipe/x"]).requires_grad_(True)
        if name == "chain":
            y = gpipe_chain_local(pipeline_stage, pipeline_stage, wa, wb, x,
                                  aux, None, group)
        else:
            y = pipeline_apply(pipeline_stage, wa, x, aux, None, group)
        (w * y).sum().backward()
        out[f"{name}/out"] = y.detach().numpy()
        out[f"{name}/dwa"] = wa.grad.numpy()
        if name == "chain":
            out[f"{name}/dwb"] = wb.grad.numpy()
        out[f"{name}/dx"] = (x.grad if x.grad is not None
                             else torch.zeros_like(x)).numpy()
    return out


def lora_mesh_worker(rank: int, inputs: dict, out_dir: str) -> dict:
    """The autograd collectives on a model = 4 group; two LoRA train steps
    at model 4, model 2 (each data row of data 2 x model 2 on the whole
    batch), data 2 x model 2, pipe 4, pipe 2 (each data row of data 2 x
    pipe 2 on the whole batch) and data 2 x pipe 2; the data 2 x model 2
    adapter written as a checkpoint by rank 0; ZeRO-1 steps with the bf16
    compute at data 2 and data 2 x model 2."""
    from unitex_torch.parallel import collectives as col

    out = {}
    with torch.enable_grad():
        tp4 = _mesh(data=1, model=4)
        group, m = tp4.group("model"), tp4.index("model")
        # g: the sum's gradient passes unchanged
        x = torch.from_numpy(inputs["col/x"][m]).requires_grad_(True)
        (torch.from_numpy(inputs["col/w"]) * col.reduce_from(x * 1.0, group)
         ).sum().backward()
        out["g_grad"] = x.grad.numpy()
        # f: the replicated input's gradient sums the ranks' columns
        x = torch.from_numpy(inputs["col/x"][0]).requires_grad_(True)
        y = col.copy_to(x, group) @ torch.from_numpy(inputs["col/W"][m])
        (y * torch.from_numpy(inputs["col/v"][m])).sum().backward()
        out["f_grad"] = x.grad.numpy()
        # the gather: this rank's slice of the whole gradient, not N times it
        x = torch.from_numpy(inputs["col/x"][m]).requires_grad_(True)
        (torch.from_numpy(inputs["col/wg"]) * col.gather_from(x, group, -1)
         ).sum().backward()
        out["gather_grad"] = x.grad.numpy()

        out.update(_pipeline_grads(inputs))

        dxm = _mesh(data=2, model=2)
        for case, mesh, data_axis in (("tp4", tp4, None), ("tp2", dxm, None),
                                      ("dp2tp2", dxm, dxm.group("data"))):
            losses, trees = _lora_steps(inputs, mesh, data_axis, True)
            out[f"{case}/losses"] = losses
            out.update(_prefixed(case, trees))
            if case == "dp2tp2" and dxm.is_root:
                from unitex_torch.training.checkpoint import CheckpointManager

                CheckpointManager(os.path.join(out_dir, "lora_ckpt"), 1).save(
                    2, trees["lora"])
        p4 = _mesh(data=1, pipe=4, model=1)
        dxp = _mesh(data=2, pipe=2, model=1)
        for case, mesh, data in (("pp4", p4, False), ("pp2", dxp, False),
                                 ("dp2pp2", dxp, True)):
            losses, trees = _pp_steps(inputs, mesh, data)
            out[f"{case}/losses"] = losses
            out.update(_prefixed(case, trees))
        out.update(_zero_cases(inputs, dxp, dxm, bf16=True))
    return out


def _zero_cases(inputs, dxp, dxm, bf16: bool, ckpt: str = None) -> dict:
    """ZeRO-1 steps at data 2 (the data 2 x pipe 2 mesh ``dxp``, its pipe
    rows alike) and data 2 x model 2 (``dxm``); ``ckpt``: where rank 0
    writes the data 2 x model 2 tree."""
    out = {}
    tag = "bf16" if bf16 else "f32"
    for case, mesh, tp in (("zero_dp2", dxp, False), ("zero_dp2tp2", dxm, True)):
        losses, trees, share, has_dim = _zero_steps(
            inputs, mesh, tp, bf16, ckpt if case == "zero_dp2tp2" else None)
        out[f"{case}_{tag}/losses"] = losses
        out[f"{case}_{tag}/share"] = share
        out[f"{case}_{tag}/has_dim"] = has_dim
        out.update(_prefixed(f"{case}_{tag}", trees))
    return out


def zero_pp_worker(rank: int, inputs: dict, out_dir: str) -> dict:
    """ZeRO-1 steps in f32 at data 2 (a data 2 x pipe 2 mesh, its pipe rows
    alike) and data 2 x model 2, the data 2 x model 2 tree written as a
    checkpoint by rank 0; the pipelined forwards at pipe 4 (the tiny
    model's 2 + 2 blocks padded to 4 + 4), pipe 2 (each data row of data
    2 x pipe 2 on the whole batch), data 2 x pipe 2, model 2 x pipe 2 and
    with ``kv_keep_idx`` at pipe 4; the adapter through
    ``prepare_lora_pp``, ``gather_stages`` and ``strip_lora_padding``."""
    from unitex_torch.models.flux.config import FluxConfig
    from unitex_torch.models.flux.pp import (
        gather_stages,
        prepare_lora_pp,
        strip_lora_padding,
    )

    dxm = _mesh(data=2, model=2)
    dxp = _mesh(data=2, pipe=2, model=1)
    with torch.enable_grad():
        out = _zero_cases(inputs, dxp, dxm, bf16=False,
                          ckpt=os.path.join(out_dir, "full_ckpt"))
    p4 = _mesh(data=1, pipe=4, model=1)
    pxm = _mesh(data=1, pipe=2, model=2)
    keep = torch.from_numpy(inputs["ppx/keep"]).long()
    out["fwd/pp4"] = _pp_forward(inputs, p4)
    out["fwd/pp2"] = _pp_forward(inputs, dxp)
    out["fwd/dp2pp2"] = _pp_forward(inputs, dxp, data=True)
    out["fwd/tp2pp2"] = _pp_forward(inputs, pxm, tp=True)
    out["fwd/kv_pp4"] = _pp_forward(inputs, p4, keep=keep)
    prepared = prepare_lora_pp(unflatten(inputs, "lora"), p4)
    out["pp4_depths"] = np.array([
        prepared["dual_blocks"]["ff"]["in"]["a"].shape[0],
        prepared["single_blocks"]["proj_mlp"]["a"].shape[0]])
    out.update(_prefixed("round_trip", strip_lora_padding(
        gather_stages(prepared, p4), FluxConfig.tiny())))
    return out


def _pp_forward(inputs, mesh, data: bool = False, tp: bool = False,
                keep=None):
    """The pipelined forward of the inputs' tree with the adapter merged in
    each block, in ``N_MICRO`` microbatches."""
    from unitex_torch.models.flux.config import FluxConfig
    from unitex_torch.models.flux.pp import (
        flux_forward_pp,
        prepare_flux_params_tp_pp,
        prepare_lora_pp,
    )

    cfg, flux = FluxConfig.tiny(), unflatten(inputs, "flux")
    lora = unflatten(inputs, "lora")
    kw = {}
    if tp:
        flux = prepare_flux_params_tp_pp(flux, cfg, mesh)
        lora = prepare_lora_pp(lora, mesh, tp_axis="model")
        kw["tp_axis"] = mesh.group("model")
    return flux_forward_pp(
        flux, cfg, *_pp_args(inputs), kv_keep_idx=keep, n_micro=N_MICRO,
        pipe_axis=mesh.group("pipe"),
        data_axis=mesh.group("data") if data else None, lora=lora, **kw).numpy()


N_MICRO = 2


def _pp_args(inputs):
    names = ("hidden", "context", "timestep", "pooled", "img_ids", "txt_ids",
             "guidance")
    return [torch.from_numpy(inputs[f"ppx/{n}"]) for n in names]


def _pp_steps(inputs, mesh, data: bool):
    """Two LoRA train steps with the block stacks pipelined: the losses,
    and the stripped whole adapter and moments after them."""
    from unitex_torch.models.flux.pp import (
        gather_stages,
        prepare_flux_params_pp,
        prepare_lora_pp,
        strip_lora_padding,
    )
    from unitex_torch.models.flux.config import FluxConfig

    tcfg = _lora_tcfg(pipe_axis=mesh.group("pipe"), pipe_n_micro=N_MICRO,
                      pipe_data_axis=mesh.group("data") if data else None)

    def cut(base, lora):
        return prepare_flux_params_pp(base, mesh), prepare_lora_pp(lora, mesh)

    losses, trees = _lora_steps(inputs, mesh, None, False, tcfg, cut)
    cfg = FluxConfig.tiny()
    return losses, {k: strip_lora_padding(gather_stages(v, mesh), cfg)
                    for k, v in trees.items()}


# the launcher's runs over two ranks (tests/test_torch_pp.py): each covers
# some of the five multi-rank flags
LAUNCHER_RUNS = {
    "dp": ["--data-mesh", "2", "--batch-size", "2"],
    "pp": ["--pipe", "2", "--pipe-n-micro", "2", "--batch-size", "2"],
    "zero": ["--full-finetune", "--bf16-compute", "--data-mesh", "2",
             "--batch-size", "2"],
}


def launcher_worker(rank: int, inputs: dict, out_dir: str) -> dict:
    """``unitex_torch.scripts.train_flux_lora.main`` on the running gloo
    group (``WORLD_SIZE`` as ``torchrun`` sets it): one ``--tiny`` step of
    each run of ``LAUNCHER_RUNS``, then the same run resumed to a second
    step from its checkpoint."""
    import sys

    from unitex_torch.scripts import train_flux_lora as launcher

    sys.modules["torch.utils.tensorboard"] = None   # no TensorFlow import
    os.environ["WORLD_SIZE"] = str(dist.get_world_size())
    out = {}
    with torch.enable_grad():
        for name, flags in LAUNCHER_RUNS.items():
            run_dir = os.path.join(out_dir, name)
            common = ["--tiny", "--device", "cpu", "--output-dir", run_dir,
                      "--lr-scheduler", "constant", "--checkpoint-every", "1",
                      "--rank", "2"] + flags
            losses = []
            launcher.main(common + ["--max-train-steps", "1"],
                          on_step=lambda s, st, loss: losses.append(float(loss)))
            launcher.main(common + ["--max-train-steps", "2"],
                          on_step=lambda s, st, loss: losses.append(float(loss)))
            out[f"{name}/losses"] = np.array(losses)
    return out


# ------------------------------------------------ int8 serving across ranks


INT8_MODES = {"w8a8": True, "max_memory": "max_memory"}
# the serving-tree cache cases: name -> (int8_serving, params_cache_int4)
CACHE_CASES = {"int8": (True, False), "int4": (True, True)}
T5_HEADS = 4


def t5_config():
    """The tiny T5 encoder of tests/test_torch_text.py."""
    from unitex_torch.models.text import T5EncoderConfig

    return T5EncoderConfig(vocab_size=100, d_model=64, d_kv=8, d_ff=96,
                           num_layers=2, num_heads=T5_HEADS)


def cache_pipeline(cache_dir: str, mode, int4: bool, mesh=None):
    """The tiny pipeline's random serving tree through ``params_cache``
    (built and written, or read), on ``mesh`` or on one rank."""
    from unitex_torch.models.flux.config import FluxConfig
    from unitex_torch.models.flux.vae import VAEConfig
    from unitex_torch.pipeline import CustomRGBTextureFullPipeline

    pipe = CustomRGBTextureFullPipeline(
        config=pipeline_config(), int8_serving=mode, params_cache=cache_dir,
        params_cache_int4=int4, device="cpu", mesh=mesh)
    pipe.flux_cfg, pipe.vae_cfg = FluxConfig.tiny(), VAEConfig.tiny()
    pipe._init_random_weights()
    return pipe


def int8_tp_worker(rank: int, inputs: dict, out_dir: str) -> dict:
    """int8 serving at model = 2: the cut serving trees (the whole tree
    quantized then cut, and each node quantized then cut as it is made),
    the W8A8 row product, the TP FLUX forward in both int8 modes with the
    adapters attached, the TP SD3 forward and the SR stage in W8A8, the
    serving-tree cache written and read on the mesh, and the TP T5."""
    from unitex_torch.models.flux.config import FluxConfig
    from unitex_torch.models.flux.lora import attach_lora
    from unitex_torch.models.flux.model import flux_forward, tp_config
    from unitex_torch.models.flux.quantize import quantize_flux_params, quantize_hook
    from unitex_torch.models.sd3 import model as sd3
    from unitex_torch.models.sd3.config import SD3Config
    from unitex_torch.models.text import t5_encoder_forward
    from unitex_torch.ops.quant import int8_matmul, int8_row_matmul, quantize_linears
    from unitex_torch.parallel.sharding import (
        shard_flux_params, shard_hook, shard_sd3_params, shard_t5_params,
        shard_tree)

    mesh = _mesh(data=1, model=2)
    group, m = mesh.group("model"), mesh.index("model")
    flux, lora = unflatten(inputs, "flux"), unflatten(inputs, "lora")
    cfg = tp_config(FluxConfig.tiny(), group)
    out = {}
    for name, mode in INT8_MODES.items():
        wo = mode == "max_memory"
        cut = shard_flux_params(quantize_flux_params(
            flux, weight_only_rest=wo), mesh)
        made = shard_tree(unflatten(inputs, "flux"),
                          quantize_hook(mode, shard_hook(mesh)))
        out.update(_prefixed(f"{name}/cut", cut))
        out.update(_prefixed(f"{name}/made", made))
        served = attach_lora(cut, [(shard_flux_params(lora, mesh), 1.0)])
        out[f"{name}/forward"] = flux_forward(
            served, cfg, *_flux_args(inputs)).numpy()

    # the W8A8 row product: this rank's half of each row and kernel row
    x, q, scale = (torch.from_numpy(inputs[f"row/{k}"]) for k in ("x", "q", "scale"))
    k = x.shape[-1] // 2
    xr, qr = x[..., m * k:(m + 1) * k], q[m * k:(m + 1) * k]
    out["row/tp"] = int8_row_matmul([xr], [qr], scale, group).numpy()
    local = int8_row_matmul([xr], [qr], scale)   # this rank's own amax
    dist.all_reduce(local, group=group)
    out["row/local_amax"] = local.numpy()
    out["row/one_device"] = int8_matmul(x, q, scale).numpy()

    sd3_tree = unflatten(inputs, "sd3")
    out["sd3"] = sd3.sd3_forward(
        shard_sd3_params(quantize_linears(sd3_tree), mesh),
        tp_config(SD3Config.tiny(), group), *_sd3_args(inputs)).numpy()
    out["sr"] = _sr_stage(inputs, mesh, int8_serving=True).numpy()
    try:
        _sr_stage(inputs, mesh, int8_serving=True, host_params=True)
    except NotImplementedError as e:
        out["host_params_refused"] = np.array(str(e))

    for name, (mode, int4) in CACHE_CASES.items():
        d = os.path.join(str(inputs["cache_dir"]), name)
        first, second = (cache_pipeline(d, mode, int4, mesh) for _ in range(2))
        out.update(_prefixed(f"cache/{name}/built", first.transformer_params))
        out.update(_prefixed(f"cache/{name}/read", second.transformer_params))

    t5 = shard_t5_params(unflatten(inputs, "t5"), mesh)
    out["t5"] = t5_encoder_forward(t5, t5_config(),
                                   torch.from_numpy(inputs["t5_ids"]),
                                   group=group).numpy()
    return out


# ------------------------------------------------ serving across ranks


def _tiny_pipe(inputs: dict, **kw):
    """The tiny pipeline of :func:`pipeline_config` with the tiny FLUX,
    VAE and adapters (``int8_serving``: the FLUX tree quantized whole
    first), across the running process group."""
    from unitex_torch.models.flux.config import FluxConfig
    from unitex_torch.models.flux.quantize import quantize_flux_params
    from unitex_torch.models.flux.vae import VAEConfig
    from unitex_torch.pipeline import CustomRGBTextureFullPipeline

    pipe = CustomRGBTextureFullPipeline(config=pipeline_config(), seed=63,
                                        device="cpu", **kw)
    pipe.flux_cfg, pipe.vae_cfg = FluxConfig.tiny(), VAEConfig.tiny()
    flux = unflatten(inputs, "flux")
    if pipe.int8_serving:
        flux = quantize_flux_params(
            flux, weight_only_rest=pipe.int8_serving == "max_memory")
    pipe.set_flux_trees(flux, unflatten(inputs, "vae"),
                        unflatten(inputs, "lora"), unflatten(inputs, "lora2"))
    return pipe


def http_jobs(base: str, bodies: list, timeout: float = 100.0) -> list:
    """POST each job to the server at ``base``, one after the other, each
    awaited to its end; the job records."""
    import json
    import urllib.request

    def call(url, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(url, data=data, headers={
            "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())

    recs = []
    for body in bodies:
        job_id = call(base + "/jobs", body)["id"]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            rec = call(f"{base}/jobs/{job_id}")
            if rec["status"] in ("done", "failed"):
                break
            time.sleep(0.05)
        recs.append(rec)
    return recs


def serve_mesh_worker(rank: int, inputs: dict, out_dir: str) -> dict:
    """Serving on two ranks: the HTTP server on rank 0 (prewarm, then a
    job, a job whose mesh file does not parse, a job) while rank 1
    follows; ``batch_pipeline.main`` with ``--keep-going`` over the same
    three jobs; one W8A8 job."""
    import json
    import threading

    from unitex_torch.geometry.io.mesh_io import load_mesh
    from unitex_torch.scripts import batch_pipeline as bp
    from unitex_torch.serving import serve

    out = {}
    good, bad = ({"image_path": str(inputs["image_path"]),
                  "mesh_path": str(inputs[k])} for k in ("mesh_path", "bad_mesh"))
    pipe = _tiny_pipe(inputs)
    if rank == 0:
        httpd = serve(pipe, os.path.join(out_dir, "serve"), port=0,
                      prefetch=False, prewarm=True)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        recs = http_jobs(base, [good, bad, good])
        httpd.jobs.stop()
        httpd.shutdown()
        httpd.server_close()
        out["statuses"] = np.array([r["status"] for r in recs])
        out["bad_error"] = np.array(recs[1].get("error", ""))
        out["prewarm"] = np.array(sorted(httpd.jobs.prewarm_timings or {}))
        for i in (0, 2):
            glb = httpd.jobs.jobs[recs[i]["id"]]["result"]
            out[f"texture{i}"] = load_mesh(glb).texture
    else:
        out["followed"] = np.array(pipe.follow())

    jobs = os.path.join(out_dir, "jobs.jsonl")
    if rank == 0:
        with open(jobs, "w") as f:
            for name, body in (("a", good), ("broken", bad), ("b", good)):
                f.write(json.dumps({"name": name, "image": body["image_path"],
                                    "mesh": body["mesh_path"]}) + "\n")
    dist.barrier()
    batch_out = os.path.join(out_dir, "batch")
    bp.build_config = lambda small, fast_steps=0: pipeline_config()
    bp.main([jobs, "--out", batch_out, "--keep-going", "--no-prefetch",
             "--device", "cpu"])
    if rank == 0:
        with open(os.path.join(batch_out, "manifest.json")) as f:
            out["batch_errors"] = np.array(["error" in r for r in json.load(f)])

    int8 = _tiny_pipe(inputs, int8_serving=True)
    _, glb = int8(os.path.join(out_dir, "int8"), str(inputs["image_path"]),
                  str(inputs["mesh_path"]))
    if glb is not None:
        int8.flush_io()
        out["texture_int8"] = int8.last_texture.numpy()
    return out
