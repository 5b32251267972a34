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
    arrays; ``None`` leaves are left out."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(flatten(v, path))
        elif v is not None:
            out[path] = v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
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


def _sr_stage(inputs: dict, mesh=None):
    """The tiny TSD-SR stage (tests/test_torch_sr.py's tiling, f32) on the
    input image, on ``mesh`` or on one rank."""
    from unitex_torch.models.flux.vae import VAEConfig
    from unitex_torch.models.sd3 import sr_pipeline as sr
    from unitex_torch.models.sd3.config import SD3Config

    pipe = sr.TSDSRPipeline(
        None, cfg=sr.TSDSRConfig(**SR_KW), sd3_cfg=SD3Config.tiny(),
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
