"""Sequence parallelism and multi-rank serving of the port against the JAX
package and against one rank, across gloo ranks on the CPU.

Two spawns serve the module, started together: four ranks
(``tests/torch_dist_workers.sp_worker``) and two
(``pipeline_worker``):

* ``flux_forward_sp``: Ulysses and ring at n = 4, Ulysses at n = 2 (the two
  seq pairs of data 2 x seq 2), SP x TP on seq 2 x model 2, each against
  the JAX package's ``flux_forward_sp`` on the same layout of the virtual
  CPU devices; ``sd3_forward_sp`` at n = 4 against JAX's;
* the TSD-SR stage on data 2 x model 2 (SD3 two-way tensor parallel, the
  tile batches split in two) against the JAX ``TSDSRPipeline``;
* the texturing pipeline at world 2 (the pipeline builds its own mesh
  from the running group, as under ``torchrun``: FLUX two-way tensor
  parallel), with the tiny FLUX, VAE and adapters and weightless, against
  the same job on one rank (run here in the parent while the ranks run).

Tolerances: the forwards and the SR image within 1e-5 of max|ref| (f32,
other summation orders); the pipeline's texture at world 2 to at least
50 dB PSNR of its texture on one rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from PIL import Image

from unitex_tpu.geometry.io.mesh_io import save_mesh
from unitex_tpu.geometry.primitives import make_icosphere
from unitex_tpu.models.flux import model as jflux
from unitex_tpu.models.flux.config import FluxConfig as JFluxConfig
from unitex_tpu.models.flux.sp import flux_forward_sp as jax_flux_sp
from unitex_tpu.models.flux.vae import VAEConfig as JVAEConfig
from unitex_tpu.models.sd3 import model as jsd3
from unitex_tpu.models.sd3 import sr_pipeline as jsr
from unitex_tpu.models.sd3.config import SD3Config as JSD3Config
from unitex_tpu.parallel.sharding import flux_param_shardings, shard_params

from unitex_torch.models.flux.config import FluxConfig
from unitex_torch.models.flux.model import flux_forward
from unitex_torch.models.flux.vae import VAEConfig, init_vae_params

import torch_dist_workers as workers
from test_torch_parallel import (
    FLUX_ARGS,
    SD3_ARGS,
    _adapters,
    _jax_args,
    _nested,
    make_inputs,
)
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

REL = 1e-5          # forwards and the SR image, of max|ref|
MIN_PSNR = 50.0     # the pipeline's texture at world 2 against one rank
SP_CASES = {"ulysses4": (4, "ulysses"), "ring4": (4, "ring"),
            "ulysses2": (2, "ulysses")}


def _close(got, want, rel=REL):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


def _assets(d):
    mesh_path = str(d / "input.glb")
    save_mesh(mesh_path, make_icosphere(3))
    img = np.full((256, 256, 3), 255, np.uint8)
    img[64:192, 64:192] = [200, 60, 30]
    img_path = str(d / "image.png")
    Image.fromarray(img).save(img_path)
    return mesh_path, img_path


def _sp_inputs(d) -> dict:
    inputs = make_inputs()
    gen = torch.Generator().manual_seed(5)
    flux = workers.unflatten(inputs, "flux")
    inputs.update(workers._prefixed("lora2", _adapters(flux, 7)))
    inputs.update(workers._prefixed(
        "vae", init_vae_params(gen, VAEConfig.tiny(), device="cpu")))
    inputs.update(workers._prefixed(
        "sd3vae", init_vae_params(gen, VAEConfig.tiny(), device="cpu")))
    inputs["sr_image"] = np.random.default_rng(9).uniform(
        size=(20, 24, 3)).astype(np.float32)
    mesh_path, img_path = _assets(d)
    inputs["mesh_path"], inputs["image_path"] = np.array(mesh_path), np.array(img_path)
    return inputs


def _jax_references(inputs) -> dict:
    flux, cfg = _nested(inputs, "flux"), JFluxConfig.tiny()
    args = _jax_args(inputs, "x", FLUX_ARGS)
    refs = {}
    for name, (n, mode) in SP_CASES.items():
        mesh = JMesh(np.asarray(jax.devices()[:n]), ("seq",))
        refs[name] = np.asarray(jit_reference(
            lambda p, *a, mesh=mesh, mode=mode: jax_flux_sp(
                p, cfg, *a, mesh=mesh, seq_axis="seq", sp_mode=mode))(
                    flux, *args))
    mesh = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("seq", "model"))
    placed = shard_params(flux, flux_param_shardings(flux, mesh))
    refs["sp_tp"] = np.asarray(jit_reference(
        lambda p, *a: jax_flux_sp(p, cfg, *a, mesh=mesh, seq_axis="seq",
                                  tp_axis="model"))(placed, *args))
    mesh = JMesh(np.asarray(jax.devices()[:4]), ("seq",))
    refs["sd3_sp"] = np.asarray(jit_reference(
        lambda p, *a: jsd3.sd3_forward_sp(p, JSD3Config.tiny(), *a, mesh=mesh,
                                          seq_axis="seq"))(
            _nested(inputs, "sd3"), *_jax_args(inputs, "sd3x", SD3_ARGS)))
    sr = jsr.TSDSRPipeline(None, cfg=jsr.TSDSRConfig(**workers.SR_KW),
                           sd3_cfg=JSD3Config.tiny(),
                           transformer_params=_nested(inputs, "sd3"),
                           vae_params=_nested(inputs, "sd3vae"))
    sr.vae_cfg = JVAEConfig.tiny()
    refs["sr"] = np.asarray(sr(jnp.asarray(inputs["sr_image"])))
    return refs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results, the JAX references and the one-rank pipeline
    jobs (the last two computed here while the ranks run)."""
    d = tmp_path_factory.mktemp("sp")
    inputs = _sp_inputs(d)
    spawned = workers.spawn("sp_worker", 4, str(d / "ranks"), inputs)
    jobs = workers.spawn("pipeline_worker", 2, str(d / "jobs"), inputs)
    refs = _jax_references(inputs)
    for name in ("tiny", "weightless"):
        refs[f"texture_{name}"] = workers._pipeline_job(
            inputs, str(d / "one_rank"), name)
    ranks = spawned.join()
    for r, res in enumerate(jobs.join()):
        ranks[r].update(res)
    return ranks, inputs, refs


@pytest.mark.parametrize("name", list(SP_CASES))
def test_flux_forward_sp_matches_jax(run, name):
    ranks, _, refs = run
    for res in ranks:
        _close(res[name], refs[name])


def test_flux_forward_sp_with_tp_matches_jax(run):
    """SP x TP on seq 2 x model 2: each rank holds its model slices and its
    sequence blocks; against JAX's ``flux_forward_sp(tp_axis="model")`` on
    params placed by ``flux_param_shardings``."""
    ranks, _, refs = run
    for res in ranks:
        _close(res["sp_tp"], refs["sp_tp"])


def test_sd3_forward_sp_matches_jax(run):
    ranks, _, refs = run
    for res in ranks:
        _close(res["sd3_sp"], refs["sd3_sp"])


def test_kv_keep_idx_matches_jax_and_is_refused_under_sp(run):
    """The joint K/V subselection in the one-rank forward against JAX's;
    under sequence parallelism it indexes the whole sequence and is
    refused, as in the JAX package."""
    ranks, inputs, _ = run
    idx = np.array([0, 2, 3, 5, 8, 9, 13, 17, 20, 23], np.int32)
    want = np.asarray(jit_reference(jflux.flux_forward, static_argnums=1)(
        _nested(inputs, "flux"), JFluxConfig.tiny(),
        *_jax_args(inputs, "x", FLUX_ARGS), kv_keep_idx=jnp.asarray(idx)))
    got = flux_forward(workers.unflatten(inputs, "flux"), FluxConfig.tiny(),
                       *workers._flux_args(inputs),
                       kv_keep_idx=torch.from_numpy(idx).long())
    _close(got.numpy(), want)
    for res in ranks:
        assert "kv_keep_idx" in str(res["kv_refused"])


def test_sr_stage_data_parallel_matches_jax(run):
    """The TSD-SR stage on data 2 x model 2: every rank ends with the whole
    image, within 1e-5 of the JAX pipeline's."""
    ranks, _, refs = run
    for res in ranks:
        assert res["sr"].shape == (80, 96, 3)
        _close(res["sr"], refs["sr"])


@pytest.mark.parametrize("name", ["tiny", "weightless"])
def test_pipeline_across_ranks_matches_one_rank(run, name):
    """The texturing job on two ranks (rank 0 doing the host work, FLUX
    two-way tensor parallel) writes the texture the job writes on one
    rank, to at least 50 dB; only rank 0 returns one."""
    ranks, _, refs = run
    want = refs[f"texture_{name}"]
    got = ranks[0][f"texture_{name}"]
    assert got.shape == want.shape
    mse = float(np.mean((got - want) ** 2))
    psnr = 10 * np.log10(1.0 / max(mse, 1e-20))
    assert psnr >= MIN_PSNR, psnr
    assert all(f"texture_{name}" not in res for res in ranks[1:])
