"""The job server, ``prewarm``, ``batch_pipeline`` and an int8 job on a
mesh of two gloo ranks on the CPU, against the same jobs on one rank.

One spawn of two ranks (``tests/torch_dist_workers.serve_mesh_worker``)
serves the module, with the tiny pipeline at 32² views (the tiny FLUX,
VAE and adapters, FLUX two-way tensor parallel):

* rank 0 serves HTTP (``prewarm=True``, ``prefetch=False``, so each job's
  preprocessing runs inside the job the followers are in) and rank 1
  follows (the pipeline's ``follow()``): a job, a job whose mesh file
  does not parse, a job.  The broken job fails on rank 0, the ranks leave it in
  step and the next job succeeds; nothing hangs (the spawn's deadline);
* the served GLBs' textures at 50 dB or more against the same job on one
  rank (run here while the ranks run), the bound of
  tests/test_torch_sp.py;
* ``batch_pipeline.main`` on both ranks with ``--keep-going`` over the
  same three jobs: the broken one recorded as failed, the others written;
* one ``int8_serving=True`` job across the ranks (W8A8 slices of the
  whole quantized tree) at 50 dB or more against the job on one rank.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from unitex_torch.geometry.io.mesh_io import load_mesh, save_mesh
from unitex_torch.geometry.primitives import make_icosphere

import torch_dist_workers as workers
from test_torch_parallel import _adapters, make_inputs
from torch_cpu_share import share_cpu

share_cpu()

MIN_PSNR = 50.0


def _psnr(got, want) -> float:
    mse = float(np.mean((np.asarray(got, np.float64)
                         - np.asarray(want, np.float64)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-20))


def _inputs(d) -> dict:
    from unitex_torch.models.flux.vae import VAEConfig, init_vae_params

    inputs = make_inputs()
    flux = workers.unflatten(inputs, "flux")
    inputs.update(workers._prefixed("lora2", _adapters(flux, 7)))
    inputs.update(workers._prefixed("vae", init_vae_params(
        torch.Generator().manual_seed(5), VAEConfig.tiny(), device="cpu")))
    mesh_path, img_path, bad = str(d / "input.glb"), str(d / "image.png"), \
        str(d / "broken.obj")
    save_mesh(mesh_path, make_icosphere(3))
    img = np.full((256, 256, 3), 255, np.uint8)
    img[64:192, 64:192] = [200, 60, 30]
    Image.fromarray(img).save(img_path)
    with open(bad, "w") as f:
        f.write("v 0 0\nf 1 2 x\n")
    inputs["mesh_path"], inputs["image_path"] = np.array(mesh_path), np.array(img_path)
    inputs["bad_mesh"] = np.array(bad)
    return inputs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results and the one-rank jobs (run here meanwhile)."""
    d = tmp_path_factory.mktemp("serve_mesh")
    inputs = _inputs(d)
    spawned = workers.spawn("serve_mesh_worker", 2, str(d / "ranks"), inputs)
    refs = {}
    for name, kw in (("bf16", {}), ("int8", {"int8_serving": True})):
        pipe = workers._tiny_pipe(inputs, **kw)
        _, glb = pipe(str(d / f"one_{name}"), str(inputs["image_path"]),
                      str(inputs["mesh_path"]))
        pipe.flush_io()
        refs[name] = (load_mesh(glb).texture, pipe.last_texture.numpy())
    return spawned.join(), refs


def test_http_jobs_on_the_mesh_outlive_a_failing_job(run):
    """The broken job fails on rank 0 with the mesh reader's error, and
    the job after it is done; rank 1 followed the prewarm and all three
    jobs, and was released by ``stop()``."""
    ranks, _ = run
    assert list(ranks[0]["statuses"]) == ["done", "failed", "done"]
    assert "invalid literal" in str(ranks[0]["bad_error"])
    assert int(ranks[1]["followed"]) == 4


def test_prewarm_runs_on_the_mesh(run):
    ranks, _ = run
    assert {"host_preprocess", "render_geometry", "infer_mv",
            "reproject"} <= set(ranks[0]["prewarm"])


@pytest.mark.parametrize("i", [0, 2], ids=["first", "after_the_failure"])
def test_served_textures_match_one_rank(run, i):
    ranks, refs = run
    got = ranks[0][f"texture{i}"].astype(np.float64) / 255.0
    want = refs["bf16"][0].astype(np.float64) / 255.0
    assert got.shape == want.shape
    assert _psnr(got, want) >= MIN_PSNR


def test_batch_script_on_two_ranks_keeps_going(run):
    ranks, _ = run
    assert list(ranks[0]["batch_errors"]) == [False, True, False]


def test_int8_job_across_ranks_matches_one_rank(run):
    ranks, refs = run
    got, want = ranks[0]["texture_int8"], refs["int8"][1]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _psnr(got, want) >= MIN_PSNR
    assert "texture_int8" not in ranks[1]


@pytest.mark.parametrize("where", ["host_side", "inside_the_denoise"])
def test_a_failure_ends_the_job_or_the_process(tmp_path, monkeypatch, where):
    """Rank 0 of a one-rank gloo mesh: a failure at a host-side point
    (the mesh file does not parse) is sent to the other ranks
    (``end_job``) and raised; a failure inside the denoise, a collective
    section, ends the process with status 1 before any message is sent
    (``os._exit``, recorded here instead)."""
    import os

    import torch.distributed as dist

    from unitex_torch import pipeline as tpipe
    from unitex_torch.parallel import mesh as tmesh

    class Exited(BaseException):
        pass

    events = []

    def exit_(code):
        events.append(("exit", code))
        raise Exited

    end_job = tpipe.end_job

    def record_end(error=None):
        events.append(("end", type(error).__name__))
        end_job(error)

    def boom(*args, **kwargs):
        raise RuntimeError("the denoise failed")

    monkeypatch.setattr(os, "_exit", exit_)
    monkeypatch.setattr(tpipe, "end_job", record_end)
    monkeypatch.setattr(tpipe, "flux_denoise", boom)
    inputs = _inputs(tmp_path)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    mesh = tmesh.make_mesh(data=1, model=1, device="cpu", store=store, rank=0,
                           world_size=1)
    try:
        pipe = workers._tiny_pipe(inputs, mesh=mesh)
        host_side = where == "host_side"
        mesh_path = str(inputs["bad_mesh" if host_side else "mesh_path"])
        with pytest.raises(ValueError if host_side else Exited):
            pipe(str(tmp_path / "job"), str(inputs["image_path"]), mesh_path)
    finally:
        dist.destroy_process_group()
    assert events[0] == (("end", "ValueError") if host_side else ("exit", 1))
    assert len(events) == (1 if host_side else 2)


def test_rank_0s_abort_passes_a_collective_section(monkeypatch):
    """A follower's part of a job is one collective section: its own
    failure ends the process, but rank 0's ``JobAborted`` is raised."""
    import os

    from unitex_torch.parallel.mesh import JobAborted, collective_section

    exits = []
    monkeypatch.setattr(os, "_exit", exits.append)
    with pytest.raises(JobAborted):
        with collective_section():
            raise JobAborted("ValueError: the bake failed")
    assert exits == []
