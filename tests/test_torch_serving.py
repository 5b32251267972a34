"""The port's job server (``unitex_torch/serving.py``), ``async_io`` and the
batch and serve scripts (``unitex_torch/scripts/{batch,serve}_pipeline.py``)
on the CPU, with the weightless tiny pipeline of tests/test_serving.py
at 32² views (128² atlas, no FLUX weights): jobs over the real HTTP surface
by path and base64, the listing, 404, 409 and 400, prewarm, the GLB that
``async_io`` writes, and the windowed batch loop's phase order with
stubs (as tests/test_serving.py holds the JAX package's)."""

import base64
import contextlib
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from unitex_torch.config import BakeConfig, CameraConfig, MeshConfig, PipelineConfig
from unitex_torch.geometry.io.mesh_io import save_mesh
from unitex_torch.geometry.primitives import make_icosphere
from unitex_torch.pipeline import CustomRGBTextureFullPipeline
from unitex_torch.scripts import batch_pipeline as bp
from unitex_torch.serving import TextureJobServer, serve
from torch_cpu_share import share_cpu

share_cpu()

CONFIG = PipelineConfig(
    camera=CameraConfig(view_size=32),
    mesh=MeshConfig(min_faces=500, max_faces=4000, uv_size=128),
    bake=BakeConfig(uv_size=128),
)


def _pipe(**kw):
    return CustomRGBTextureFullPipeline(pretrain_models=None, seed=63,
                                        config=CONFIG, device="cpu", **kw)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_assets")
    mesh_path = str(d / "input.glb")
    save_mesh(mesh_path, make_icosphere(3))
    img = np.full((128, 128, 3), 255, np.uint8)
    img[32:96, 32:96] = [40, 90, 200]
    img_path = str(d / "image.png")
    Image.fromarray(img).save(img_path)
    return mesh_path, img_path


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """The HTTP server over an ``async_io`` pipeline: a job is done only
    once its files are written."""
    httpd = serve(_pipe(async_io=True), str(tmp_path_factory.mktemp("work")),
                  port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.jobs.stop()
    httpd.shutdown()
    httpd.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.read()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _wait(base, job_id, timeout_s=300):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        rec = json.loads(_get(f"{base}/jobs/{job_id}")[1])
        if rec["status"] in ("done", "failed"):
            return rec
        time.sleep(0.2)
    raise TimeoutError(f"job {job_id} did not finish")


def test_healthz(server):
    status, body = _get(server + "/healthz")
    assert status == 200 and json.loads(body) == {"ok": True, "queue_depth": 0}


def test_path_and_base64_jobs(server, assets):
    """One job by server-local paths and one with both files inlined as
    base64, submitted together: both done, each GLB and matte served."""
    mesh_path, img_path = assets
    with open(mesh_path, "rb") as f:
        mesh_b64 = base64.b64encode(f.read()).decode()
    with open(img_path, "rb") as f:
        img_b64 = base64.b64encode(f.read()).decode()
    status, by_path = _post(server + "/jobs", {"image_path": img_path,
                                               "mesh_path": mesh_path,
                                               "name": "tex1"})
    assert status == 202 and by_path["status"] == "queued"
    _, inline = _post(server + "/jobs", {"image_b64": img_b64,
                                         "mesh_b64": mesh_b64,
                                         "mesh_ext": ".glb"})
    for resp, name in ((by_path, "tex1"), (inline, inline["id"])):
        rec = _wait(server, resp["id"])
        assert rec["status"] == "done", rec.get("error")
        assert rec["name"] == name
        assert rec["device_s"] > 0 and rec["preprocess_s"] > 0
        status, glb = _get(f"{server}/jobs/{resp['id']}/result")
        assert status == 200 and glb[:4] == b"glTF"
        status, png = _get(f"{server}/jobs/{resp['id']}/rembg")
        assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
    listing = json.loads(_get(server + "/jobs")[1])
    assert {by_path["id"], inline["id"]} <= {r["id"] for r in listing}
    assert all("out_dir" not in r for r in listing)


def test_unknown_job_and_artifact_404(server):
    for path in ("/jobs/deadbeef", "/jobs/deadbeef/result", "/nowhere"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server + path)
        assert e.value.code == 404


def test_failed_job_result_409(server, assets):
    _, img_path = assets
    _, resp = _post(server + "/jobs", {"image_path": img_path,
                                       "mesh_path": "/nonexistent.glb"})
    rec = _wait(server, resp["id"])
    assert rec["status"] == "failed" and rec["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{server}/jobs/{resp['id']}/result")
    assert e.value.code == 409


@pytest.mark.parametrize("payload", [{"mesh_ext": ".exe", "mesh_b64": ""},
                                     {"image_path": "x.png"}])
def test_bad_request_400(server, payload):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/jobs", payload)
    assert e.value.code == 400


def test_prewarm_then_job(assets, tmp_path):
    """``prewarm=True`` runs every stage once on the device thread before
    the first job and records the JAX package's breakdown."""
    mesh_path, img_path = assets
    srv = TextureJobServer(_pipe(), str(tmp_path), prewarm=True)
    jid = srv.submit(img_path, mesh_path)
    for _ in range(1500):
        rec = srv.public_record(jid)
        if rec["status"] in ("done", "failed"):
            break
        time.sleep(0.2)
    srv.stop()
    assert rec["status"] == "done", rec
    assert set(srv.prewarm_timings) == {
        "host_preprocess", "render_geometry", "infer_mv", "reproject"}


def test_async_io_writes_the_same_glb(assets, tmp_path):
    """The writer thread writes the GLB ``async_io=False`` writes, and its
    copy and the cache's removal keep their order behind it."""
    mesh_path, img_path = assets
    glbs = []
    for async_io in (False, True):
        pipe = _pipe(async_io=async_io)
        out = str(tmp_path / f"async_{async_io}")
        _, glb = pipe(out, img_path, mesh_path, clear_cache=True)
        pipe.flush_io()
        assert not os.path.exists(os.path.join(out, "cache"))
        with open(glb, "rb") as f:
            glbs.append(f.read())
    assert glbs[0][:4] == b"glTF" and glbs[0] == glbs[1]


def test_flush_io_raises_the_first_failure(tmp_path):
    pipe = _pipe(async_io=True)
    done = []
    pipe._submit_io(done.append, 1)
    pipe._submit_io(open, str(tmp_path / "missing" / "x"))
    pipe._submit_io(done.append, 2)
    with pytest.raises(FileNotFoundError):
        pipe.flush_io()
    assert done == [1, 2]
    pipe.flush_io()   # nothing left pending


def test_matting_on_the_card_runs_on_the_device_thread(tmp_path):
    """Where the matting model sits on a device, the preprocess thread
    does only the mesh and the device thread mattes the image."""
    threads = {}

    class Stub:
        rembg = types.SimpleNamespace(device=torch.device("meta"))

        def _submit_io(self, fn, *args):
            fn(*args)

        def preprocess_blank_mesh_stage(self, cache, mesh):
            threads["mesh"] = threading.current_thread().name
            return "mesh"

        def preprocess_reference_image_stage(self, cache, image):
            threads["image"] = threading.current_thread().name
            return "ref"

        def __call__(self, out_dir, image, mesh, export_video, preprocessed):
            threads["job"] = threading.current_thread().name
            assert preprocessed == ("mesh", "ref")
            glb = os.path.join(out_dir, "textured_mesh.glb")
            open(glb, "wb").close()
            return os.path.join(out_dir, "rembg_image.png"), glb

    srv = TextureJobServer(Stub(), str(tmp_path))
    jid = srv.submit("i.png", "m.obj")
    for _ in range(100):
        if srv.public_record(jid)["status"] in ("done", "failed"):
            break
        time.sleep(0.05)
    srv.stop()
    assert srv.public_record(jid)["status"] == "done"
    assert threads["image"] == threads["job"] != threads["mesh"]


def test_batch_script_keeps_going(assets, tmp_path, monkeypatch):
    """``python -m unitex_torch.scripts.batch_pipeline`` on two jobs, one
    of them broken, with prefetch and the writer thread (``--small``'s
    config cut to this file's)."""
    monkeypatch.setattr(bp, "build_config", lambda small, fast_steps=0: CONFIG)
    mesh_path, img_path = assets
    jobs = tmp_path / "jobs.jsonl"
    jobs.write_text(
        json.dumps({"name": "good", "image": img_path, "mesh": mesh_path})
        + "\n" + json.dumps({"name": "bad", "image": img_path,
                             "mesh": str(tmp_path / "missing.obj")}) + "\n")
    out = str(tmp_path / "out")
    bp.main([str(jobs), "--out", out, "--small", "--keep-going",
             "--no-artifacts", "--device", "cpu"])
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = {r["name"]: r for r in json.load(f)}
    assert os.path.exists(manifest["good"]["glb"]) and "error" in manifest["bad"]


def test_windowed_batch_phase_order(tmp_path):
    """``_run_windowed`` (``--sr-window``): each window denoises all its
    jobs first, runs every grid's SR inside one ``staged()`` window, then
    bakes each job."""
    events = []

    class StubSR:
        def __init__(self):
            self.windows = 0
            self.inside = 0

        @contextlib.contextmanager
        def staged(self):
            self.windows += 1
            events.append("stage_in")
            yield
            events.append("stage_out")

    class StubPipe:
        def __init__(self):
            self.sr_pipeline = StubSR()

        def preprocess_job(self, out_dir, image, mesh):
            events.append(("pre", os.path.basename(image)))
            return ("mesh:" + image, "img:" + image)

        def render_geometry_images_stage(self, cache, pm):
            events.append(("geo", pm))
            return {"mesh": pm, "c2ws": 0, "intrinsics": 0}

        def infer_mv_stage(self, cache, img, cond, apply_sr=True):
            assert apply_sr is False
            events.append(("mv", img))
            return np.zeros((4, 6, 3), np.float32)

        def _apply_sr(self, mv, save_dir=None):
            self.sr_pipeline.inside += 1
            events.append("sr")
            return mv

        def reproject_stage(self, cache, mesh, mv, cond, pm):
            events.append(("bake", pm))
            p = os.path.join(cache, "textured_mesh.glb")
            open(p, "wb").write(b"x")
            open(os.path.join(cache, "rembg_image.png"), "wb").write(b"x")
            return p

        def _submit_io(self, fn, *a):
            fn(*a)

    jobs = [{"name": f"j{i}", "image": f"{i}.png", "mesh": f"{i}.obj"}
            for i in range(4)]
    args = types.SimpleNamespace(out=str(tmp_path), sr_window=2,
                                 keep_going=False, no_artifacts=True)
    pipe = StubPipe()
    results = []
    bp._run_windowed(args, pipe, jobs, None, None, None, results)
    assert pipe.sr_pipeline.windows == 2 and pipe.sr_pipeline.inside == 4
    assert len([r for r in results if "glb" in r]) == 4
    order = [e if isinstance(e, str) else e[0] for e in events]
    per_window = ["pre", "geo", "mv", "pre", "geo", "mv",
                  "stage_in", "sr", "sr", "stage_out", "bake", "bake"]
    assert order == per_window * 2


def test_scripts_take_the_root_scripts_flags():
    from unitex_torch.scripts import serve_pipeline as sp

    a = bp.parse_args(["jobs", "--sr-window", "3", "--sync-io", "--int8",
                       "--fast-steps", "8"])
    assert (a.sr_window, a.sync_io, a.int8, a.fast_steps, a.device) == (
        3, True, True, 8, "cuda")
    cfg = bp.build_config(True, 8)
    assert cfg.camera.view_size == 64 and cfg.diffusion.velocity_reuse == 8
    s = sp.parse_args(["--port", "0", "--prewarm", "--int8-max-memory"])
    assert (s.port, s.prewarm, s.int8, s.device) == (0, True, "max_memory",
                                                     "cuda")
