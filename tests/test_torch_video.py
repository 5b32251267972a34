"""Orbit cameras, orbit frames and the video file in the port
(unitex_torch/camera/generator.py, render/video.py), and the product CLI
``python -m unitex_torch.run``, on the CPU.

Frames are held against the JAX package's on the same textured torus: the
two rasterizers may give a silhouette pixel another triangle (the 0.1 %
rule of tests/test_torch_render.py), and a texel lookup may round the
other way, so at least 99.9 % of the uint8 values must be within one
level (measured: all 49,152 equal, for both video types).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unitex_tpu.camera import generator as jgen
from unitex_tpu.geometry.io.mesh_io import save_mesh
from unitex_tpu.geometry.mesh import Mesh as JMesh
from unitex_tpu.geometry.primitives import make_icosphere, make_torus
from unitex_tpu.geometry.uv_atlas import unwrap_atlas
from unitex_tpu.render import video as jvideo

from unitex_torch import run
from unitex_torch.camera import generator as tgen
from unitex_torch.geometry.mesh import Mesh as TMesh
from unitex_torch.render import video as tvideo

from test_torch_pipeline import _port_config
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

CAM_ATOL = 1e-6
LEVEL_AGREE = 0.999   # share of uint8 values within one level of JAX's


@pytest.mark.parametrize("n,radius,height", [(121, 2.8, 0.0), (9, 2.8, 1.4),
                                             (4, 1.0, 0.0)])
def test_orbit_cameras_match_jax(n, radius, height):
    # one jitted program (eagerly the JAX side compiles each of its ops)
    want = jit_reference(lambda: jgen.generate_orbit_views_c2ws(
        n, radius=radius, height=height))()
    got = tgen.generate_orbit_views_c2ws(n, radius=radius, height=height,
                                         device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=CAM_ATOL)


@pytest.fixture(scope="module")
def torus():
    """The torus, UV-unwrapped, with a smooth seeded texture."""
    host = unwrap_atlas(make_torus(), size=64, gutter=1)
    host.vertices = host.vertices.astype(np.float32) * np.float32(0.9)
    yy, xx = np.mgrid[:64, :64] / 63.0
    phase = np.random.default_rng(0).uniform(0, 2 * np.pi, 3)
    host.texture = (127.5 + 100 * np.sin(
        4 * xx[..., None] + 3 * yy[..., None] + phase)).astype(np.uint8)
    return host


@pytest.mark.parametrize("video_type", ["rgb", "ccm"])
def test_render_orbit_frames_match_jax(torus, video_type):
    tex = torus.texture.astype(np.float32) / 255.0
    want = jvideo.render_orbit_frames(
        JMesh(*(jnp.asarray(x) for x in (torus.vertices, torus.faces, torus.uv,
                                         torus.faces_uv))),
        jnp.asarray(tex), n_frames=4, size=64, batch=2, video_type=video_type)
    got = tvideo.render_orbit_frames(
        TMesh(*(torch.from_numpy(np.asarray(x, dt)) for x, dt in (
            (torus.vertices, np.float32), (torus.faces, np.int64),
            (torus.uv, np.float32), (torus.faces_uv, np.int64)))),
        torch.from_numpy(tex), n_frames=4, size=64, batch=2,
        video_type=video_type)
    assert got.dtype == np.uint8 and got.shape == (4, 64, 64, 3)
    diff = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
    assert np.mean(diff <= 1) >= LEVEL_AGREE, np.mean(diff <= 1)
    assert (got < 250).any(axis=(1, 2, 3)).all()  # the torus in every frame


def test_export_orbit_video_writes_a_gif_without_ffmpeg(torus, tmp_path):
    """No imageio-ffmpeg here: the GIF, 1000 / fps ms a frame, with the
    orbit cameras beside it."""
    path = str(tmp_path / "m.glb")
    save_mesh(path, torus)
    out = tvideo.export_orbit_video(path, str(tmp_path / "orbit.mp4"),
                                    n_frames=4, size=64, fps=4,
                                    save_camera=True, device="cpu")
    assert out == str(tmp_path / "orbit.gif")
    with Image.open(out) as im:
        assert (im.n_frames, im.size, im.info["duration"]) == (4, (64, 64), 250)
    cam = np.load(str(tmp_path / "orbit_camera.npz"))
    np.testing.assert_allclose(
        cam["c2ws"], np.asarray(jgen.generate_orbit_views_c2ws(5, 2.8))[:4],
        rtol=0, atol=CAM_ATOL)
    assert cam["intrinsics"].shape == (3, 3) and bool(cam["perspective"])


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    d = tmp_path_factory.mktemp("job")
    mesh_path = str(d / "input.glb")
    save_mesh(mesh_path, make_icosphere(3))
    img = np.full((256, 256, 3), 255, np.uint8)
    img[64:192, 64:192] = [200, 60, 30]
    img_path = str(d / "image.png")
    Image.fromarray(img).save(img_path)
    return mesh_path, img_path


def test_cli_runs_weightless_on_the_cpu(job, tmp_path, monkeypatch, capsys):
    """``main`` with ``--device cpu`` and no weights on the small config:
    the GLB, the reference matte and a 4-frame 64² orbit video."""
    mesh_path, img_path = job
    monkeypatch.setattr(run, "DEFAULT_CONFIG", dataclasses.replace(
        _port_config(), orbit_frames=4, orbit_size=64))
    out = str(tmp_path / "out")
    run.main(["--image", img_path, "--mesh", mesh_path, "--out", out,
              "--device", "cpu"])
    for name in ("textured_mesh.glb", "rembg_image.png"):
        assert os.path.exists(os.path.join(out, name))
    with Image.open(os.path.join(out, "cache", "textured_mesh.gif")) as im:
        assert (im.n_frames, im.size) == (4, (64, 64))
    assert f"wrote {os.path.join(out, 'textured_mesh.glb')}" in capsys.readouterr().out


DEFAULTS = dict(pretrain_models=None, super_resolutions=False, seed=63,
                int8_serving=False, device="cuda")


@pytest.mark.parametrize("argv,kwargs,export_video,reuse", [
    ([], {}, True, 0),
    (["--int8", "--no-export-video"], {"int8_serving": True}, False, 0),
    (["--int8-max-memory"], {"int8_serving": "max_memory"}, True, 0),
    (["--fast-steps", "8", "--seed", "5", "--device", "cpu"],
     {"seed": 5, "device": "cpu"}, True, 8),
    (["--pretrain-models", "/m", "--super-resolution"],
     {"pretrain_models": "/m", "super_resolutions": True}, True, 0),
], ids=["defaults", "int8", "max_memory", "fast_steps", "weights_sr"])
def test_cli_flags_reach_the_pipeline(monkeypatch, argv, kwargs, export_video,
                                      reuse):
    seen = {}

    class Recorder:
        def __init__(self, **kw):
            seen["init"] = kw

        def __call__(self, out, image, mesh, export_video):
            seen["call"] = (out, image, mesh, export_video)
            return "r.png", "t.glb"

    monkeypatch.setattr(run, "CustomRGBTextureFullPipeline", Recorder)
    run.main(["--image", "i.png", "--mesh", "m.obj"] + argv)
    config = seen["init"].pop("config")
    assert seen["init"] == {**DEFAULTS, **kwargs}
    assert seen["call"] == ("output", "i.png", "m.obj", export_video)
    assert config.diffusion.velocity_reuse == reuse
    assert config.diffusion.num_inference_steps == 28
