"""Unified RGB / PBR renders (``render/unify.py``), multi-object scenes
(``render/scene.py``) and the texture-check export
(``render/video.py:export_turntable``, ``render_height_sweep_frames``) in
the port against the JAX package, on the CPU.

Cameras within 1e-6.  Frames as ``test_torch_video.py`` holds the orbit:
the two rasterizers may give a silhouette pixel another triangle, so at
least 99.9 % of the uint8 values within one level; the float scene
buffers the same way (object ids exact on 99.9 % of the pixels, colours
within 1e-5 there).  The PNG grid of the turntable is the JAX package's
file byte for byte.  No imageio-ffmpeg here, so the height sweep's video
is a GIF in both packages: its frames are compared, not its bytes (the
JAX package writes it through imageio, the port through PIL, as its
orbit video)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unitex_tpu.geometry.io.mesh_io import save_mesh
from unitex_tpu.geometry.mesh import Mesh as JMesh
from unitex_tpu.geometry.primitives import make_icosphere, make_torus
from unitex_tpu.geometry.uv_atlas import unwrap_atlas
from unitex_tpu.render import scene as jscene
from unitex_tpu.render import unify as junify
from unitex_tpu.render import video as jvideo

from unitex_torch.geometry.mesh import Mesh as TMesh
from unitex_torch.render import scene as tscene
from unitex_torch.render import unify as tunify
from unitex_torch.render import video as tvideo
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

CAM_ATOL = 1e-6
LEVEL_AGREE = 0.999
SIZE = 48


@pytest.fixture(scope="module")
def torus():
    """The torus, UV-unwrapped, with a smooth seeded albedo and a
    metallic-roughness map."""
    host = unwrap_atlas(make_torus(), size=64, gutter=1)
    host.vertices = host.vertices.astype(np.float32) * np.float32(0.9)
    yy, xx = np.mgrid[:64, :64] / 63.0
    phase = np.random.default_rng(0).uniform(0, 2 * np.pi, 3)
    host.texture = (127.5 + 100 * np.sin(
        4 * xx[..., None] + 3 * yy[..., None] + phase)).astype(np.uint8)
    host.metallic_roughness = np.stack(
        [np.full_like(xx, 255), 40 + 200 * yy, 255 * xx], -1).astype(np.uint8)
    return host


def _close_frames(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
    assert np.mean(diff <= 1) >= LEVEL_AGREE, np.mean(diff <= 1)


def test_cameras_match_jax():
    for make in ("generate_cameras_v1", "generate_cameras_v2"):
        for persp in (True, False):
            want = jit_reference(lambda: getattr(junify, make)(6, persp))()
            got = getattr(tunify, make)(6, persp, device="cpu")
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                           atol=CAM_ATOL)


@pytest.mark.parametrize("cameras,persp", [("v1", True), ("v2", False)])
def test_unified_rgb_render_matches_jax(torus, cameras, persp):
    want = junify.unified_rgb_render(torus, n_frames=3, size=SIZE,
                                     perspective=persp, cameras=cameras)
    got = tunify.unified_rgb_render(torus, n_frames=3, size=SIZE,
                                    perspective=persp, cameras=cameras,
                                    device="cpu")
    _close_frames(got, want)
    assert (got < 250).any(axis=(1, 2, 3)).all()


@pytest.mark.parametrize("bsdf,cameras", [("lambert", "v1"), ("frostbite", "v2")])
def test_unified_pbr_render_matches_jax(torus, bsdf, cameras):
    kw = dict(n_frames=3, size=SIZE, cameras=cameras, bsdf=bsdf,
              lambda_specular=2.0, lambda_albedo=(1.0, 0.8, 0.6))
    want = junify.unified_pbr_render(torus, **kw)
    got = tunify.unified_pbr_render(torus, device="cpu", **kw)
    assert sorted(got) == ["diffuse", "rgb", "specular"]
    for k in got:
        _close_frames(got[k], want[k])
    # the BSDF's specular strength is the map's first channel, 1 here, so
    # the specular frames are black in both packages
    assert got["diffuse"].max() > 0 and want["specular"].max() == 0


def test_render_scene_matches_jax(torus):
    """A textured torus and an untextured, moved icosphere in one pass."""
    ico = make_icosphere(2)
    move = np.eye(4, dtype=np.float32)
    move[:3, 3] = [0.0, 0.0, 0.9]
    move[:3, :3] *= 0.4
    tex = torus.texture.astype(np.float32) / 255.0
    arrays = [(torus.vertices, torus.faces, torus.uv, torus.faces_uv),
              (ico.vertices.astype(np.float32), ico.faces, None, None)]

    def objects(pkg):
        Mesh, put, Obj = ((JMesh, jnp.asarray, jscene.SceneObject) if pkg == "jax"
                          else (TMesh, torch.from_numpy, tscene.SceneObject))

        def arr(x, dt):
            return None if x is None else put(np.ascontiguousarray(x, dt))

        it = np.int32 if pkg == "jax" else np.int64
        return [Obj(Mesh(arr(v, np.float32), arr(f, it), uv=arr(uv, np.float32),
                         faces_uv=arr(fuv, it)),
                    texture=arr(tex, np.float32) if uv is not None else None,
                    transform=None if uv is not None else arr(move, np.float32),
                    base_color=(0.2, 0.6, 0.3))
                for v, f, uv, fuv in arrays]

    c2ws, intr = junify.generate_cameras_v1(2, True)
    want = jscene.render_scene(objects("jax"), c2ws, intr, (SIZE, SIZE))
    got = tscene.render_scene(objects("torch"), torch.from_numpy(np.asarray(c2ws)),
                              torch.from_numpy(np.asarray(intr)), (SIZE, SIZE))
    ids, wid = got["object_id"].numpy(), np.asarray(want["object_id"])
    same = ids == wid
    assert same.mean() >= LEVEL_AGREE and {0, 1} <= set(np.unique(ids))
    for k in ("rgb", "alpha", "normal"):
        np.testing.assert_allclose(got[k].numpy()[same], np.asarray(want[k])[same],
                                   rtol=0, atol=1e-5, err_msg=k)


def test_export_turntable_writes_jax_png_grid(torus, tmp_path):
    """5 frames in a 3 x 2 grid padded with white: the same file."""
    mesh_path = str(tmp_path / "m.glb")
    save_mesh(mesh_path, torus)
    want = jvideo.export_turntable(mesh_path, str(tmp_path / "jax.png"),
                                   n_frames=5, size=32)
    got = tvideo.export_turntable(mesh_path, str(tmp_path / "port.png"),
                                  n_frames=5, size=32, device="cpu")
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    with Image.open(got) as im:
        assert im.size == (3 * 32, 2 * 32)


def test_height_sweep_frames_and_gif(torus, tmp_path):
    """Three orbits of 3 frames at three heights; the export's GIF holds
    all 9."""
    tex = torus.texture.astype(np.float32) / 255.0
    want = jvideo.render_height_sweep_frames(
        JMesh(*(jnp.asarray(x) for x in (torus.vertices, torus.faces, torus.uv,
                                         torus.faces_uv))),
        jnp.asarray(tex), n_frames=9, size=32)
    got = tvideo.render_height_sweep_frames(
        TMesh(*(torch.from_numpy(np.asarray(x, dt)) for x, dt in (
            (torus.vertices, np.float32), (torus.faces, np.int64),
            (torus.uv, np.float32), (torus.faces_uv, np.int64)))),
        torch.from_numpy(tex), n_frames=9, size=32)
    _close_frames(got, want)
    mesh_path = str(tmp_path / "m.glb")
    save_mesh(mesh_path, torus)
    out = tvideo.export_turntable(mesh_path, str(tmp_path / "sweep.mp4"),
                                  n_frames=9, size=32, fps=5,
                                  height_sweep=True, device="cpu")
    assert os.path.basename(out) == "sweep.gif"
    with Image.open(out) as im:
        assert (im.n_frames, im.size, im.info["duration"]) == (9, (32, 32), 200)
    with pytest.raises(ValueError, match="format"):
        tvideo.export_turntable(mesh_path, str(tmp_path / "x.bmp"), device="cpu")
