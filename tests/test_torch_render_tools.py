"""The renderer's tools (``render/renderer.py``: ``draw_point_cloud``,
``render_uv_attributes``, ``get_visible_faces``, ``get_visible_vertices``)
and the mesh viewer (``render/viewer.py``) in
the port against the JAX package, on the CPU.

The dot mask exact; the UV bakes within 1e-5 (positions interpolated in
f32 in other orders); visibility exact on every face and vertex but those
whose only pixels sit on a shared edge (the two rasterizers may give such
a pixel the other face: at most 0.5 % of the faces).  The viewer's frames
as ``test_torch_video.py`` holds rendered frames: at least 99.9 % of the
uint8 values within one level of the JAX viewer's.  Over local HTTP: the
page, ``/info``, a PNG of each mode, frames that move with the camera, a
400 for a bad mode and a 404."""

import importlib
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from unitex_tpu.geometry.io.mesh_io import save_mesh
from unitex_tpu.geometry.primitives import make_icosphere
from unitex_tpu.geometry.uv_atlas import unwrap_atlas

from unitex_torch.geometry.mesh import Mesh as TMesh
from unitex_torch.render import renderer as trender
from unitex_torch.render import viewer as tviewer
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

jrender = importlib.import_module("unitex_tpu.render.renderer")
jviewer = importlib.import_module("unitex_tpu.render.viewer")
jmesh = importlib.import_module("unitex_tpu.geometry.mesh")
jgen = importlib.import_module("unitex_tpu.camera.generator")

UV_ATOL = 1e-5
EDGE_SHARE = 0.005     # of the faces, visible in one package only
LEVEL_AGREE = 0.999    # uint8 values within one level
SIZE = 64


@pytest.fixture(scope="module")
def sphere():
    """An unwrapped icosphere with a smooth seeded texture."""
    host = unwrap_atlas(make_icosphere(3), size=64, gutter=1)
    host.vertices = host.vertices.astype(np.float32) * np.float32(0.8)
    yy, xx = np.mgrid[:64, :64] / 63.0
    phase = np.random.default_rng(0).uniform(0, 2 * np.pi, 3)
    host.texture = (127.5 + 100 * np.sin(
        5 * xx[..., None] + 3 * yy[..., None] + phase)).astype(np.uint8)
    return host


def _meshes(host):
    import jax.numpy as jnp

    j = jmesh.Mesh(jnp.asarray(host.vertices), jnp.asarray(host.faces),
                   uv=jnp.asarray(host.uv), faces_uv=jnp.asarray(host.faces_uv))
    t = TMesh(torch.from_numpy(host.vertices), torch.from_numpy(host.faces.astype(np.int64)),
              uv=torch.from_numpy(host.uv.astype(np.float32)),
              faces_uv=torch.from_numpy(host.faces_uv.astype(np.int64)))
    return j, t


def test_draw_point_cloud_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.2, 1.2, (400, 2)).astype(np.float32)
    valid = rng.random(400) > 0.3
    for mask in (None, valid):
        want = jrender.draw_point_cloud(jnp.asarray(pts), 24, 40,
                                        None if mask is None else jnp.asarray(mask))
        got = trender.draw_point_cloud(torch.from_numpy(pts), 24, 40,
                                       None if mask is None else torch.from_numpy(mask))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_render_uv_attributes_matches_jax(sphere):
    import jax.numpy as jnp

    j, t = _meshes(sphere)
    attr = np.random.default_rng(2).random((sphere.vertices.shape[0], 2)).astype(np.float32)
    want = jit_reference(jrender.render_uv_attributes, static_argnums=1,
                   static_argnames=("render_world_normal", "render_world_position"))(
        j, 48, jnp.asarray(attr), render_world_normal=True,
        render_world_position=True)
    got = trender.render_uv_attributes(t, 48, torch.from_numpy(attr),
                                       render_world_normal=True,
                                       render_world_position=True)
    assert set(got) == set(want) == {"mask", "v_attr", "world_position",
                                     "world_normal"}
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    for k in ("v_attr", "world_position", "world_normal"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=UV_ATOL)


def test_visible_faces_and_vertices_match_jax(sphere):
    import jax.numpy as jnp

    j, t = _meshes(sphere)
    c2w = np.asarray(jgen.generate_orbit_views_c2ws(4, radius=2.8, height=0.4))
    intr = np.asarray(jgen.generate_intrinsics(49.1, 49.1, fov=True, degree=True))
    for persp in (False, True):
        jf = np.asarray(jrender.get_visible_faces(j, jnp.asarray(c2w), jnp.asarray(intr),
                                                  (SIZE, SIZE), perspective=persp))
        tf = trender.get_visible_faces(t, torch.from_numpy(c2w), torch.from_numpy(intr),
                                       (SIZE, SIZE), perspective=persp).numpy()
        assert tf.shape == jf.shape and tf.any(1).all()
        assert (tf != jf).mean() <= EDGE_SHARE
        jv = np.asarray(jrender.get_visible_vertices(
            j, jnp.asarray(c2w), jnp.asarray(intr), (SIZE, SIZE), perspective=persp))
        tv = trender.get_visible_vertices(t, torch.from_numpy(c2w),
                                          torch.from_numpy(intr), (SIZE, SIZE),
                                          perspective=persp).numpy()
        assert tv.shape == jv.shape and (tv != jv).mean() <= EDGE_SHARE
        # a vertex is visible exactly when one of its faces is
        faces = sphere.faces
        for m in range(tv.shape[0]):
            want = np.zeros(tv.shape[1], bool)
            want[faces[tf[m]].reshape(-1)] = True
            np.testing.assert_array_equal(tv[m], want)


def _agree(a, b):
    return float((np.abs(a.astype(np.int16) - b.astype(np.int16)) <= 1).mean())


@pytest.fixture(scope="module")
def glb(sphere, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("viewer") / "sphere.glb")
    save_mesh(path, sphere)
    return path


@pytest.mark.parametrize("mode", ["rgb", "normal", "ccm", "alpha"])
def test_viewer_frames_match_jax(glb, mode):
    """``MeshViewer.render_frame`` of both packages from one pose, and the
    PNG of the port's frame is the encoding of the same array."""
    want = jviewer.MeshViewer(glb).render_frame(30.0, 20.0, 2.8, mode, SIZE)
    viewer = tviewer.MeshViewer(glb, device="cpu")
    got = viewer.render_frame(30.0, 20.0, 2.8, mode, SIZE)
    assert got.shape == want.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
    assert _agree(got, want) >= LEVEL_AGREE
    png = tviewer._encode_png(got)
    assert png == jviewer._encode_png(got)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), got)


def test_viewer_over_http(glb):
    """The server on the CPU, driven on a thread: the page, ``/info``, a
    PNG of each mode, frames that move with the camera, 400 and 404."""
    httpd = tviewer.serve(glb, port=0, poll=0.1, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read()

    try:
        status, ctype, page = get("/")
        assert status == 200 and ctype == "text/html" and page == jviewer._PAGE.encode()
        info = json.loads(get("/info")[2])
        assert info == {"n_vertices": int(np.asarray(
            tviewer.load_mesh(glb).vertices).shape[0]), "n_faces": 1280, "textured": True}
        frames = {}
        for mode in tviewer.MODES:
            status, ctype, body = get(f"/render?mode={mode}&az=10&el=15&size=64")
            assert status == 200 and ctype == "image/png"
            frames[mode] = np.asarray(Image.open(io.BytesIO(body)))
            assert frames[mode].shape == (64, 64, 3)
        assert (frames["rgb"] != 255).any()
        moved = np.asarray(Image.open(io.BytesIO(
            get("/render?mode=rgb&az=100&el=-30&size=64")[2])))
        assert (moved != frames["rgb"]).any()
        for path, code in (("/render?mode=depth", 400), ("/nothing", 404)):
            with pytest.raises(urllib.error.HTTPError) as err:
                get(path)
            assert err.value.code == code
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
