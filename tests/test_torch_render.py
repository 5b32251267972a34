"""Geometry conditioning in the port (unitex_torch camera, mesh, rasterizers,
renderer, conditioning) against the JAX package on the same numpy inputs,
f32 on the CPU.

Rasterizers decide ``tri`` at silhouette and shared-edge pixels by
edge-inclusion and depth-tie rules, where one ulp of difference in an edge
function flips a pixel; so the tests count how many pixels disagree
(at most 0.1 %) and compare barycentrics and depth only where ``tri``
agrees.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitex_tpu.camera import conversion as jconv
from unitex_tpu.camera import generator as jgen
from unitex_tpu.geometry import mesh as jmesh
from unitex_tpu.geometry.primitives import make_icosphere, make_torus
from unitex_tpu.geometry.uv_atlas import unwrap_atlas
from unitex_tpu.render import conditioning as jcond

from unitex_torch.camera import conversion as tconv
from unitex_torch.camera import generator as tgen
from unitex_torch.geometry import mesh as tmesh
from unitex_torch.ops import grid_sample as tgs
from unitex_torch.ops import rasterize as trast
from unitex_torch.render import conditioning as tcond

# the JAX package's ops/__init__ re-exports the function under the module's
# name, so the module is taken from the import system
jrast = importlib.import_module("unitex_tpu.ops.rasterize")
jgs = importlib.import_module("unitex_tpu.ops.grid_sample")

TRI_AGREE = 0.999   # share of pixels whose triangle id must match
BARY_ATOL = 1e-5    # f32 edge functions, same formula, other op order
Z_ATOL = 1e-5


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))  # a writable copy
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def sphere():
    m = unwrap_atlas(make_icosphere(3), size=128, gutter=2)
    return m.vertices.astype(np.float32) * np.float32(0.9), m


def _clip(vertices, view, perspective=False):
    """Clip-space vertices of box view ``view``, made by the JAX package."""
    c2ws = jgen.generate_box_views_c2ws(2.8)
    intr = jgen.generate_intrinsics(1.0, 1.0, fov=False)
    mvp = jconv.get_mvp(c2ws[view][None], intr[None], perspective=perspective)[0]
    return np.asarray(jconv.transform_points_mat4(jnp.asarray(vertices), mvp))


def _assert_rast_close(tr, jr):
    tt, jt = tr.tri.numpy(), np.asarray(jr.tri)
    agree = tt == jt
    assert agree.mean() >= TRI_AGREE, f"tri agreement {agree.mean():.5f}"
    np.testing.assert_allclose(tr.bary.numpy()[agree], np.asarray(jr.bary)[agree],
                               atol=BARY_ATOL)
    np.testing.assert_allclose(tr.z.numpy()[agree], np.asarray(jr.z)[agree],
                               atol=Z_ATOL)
    return agree


def test_cameras_and_mvp_match_jax():
    """Box c2ws, intrinsics and mvp in exact f32."""
    c2ws_t = tgen.generate_box_views_c2ws(2.8, device="cpu")
    c2ws_j = np.asarray(jgen.generate_box_views_c2ws(2.8))
    np.testing.assert_allclose(c2ws_t.numpy(), c2ws_j, atol=1e-6)
    for persp in (False, True):
        intr_t = tgen.generate_intrinsics(0.9, 0.9, fov=persp, device="cpu")
        intr_j = jgen.generate_intrinsics(0.9, 0.9, fov=persp)
        np.testing.assert_allclose(intr_t.numpy(), np.asarray(intr_j), atol=1e-7)
        mvp_t = tconv.get_mvp(_t(c2ws_j), intr_t.expand(6, 3, 3),
                              perspective=persp)
        mvp_j = jconv.get_mvp(jnp.asarray(c2ws_j),
                              jnp.broadcast_to(intr_j, (6, 3, 3)),
                              perspective=persp)
        np.testing.assert_allclose(mvp_t.numpy(), np.asarray(mvp_j),
                                   rtol=1e-6, atol=1e-6)
    c, _ = tcond.condition_cameras(device="cpu")
    np.testing.assert_allclose(c.numpy(), np.asarray(jcond.condition_cameras()[0]),
                               atol=1e-6)


def test_mesh_normals_and_bucket_padding_match_jax(sphere):
    v, host = sphere
    f = host.faces.astype(np.int64)
    np.testing.assert_allclose(
        tmesh.compute_face_normals(_t(v), _t(f)).numpy(),
        np.asarray(jmesh.compute_face_normals(jnp.asarray(v), jnp.asarray(f))),
        atol=1e-6)
    np.testing.assert_allclose(
        tmesh.compute_vertex_normals(_t(v), _t(f)).numpy(),
        np.asarray(jmesh.compute_vertex_normals(jnp.asarray(v), jnp.asarray(f))),
        atol=1e-5)
    tm = tmesh.pad_mesh_to_bucket(tmesh.Mesh(
        _t(v), _t(f), uv=_t(host.uv), faces_uv=_t(host.faces_uv, torch.int64)), 2048)
    jm = jmesh.pad_mesh_to_bucket(jmesh.Mesh(
        jnp.asarray(v), jnp.asarray(f), uv=jnp.asarray(host.uv),
        faces_uv=jnp.asarray(host.faces_uv)), 2048)
    for name in ("vertices", "faces", "uv", "faces_uv"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)), err_msg=name)


@pytest.mark.parametrize("route,maker,view", [
    ("brute", "icosphere", 0), ("brute", "torus", 1),
    ("binned", "icosphere", 4), ("binned", "torus", 2),
])
def test_rasterize_matches_jax(sphere, route, maker, view):
    """Both routes of ``rasterize``: the binned one is taken above
    ``binned_threshold`` faces, with the same bin capacity rule."""
    if maker == "icosphere":
        v, faces = sphere[0], sphere[1].faces
    else:
        m = make_torus()
        v, faces = m.vertices.astype(np.float32) * np.float32(0.9), m.faces
    clip = _clip(v, view)
    threshold = 0 if route == "brute" else 256
    assert route == "brute" or faces.shape[0] > threshold
    tr = trast.rasterize(_t(clip), _t(faces, torch.int64), (64, 96),
                         binned_threshold=threshold, tile_batch=2)
    jr = jrast.rasterize(jnp.asarray(clip), jnp.asarray(faces), (64, 96),
                         binned_threshold=threshold, tile_batch=2)
    _assert_rast_close(tr, jr)
    assert (tr.tri.numpy() >= 0).mean() > 0.2


def test_rasterize_uv_and_interpolate_match_jax(sphere):
    v, host = sphere
    tr = trast.rasterize_uv(_t(host.uv), _t(host.faces_uv, torch.int64), 128)
    jr = jrast.rasterize_uv(jnp.asarray(host.uv), jnp.asarray(host.faces_uv), 128)
    _assert_rast_close(tr, jr)
    # interpolate on one shared rast buffer (the JAX one), so it is
    # compared alone: the f32 blend of the three corners, background = fill
    shared = trast.Rast(_t(jr.bary), _t(jr.z), _t(jr.tri, torch.int64))
    got = trast.interpolate(_t(v), shared, _t(host.faces, torch.int64), fill=-1.0)
    want = jrast.interpolate(jnp.asarray(v), jr, jnp.asarray(host.faces), fill=-1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert (np.asarray(jr.tri) < 0).any() and (np.asarray(jr.tri) >= 0).mean() > 0.3


def test_grid_sample_matches_jax():
    """The bake's view sampling: zero padding, align_corners=False, with
    taps off the image."""
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(12, 20, 4)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(7, 9, 2)).astype(np.float32)
    got = tgs.grid_sample(_t(img), _t(grid))
    want = jgs.grid_sample(jnp.asarray(img), jnp.asarray(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_render_geometry_condition_matches_jax(sphere):
    v, host = sphere
    f = host.faces
    tout = tcond.render_geometry_condition(
        tmesh.Mesh(_t(v), _t(f, torch.int64)), view_size=64)
    jout = jcond.render_geometry_condition(
        jmesh.Mesh(jnp.asarray(v), jnp.asarray(f)), view_size=64)
    for key in ("c2ws", "intrinsics"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   atol=1e-6)
    ta, ja = tout["alpha"].numpy(), np.asarray(jout["alpha"])
    agree = (ta == ja)[..., 0]
    assert ta.shape == ja.shape == (128, 192, 1)
    assert agree.mean() >= TRI_AGREE, f"alpha agreement {agree.mean():.5f}"
    for key in ("ccm", "normal"):
        np.testing.assert_allclose(tout[key].numpy()[agree],
                                   np.asarray(jout[key])[agree], atol=1e-5)


def test_grid_strip_permutations_match_jax():
    rng = np.random.default_rng(0)
    grid = rng.uniform(size=(2 * 8, 3 * 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(tcond.grid_to_strip(_t(grid)).numpy(),
                                  np.asarray(jcond.grid_to_strip(jnp.asarray(grid))))
    strip = rng.uniform(size=(8, 6 * 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(tcond.strip_to_grid(_t(strip)).numpy(),
                                  np.asarray(jcond.strip_to_grid(jnp.asarray(strip))))
    views = rng.uniform(size=(6, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tcond.views_to_grid(_t(views)).numpy(),
        np.asarray(jcond.views_to_grid(jnp.asarray(views))))
    np.testing.assert_array_equal(
        tcond.grid_to_views(_t(grid)).numpy(),
        np.asarray(jcond.grid_to_views(jnp.asarray(grid))))


@pytest.mark.parametrize("kwargs", [
    {"render_z_depth": True}, {"supersample": 2}, {"v_attr": torch.zeros(3, 2)},
])
def test_unported_render_options_raise(kwargs):
    mesh = tmesh.Mesh(torch.rand(3, 3), torch.tensor([[0, 1, 2]]))
    c2ws, intr = tcond.condition_cameras(device="cpu")
    with pytest.raises(NotImplementedError):
        tcond.render_views(mesh, c2ws, intr, (8, 8), **kwargs)
    # the options' off values and the memory knob are accepted
    tcond.render_views(mesh, c2ws, intr, (8, 8), supersample=1, pixel_tile=64,
                       render_uv=False)
