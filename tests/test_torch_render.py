"""Geometry conditioning in the port (unitex_torch camera, mesh, rasterizers,
renderer, conditioning) against the JAX package on the same numpy inputs,
f32 on the CPU.

Rasterizers decide ``tri`` at silhouette and shared-edge pixels by
edge-inclusion and depth-tie rules, where one ulp of difference in an edge
function flips a pixel.  The port computes its edge functions with XLA's
rounding, so on the shared-edge case the triangles agree at every pixel;
elsewhere the tests count how many pixels disagree (at most 0.1 %) and
compare barycentrics and depth only where ``tri`` agrees.
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
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

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
    """Box c2ws, intrinsics and mvp in exact f32.  The JAX side runs as
    one jitted program (eagerly it compiles each of its ops)."""

    @jit_reference
    def jax_side(c2ws):
        intr = [jgen.generate_intrinsics(0.9, 0.9, fov=p) for p in (False, True)]
        mvp = [jconv.get_mvp(c2ws, jnp.broadcast_to(i, (6, 3, 3)), perspective=p)
               for i, p in zip(intr, (False, True))]
        return (jgen.generate_box_views_c2ws(2.8), intr, mvp,
                jcond.condition_cameras()[0])

    c2ws_t = tgen.generate_box_views_c2ws(2.8, device="cpu")
    c2ws_j, intr_j, mvp_j, cond_j = jax_side(jnp.asarray(c2ws_t.numpy()))
    np.testing.assert_allclose(c2ws_t.numpy(), np.asarray(c2ws_j), atol=1e-6)
    for persp, ij, mj in zip((False, True), intr_j, mvp_j):
        intr_t = tgen.generate_intrinsics(0.9, 0.9, fov=persp, device="cpu")
        np.testing.assert_allclose(intr_t.numpy(), np.asarray(ij), atol=1e-7)
        mvp_t = tconv.get_mvp(c2ws_t, intr_t.expand(6, 3, 3),
                              perspective=persp)
        np.testing.assert_allclose(mvp_t.numpy(), np.asarray(mj),
                                   rtol=1e-6, atol=1e-6)
    c, _ = tcond.condition_cameras(device="cpu")
    np.testing.assert_allclose(c.numpy(), np.asarray(cond_j), atol=1e-6)


def test_mesh_normals_and_bucket_padding_match_jax(sphere):
    v, host = sphere
    f = host.faces.astype(np.int64)
    # the JAX normals as one jitted program (eagerly, one compile an op)
    fn_j, vn_j = jit_reference(lambda v, f: (jmesh.compute_face_normals(v, f),
                                       jmesh.compute_vertex_normals(v, f)))(
        jnp.asarray(v), jnp.asarray(f))
    np.testing.assert_allclose(
        tmesh.compute_face_normals(_t(v), _t(f)).numpy(), np.asarray(fn_j),
        atol=1e-6)
    np.testing.assert_allclose(
        tmesh.compute_vertex_normals(_t(v), _t(f)).numpy(), np.asarray(vn_j),
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


@pytest.mark.parametrize("route", ["brute", "binned"])
def test_rasterize_picks_jax_triangle_on_shared_edges(route):
    """The UV-unwrapped torus x 0.9 in the six 32² condition views puts
    pixel centres exactly on shared edges (barycentric 0 to 1e-17).  The
    port evaluates its edge functions as XLA's CPU backend does (an FMA
    with one rounded product), so every pixel takes the JAX package's
    triangle on both routes; with plain f32 products 20 of 6144 did not."""
    host = unwrap_atlas(make_torus(), size=128, gutter=2)
    v = host.vertices.astype(np.float32) * np.float32(0.9)
    faces = host.faces
    c2ws, intr = jcond.condition_cameras()
    mvp = jconv.get_mvp(c2ws, jnp.broadcast_to(intr, (6, 3, 3)))
    threshold = 0 if route == "brute" else 256
    assert route == "brute" or faces.shape[0] > threshold
    for view in range(6):
        clip = np.asarray(jconv.transform_points_mat4(jnp.asarray(v), mvp[view]))
        tr = trast.rasterize(_t(clip), _t(faces, torch.int64), (32, 32),
                             binned_threshold=threshold, tile_batch=2)
        jr = jrast.rasterize(jnp.asarray(clip), jnp.asarray(faces), (32, 32),
                             binned_threshold=threshold, tile_batch=2)
        np.testing.assert_array_equal(tr.tri.numpy(), np.asarray(jr.tri),
                                      err_msg=f"view {view}")
        assert (tr.tri.numpy() >= 0).mean() > 0.1  # the torus fills the view


def _soup(seed, n=300):
    """Random clip-space triangles: some behind the camera, some off
    screen, every 17th degenerate, vertices snapped to 1/8 of NDC (pixel
    centres on edges) for odd seeds."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(3 * n, 4)).astype(np.float32)
    v[:, 3] = rng.uniform(-0.3, 1.7, size=3 * n)
    v[:, 2] = np.clip(v[:, 2], -1.5, 1.5) * v[:, 3]
    if seed % 2:
        v[:, :2], v[:, 3] = np.round(v[:, :2] * 8) / 8, 1.0
    faces = np.arange(3 * n).reshape(n, 3)
    faces[::17, 2] = faces[::17, 1]
    return v, faces


@pytest.mark.parametrize("case", ["icosphere-ortho", "icosphere-persp",
                                  "torus-shared-edges", "uv", "soup0", "soup1"])
def test_cpu_pair_rasterizer_equals_the_band_rasterizer(sphere, case, monkeypatch):
    """The CPU's rasterizer (each face over its screen box) against the
    card's (all faces over bands of rows), both run here: the same
    triangle, barycentrics and depth for every pixel, bit for bit, with
    the pairs in one block and in blocks of 257 (a pixel's faces split
    across blocks)."""
    size = (37, 53)
    if case.startswith("icosphere"):
        v, faces = _clip(sphere[0], 1, perspective=case.endswith("persp")), sphere[1].faces
    elif case == "torus-shared-edges":
        host = unwrap_atlas(make_torus(), size=128, gutter=2)
        c2ws, intr = jcond.condition_cameras()
        mvp = jconv.get_mvp(c2ws, jnp.broadcast_to(intr, (6, 3, 3)))
        v = np.asarray(jconv.transform_points_mat4(
            jnp.asarray(host.vertices.astype(np.float32) * np.float32(0.9)), mvp[2]))
        faces, size = host.faces, (32, 32)
    elif case == "uv":
        uv = sphere[1].uv
        v = np.concatenate([uv * 2 - 1, np.zeros_like(uv[:, :1]),
                            np.ones_like(uv[:, :1])], -1).astype(np.float32)
        faces, size = sphere[1].faces_uv, (64, 64)
    else:
        v, faces = _soup(int(case[-1]))
    pix, z, w, valid = trast._triangle_setup(_t(v), _t(faces, torch.int64), *size)
    bands = trast._rasterize_bands(pix, z, w, valid, *size, face_chunk=64)
    assert (bands.tri >= 0).any()
    for block in (trast._PAIR_BLOCK, 257):
        monkeypatch.setattr(trast, "_PAIR_BLOCK", block)
        pairs = trast._rasterize_pairs(pix, z, w, valid, *size)
        for key in ("tri", "bary", "z"):
            got, want = getattr(pairs, key), getattr(bands, key)
            assert got.shape == want.shape and got.dtype == want.dtype
            if got.is_floating_point():
                got, want = got.view(torch.int32), want.view(torch.int32)
            assert torch.equal(got, want), (key, block)


def test_rasterize_uv_and_interpolate_match_jax(sphere):
    v, host = sphere
    tr = trast.rasterize_uv(_t(host.uv), _t(host.faces_uv, torch.int64), 128)
    jr = jrast.rasterize_uv(jnp.asarray(host.uv), jnp.asarray(host.faces_uv), 128)
    _assert_rast_close(tr, jr)
    # interpolate on one shared rast buffer (the JAX one), so it is
    # compared alone: the f32 blend of the three corners, background = fill
    shared = trast.Rast(_t(jr.bary), _t(jr.z), _t(jr.tri, torch.int64))
    got = trast.interpolate(_t(v), shared, _t(host.faces, torch.int64), fill=-1.0)
    want = jit_reference(lambda v, r, f: jrast.interpolate(v, r, f, fill=-1.0))(
        jnp.asarray(v), jr, jnp.asarray(host.faces))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert (np.asarray(jr.tri) < 0).any() and (np.asarray(jr.tri) >= 0).mean() > 0.3


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample_matches_jax(padding):
    """The bake's view sampling (zero padding) and the renderer's texture
    sampling (border padding), align_corners=False, with taps off the
    image."""
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(12, 20, 4)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(7, 9, 2)).astype(np.float32)
    got = tgs.grid_sample(_t(img), _t(grid), padding_mode=padding)
    want = jgs.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                           padding_mode=padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_render_uv_and_map_attr_match_jax(sphere):
    """UV buffer and a texture sampled through it (v flipped, border
    padding), where ``tri`` agrees; uv_render takes ``pixel_tile``."""
    from unitex_tpu.render.renderer import render_views as jrender
    from unitex_tpu.render.renderer_inverse import uv_render as juv_render

    from unitex_torch.render.renderer_inverse import uv_render as tuv_render

    v, host = sphere
    jm = jmesh.Mesh(jnp.asarray(v), jnp.asarray(host.faces),
                    uv=jnp.asarray(host.uv), faces_uv=jnp.asarray(host.faces_uv))
    tm = tmesh.Mesh(_t(v), _t(host.faces, torch.int64), uv=_t(host.uv),
                    faces_uv=_t(host.faces_uv, torch.int64))
    tex = np.random.default_rng(6).uniform(size=(24, 40, 3)).astype(np.float32)
    c2ws, intr = jcond.condition_cameras()
    kw = dict(render_uv=True, render_map_attr=True)
    want = jrender(jm, c2ws, intr, (32, 32), map_attr=jnp.asarray(tex), **kw)
    got = tcond.render_views(tm, _t(c2ws), _t(intr), (32, 32),
                             map_attr=_t(tex), **kw)
    agree = got.tri.numpy() == np.asarray(want.tri)
    assert agree.mean() >= TRI_AGREE and got.mask.numpy().mean() > 0.3
    for key in ("uv", "map_attr"):
        np.testing.assert_allclose(getattr(got, key).numpy()[agree],
                                   np.asarray(getattr(want, key))[agree],
                                   atol=1e-5)
    t_uv = tuv_render(tm, 64, pixel_tile=0)
    j_uv = juv_render(jm, 64, pixel_tile=0)
    assert (t_uv["mask"].numpy() == np.asarray(j_uv["mask"])).mean() >= TRI_AGREE


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


RENDER_FLAGS = ("world_normal", "camera_normal", "world_position", "z_depth",
                "camera_position", "distance", "ray_direction",
                "cos_ray_normal", "v_attr", "uv")


@pytest.fixture(scope="module")
def all_buffers(sphere):
    """Every ``render_views`` buffer of the sphere in both packages, plain
    (ortho) and 2x2 supersampled (perspective), with a per-vertex
    attribute."""
    from unitex_tpu.render.renderer import render_views as jrender

    v, host = sphere
    jm = jmesh.Mesh(jnp.asarray(v), jnp.asarray(host.faces),
                    uv=jnp.asarray(host.uv), faces_uv=jnp.asarray(host.faces_uv))
    tm = tmesh.Mesh(_t(v), _t(host.faces, torch.int64), uv=_t(host.uv),
                    faces_uv=_t(host.faces_uv, torch.int64))
    attr = np.random.default_rng(9).uniform(size=(v.shape[0], 2)).astype(np.float32)
    c2ws, intr = jcond.condition_cameras()
    kw = {f"render_{k}": True for k in RENDER_FLAGS}
    out = {}
    for name, extra in (("plain", {}),
                        ("supersample", {"supersample": 2, "perspective": True})):
        want = jrender(jm, c2ws, intr, (24, 32), v_attr=jnp.asarray(attr),
                       **kw, **extra)
        got = tcond.render_views(tm, _t(c2ws), _t(intr), (24, 32),
                                 v_attr=_t(attr), **kw, **extra)
        out[name] = (got, want)
    return out


@pytest.mark.parametrize("mode", ["plain", "supersample"])
@pytest.mark.parametrize("key", RENDER_FLAGS + ("alpha",))
def test_render_views_buffers_match_jax(all_buffers, mode, key):
    """Each buffer where the pixel's triangle agrees (every sample of it,
    supersampled: the top-left triangle is kept, so a pixel is compared
    where the alpha, the samples' mean coverage, agrees too)."""
    got, want = all_buffers[mode]
    agree = got.tri.numpy() == np.asarray(want.tri)
    agree &= (got.alpha.numpy() == np.asarray(want.alpha))[..., 0]
    assert agree.mean() >= TRI_AGREE and got.mask.numpy().mean() > 0.2
    g, w = getattr(got, key).numpy(), np.asarray(getattr(want, key))
    assert g.shape == w.shape and g.shape[:3] == (6, 24, 32)
    np.testing.assert_allclose(g[agree], w[agree], atol=2e-5)
    if mode == "supersample":
        # a 2x2 box mean: coverage takes the values 0, 1/4, ... 1
        assert set(np.unique(got.alpha.numpy()) * 4) <= {0.0, 1.0, 2.0, 3.0, 4.0}


@pytest.mark.parametrize("row_chunk", [16, 48])
def test_render_row_chunk_gives_the_unchunked_result(sphere, row_chunk):
    """The low-memory serving mode's ``row_chunk`` (and small
    ``tile_batch``) computes the per-pixel buffers in row slabs where the
    chunk divides H (16 of 64), whole otherwise (48): the same buffers."""
    v, host = sphere
    mesh = tmesh.Mesh(_t(v), _t(host.faces, torch.int64))
    want = tcond.render_geometry_condition(mesh, view_size=64)
    got = tcond.render_geometry_condition(mesh, view_size=64,
                                          row_chunk=row_chunk, tile_batch=8)
    for key in ("alpha", "ccm", "normal"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
