"""Geometry sampling, closest point on a mesh and texture remapping in the
port (``unitex_torch/geometry/sampling.py``, ``ops/closest_point.py``,
``texture/remapping.py``) against the JAX package's, on the CPU.

The host samplers are numpy in both packages and must give the same
arrays bit for bit.  The closest-point search is f32 on both sides: the
distances are held to 1e-5 (absolute, on a unit sphere), the barycentrics
to 1e-4, and every face the JAX package picks must be the port's or one
as near (within 1e-6).  The remap's texture is held to 1e-3 (colours in
[0, 1]): the UV raster is bit-equal, but both KNNs take the distance as
|q|² + |r|² - 2 q·r in f32, whose cancellation near a sample leaves up
to 0.7 % between the packages' distances (their products sum in other
orders), and the inverse-distance weights carry that into the colours.
JAX references run jitted, each compiled once for the module.
"""

import importlib

import numpy as np
import pytest
import torch

import jax

from unitex_tpu.geometry import primitives as jprim
from unitex_tpu.geometry import sampling as jsamp
from unitex_tpu.texture import remapping as jremap

from unitex_torch.geometry import primitives as tprim
from unitex_torch.geometry import sampling as tsamp
from unitex_torch.ops import closest_point as tcp
from unitex_torch.texture import remapping as tremap
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

jcp = importlib.import_module("unitex_tpu.ops.closest_point")

DIST_TOL, UVW_TOL, TEX_TOL = 1e-5, 1e-4, 1e-3
# small chunks for the JAX exact scan (its default pads 300 points to
# 8192 x 2048 pairs); the port takes the same
CHUNKS = {"chunk": 128, "face_chunk": 64}


def _meshes(name):
    make = {"cube": lambda m: m.make_cube(),
            "torus": lambda m: m.make_torus(n_major=24, n_minor=12),
            "icosphere": lambda m: m.make_icosphere(2)}[name]
    jm, tm = make(jprim), make(tprim)
    np.testing.assert_array_equal(jm.vertices, tm.vertices)
    np.testing.assert_array_equal(jm.faces, tm.faces)
    return jm, tm


@pytest.mark.parametrize("name", ["cube", "torus", "icosphere"])
def test_surface_and_edge_samples_equal_jax(name):
    """``sample_surface``, ``sample_surface_with_faces``,
    ``find_sharp_edges`` and ``sample_sharp_edges``: the same arrays."""
    jm, tm = _meshes(name)
    for a, b in zip(jsamp.sample_surface(jm, 500, seed=3),
                    tsamp.sample_surface(tm, 500, seed=3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jsamp.sample_surface_with_faces(jm, 500, seed=4),
                    tsamp.sample_surface_with_faces(tm, 500, seed=4)):
        np.testing.assert_array_equal(a, b)
    edges = tsamp.find_sharp_edges(tm, 15.0)
    np.testing.assert_array_equal(jsamp.find_sharp_edges(jm, 15.0), edges)
    for a, b in zip(jsamp.sample_sharp_edges(jm, 400, 15.0, seed=5),
                    tsamp.sample_sharp_edges(tm, 400, 15.0, seed=5)):
        np.testing.assert_array_equal(a, b)
    if name == "cube":
        assert len(edges) == 12


def test_geometry_sampling_equals_jax():
    """The surface + sharp-edge sampling with FPS and the time cap: the
    same dict of arrays (the native FPS of each package)."""
    jm, tm = _meshes("cube")
    want = jsamp.geometry_sampling(jm, n_samples=2000, n_fps=256, seed=1)
    got = tsamp.geometry_sampling(tm, n_samples=2000, n_fps=256, seed=1)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["surface_points"].shape == (256, 3)
    assert got["sharp_points"].shape == (256, 3)


def test_timeout_caps_the_main_thread_only():
    import threading
    import time

    from unitex_torch.utils.timer import timeout

    @timeout(0.05)
    def slow():
        time.sleep(2.0)
        return "done"

    with pytest.raises(TimeoutError, match="slow exceeded"):
        slow()
    box = []
    th = threading.Thread(target=lambda: box.append(timeout(0.01)(
        lambda: (time.sleep(0.05), "off main")[1])()))
    th.start()
    th.join(timeout=5)
    assert not th.is_alive() and box == ["off main"]


def test_sample_pbr_mesh_matches_jax(monkeypatch):
    """All three attribute forms: an albedo map read through the UV
    layer, a metallic vertex table and a roughness constant.  The samples
    and their faces are the same arrays; the attributes within 1e-6.  The
    JAX lookup runs jitted (eagerly it compiles each of its ops)."""
    import unitex_tpu.geometry.mesh as jmesh
    from unitex_tpu.geometry.mesh import PBRMesh as JPBRMesh
    from unitex_torch.geometry.mesh import PBRMesh as TPBRMesh

    monkeypatch.setattr(jmesh, "sample_pbr_attribute",
                        jit_reference(jmesh.sample_pbr_attribute))

    jm, _ = _meshes("icosphere")
    rng = np.random.default_rng(4)
    v = jm.vertices.astype(np.float32)
    uv = np.stack([np.arctan2(v[:, 1], v[:, 0]) / (2 * np.pi) + 0.5,
                   v[:, 2] * 0.5 + 0.5], axis=-1).astype(np.float32)
    arrays = dict(vertices=v, faces=jm.faces.astype(np.int32), uv=uv,
                  faces_uv=jm.faces.astype(np.int32),
                  albedo=rng.uniform(0, 1, (16, 16, 3)).astype(np.float32),
                  metallic=rng.uniform(0, 1, (len(v), 1)).astype(np.float32),
                  roughness=np.asarray([0.4], np.float32))
    want = jsamp.sample_pbr_mesh(
        JPBRMesh(**{k: jax.numpy.asarray(a) for k, a in arrays.items()}),
        n_samples=400, seed=3)
    got = tsamp.sample_pbr_mesh(
        TPBRMesh(**{k: torch.from_numpy(a.astype(np.int64) if k.startswith(
            "faces") else a) for k, a in arrays.items()}), n_samples=400, seed=3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert sorted(got[2]) == sorted(want[2]) == ["albedo", "metallic",
                                                 "roughness"]
    for name, w in want[2].items():
        assert tuple(got[2][name].shape) == w.shape
        np.testing.assert_allclose(got[2][name].numpy(), np.asarray(w),
                                   rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def sphere_points():
    """icosphere(2) (320 faces) and 300 points around it, inside and out."""
    jm, tm = _meshes("icosphere")
    rng = np.random.default_rng(0)
    d = rng.normal(size=(300, 3))
    pts = (d / np.linalg.norm(d, axis=1, keepdims=True)
           * rng.uniform(0.5, 1.5, (300, 1))).astype(np.float32)
    return tm.vertices.astype(np.float32), tm.faces.astype(np.int32), pts


def _port_cp(pts, v, f, **kw):
    cp = tcp.closest_point_on_mesh(torch.from_numpy(pts), torch.from_numpy(v),
                                   torch.from_numpy(f.astype(np.int64)), **kw)
    return [x.numpy() for x in cp]


@pytest.mark.parametrize("exact", [False, True], ids=["candidates", "exact"])
def test_closest_point_on_mesh_matches_jax(sphere_points, exact):
    v, f, pts = sphere_points
    kw = CHUNKS if exact else {}
    want = [np.asarray(x) for x in jcp.closest_point_on_mesh(
        pts, v, f, exact=exact, **kw)]
    got = _port_cp(pts, v, f, exact=exact, **kw)
    np.testing.assert_allclose(got[0], want[0], atol=DIST_TOL, rtol=0)
    same = got[1] == want[1]
    # a differing pick must be a tie: the JAX face is as near to the point
    _, d_alt = tcp.closest_point_triangle(
        torch.from_numpy(pts[~same]), *(torch.from_numpy(v[f[want[1][~same]]][:, i])
                                        for i in range(3)))
    np.testing.assert_allclose(np.sqrt(d_alt.numpy()), got[0][~same], atol=1e-6)
    np.testing.assert_allclose(got[2][same], want[2][same], atol=UVW_TOL)
    np.testing.assert_allclose(got[3], want[3], atol=DIST_TOL)
    # and the numpy reference (f64, brute force)
    d_ref, _, _ = tcp.closest_point_on_mesh_ref(pts, v, f)
    np.testing.assert_allclose(got[0], d_ref, atol=DIST_TOL)


def test_closest_point_triangle_matches_jax():
    """Every Voronoi region of the cascade: points spread far around
    random triangles."""
    rng = np.random.default_rng(1)
    tri = rng.normal(size=(4000, 3, 3)).astype(np.float32)
    p = (rng.normal(size=(4000, 3)) * 3).astype(np.float32)
    want = jit_reference(jcp.closest_point_triangle)(p, tri[:, 0], tri[:, 1], tri[:, 2])
    got = tcp.closest_point_triangle(*(torch.from_numpy(x) for x in
                                       (p, tri[:, 0], tri[:, 1], tri[:, 2])))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fn", ["sample_spatial", "sample_near_surface"])
def test_spatial_samplers_match_jax(sphere_points, fn):
    """The host draws are equal; the device re-projection picks the same
    faces (ties aside) with barycentrics within 1e-4."""
    jm, tm = _meshes("icosphere")
    want = getattr(jsamp, fn)(jm, n_samples=300, seed=7)
    got = getattr(tsamp, fn)(tm, n_samples=300, seed=7, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    same = got[1] == want[1]
    assert same.mean() > 0.95
    np.testing.assert_allclose(got[2][same], want[2][same], atol=UVW_TOL)


def _textured(mod, prim):
    """A UV-unwrapped torus with a seeded 64² texture and vertex colours."""
    from dataclasses import replace

    uv_atlas = importlib.import_module(f"{mod}.geometry.uv_atlas")
    m = uv_atlas.unwrap_atlas(prim.make_torus(n_major=24, n_minor=12), size=64)
    rng = np.random.default_rng(2)
    return replace(m, texture=rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
                   vertex_colors=rng.uniform(size=(m.n_vertices, 3)).astype(
                       np.float32))


@pytest.fixture(scope="module")
def textured():
    jm, tm = _textured("unitex_tpu", jprim), _textured("unitex_torch", tprim)
    for f in ("vertices", "faces", "uv", "faces_uv", "texture", "vertex_colors"):
        np.testing.assert_array_equal(getattr(jm, f), getattr(tm, f), err_msg=f)
    return jm, tm


@pytest.mark.parametrize("source", ["texture", "vertex_colors"])
def test_sample_source_colors_equal_jax(textured, source):
    from dataclasses import replace

    jm, tm = textured
    if source == "vertex_colors":
        jm, tm = (replace(m, texture=None) for m in (jm, tm))
    for a, b in zip(jremap._sample_source_colors(jm, 3000, seed=9),
                    tremap._sample_source_colors(tm, 3000, seed=9)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="neither texture nor vertex colors"):
        tremap._sample_source_colors(replace(tm, texture=None,
                                             vertex_colors=None), 10)


def test_remap_texture_matches_jax(textured):
    jm, tm = textured
    want = jremap.remap_texture(jm, jm, uv_size=64, n_samples=4000, seed=1)
    got = tremap.remap_texture(tm, tm, uv_size=64, n_samples=4000, seed=1,
                               device="cpu")
    assert got.shape == (64, 64, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=TEX_TOL, rtol=0)


def test_color_transfer_v_uv_matches_jax(textured):
    """A UV-less vertex-coloured source retextured onto its own unwrap."""
    from dataclasses import replace

    jm, tm = (replace(m, uv=None, faces_uv=None, texture=None)
              for m in textured)
    want = jremap.color_transfer_v_uv(jm, uv_size=64, n_samples=4000)
    got = tremap.color_transfer_v_uv(tm, uv_size=64, n_samples=4000,
                                     device="cpu")
    np.testing.assert_array_equal(got.uv, want.uv)
    assert got.texture.dtype == np.uint8 and got.texture.shape == (64, 64, 3)
    assert np.abs(got.texture.astype(int) - want.texture.astype(int)).max() <= 1
