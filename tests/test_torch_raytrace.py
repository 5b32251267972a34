"""Ray tracing (``ops/raytrace.py``), point visibility
(``ops/visibility.py``) and mesh topology (``geometry/topology.py``) in
the port against the JAX package, on the CPU.

Triangle ids and hit masks must be equal as integers; t, u and v within
1e-5.  The faces are given more than once and the chunks are small, so
the tie rule (the lowest face index wins, inside a chunk and across
chunks) is exercised.  A ray through a shared vertex or edge is not a
tie: which face accepts it turns on the last bit of u and v, so the axis
rays meet a turned sphere.  The random directions are JAX's draws, fed
to the port.  Topology is numpy in both packages: bit for
bit."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitex_tpu.geometry import topology as jtopo
from unitex_tpu.geometry.primitives import make_icosphere, make_torus

from unitex_torch.geometry import topology as ttopo
from unitex_torch.ops import raytrace as trt
from unitex_torch.ops import visibility as tvis
from torch_cpu_share import share_cpu

share_cpu()

jrt = importlib.import_module("unitex_tpu.ops.raytrace")
jvis = importlib.import_module("unitex_tpu.ops.visibility")

TOL = 1e-5


@pytest.fixture(scope="module")
def sphere():
    m = make_icosphere(2)
    return m.vertices.astype(np.float32), m.faces.astype(np.int32)


def _t(v, f):
    return torch.from_numpy(v), torch.from_numpy(f.astype(np.int64))


def test_ray_triangle_intersect_matches_jax(sphere):
    """Random rays from outside and inside the sphere against its faces
    given three times: each face twice side by side (a tie inside a
    chunk) and once more after all of them (a tie across chunks), over
    chunks of 64 rays x 48 faces.  Every hit must take the first copy."""
    v, f = sphere
    F = len(f)
    faces = np.concatenate([np.repeat(f, 2, axis=0), f])
    rng = np.random.default_rng(0)
    d = rng.normal(size=(300, 3))
    o = rng.normal(size=(300, 3)) * np.array([[2.5], [0.3]]).repeat(150, 0)
    rays_o = o.astype(np.float32)
    rays_d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    kw = dict(ray_chunk=64, face_chunk=48)
    want = jrt.ray_triangle_intersect(
        *map(jnp.asarray, (rays_o, rays_d, v, faces)), **kw)
    got = trt.ray_triangle_intersect(torch.from_numpy(rays_o),
                                     torch.from_numpy(rays_d), *_t(v, faces),
                                     **kw)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_array_equal(got.front.numpy(), np.asarray(want.front))
    hit = np.asarray(want.hit)
    assert 0.3 < hit.mean() < 1.0
    tri = got.tri.numpy()[hit]
    assert (tri % 2 == 0).all() and (tri < 2 * F).all()
    for name in ("t", "uv", "loc"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(a[hit], b[hit], rtol=0, atol=TOL)
    assert np.isinf(got.t.numpy()[~hit]).all()


def test_self_and_cross_rt_match_jax(sphere):
    v, f = sphere
    rng = np.random.default_rng(1)
    d = rng.normal(size=(40, 3))
    pts = (d / np.linalg.norm(d, axis=1, keepdims=True)
           * rng.uniform(0.3, 1.6, (40, 1))).astype(np.float32)
    outer = (rng.normal(size=(6, 3)) * 2.5).astype(np.float32)
    key = jax.random.PRNGKey(666)
    draws = np.asarray(jax.random.normal(key, (40 * 8, 3), jnp.float32))
    want = jvis.self_rt(jnp.asarray(pts), jnp.asarray(v), jnp.asarray(f),
                        n_rays=8, key=key)
    got = tvis.self_rt(torch.from_numpy(pts), *_t(v, f), n_rays=8,
                       directions=torch.from_numpy(draws))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < np.asarray(want).sum() < 40
    want = jvis.cross_rt(*map(jnp.asarray, (pts, outer, v, f)))
    got = tvis.cross_rt(torch.from_numpy(pts), torch.from_numpy(outer), *_t(v, f))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < np.asarray(want).sum() < 40


@pytest.mark.parametrize("n_cameras", [4, 6, 5])
def test_sphere_rt_views_match_jax(sphere, n_cameras):
    v, f = sphere
    c, s = np.cos(0.3), np.sin(0.3)
    v = (v @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
         @ np.array([[1, 0, 0], [0, c, s], [0, -s, c]])).astype(np.float32)
    want = jvis.sphere_rt_views(jnp.asarray(v), jnp.asarray(f),
                                n_cameras=n_cameras, sample_offset=0.1)
    draws = None
    if n_cameras not in (4, 6):
        draws = torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.PRNGKey(666), (n_cameras, 3), jnp.float32)))
    got = tvis.sphere_rt_views(*_t(v, f), n_cameras=n_cameras,
                               sample_offset=0.1, directions=draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) >= 0).all()


def test_sphere_rt_matches_jax():
    """The torus from the bounding sphere: some rays miss (-1)."""
    m = make_torus()
    v, f = m.vertices.astype(np.float32) * 0.8, m.faces.astype(np.int32)
    key = jax.random.PRNGKey(3)
    want = jvis.sphere_rt(jnp.asarray(v), jnp.asarray(f), n_rays=200, key=key)
    got = tvis.sphere_rt(*_t(v, f), n_rays=200, directions=torch.from_numpy(
        np.asarray(jax.random.normal(key, (200, 3), jnp.float32))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) == -1).any() and (np.asarray(want) >= 0).any()


def _seamed_torus():
    """The torus with a UV chart cut along one ring: seams in UV space
    that are interior in position space."""
    m = make_torus(n_major=12, n_minor=8)
    f = m.faces.astype(np.int64)
    uv_of = {}
    faces_uv = np.zeros_like(f)
    uv = []
    for i, tri in enumerate(f):
        for k, vid in enumerate(tri):
            # faces of the first ring get their own copies of its vertices
            key = (int(vid), i < 16)
            if key not in uv_of:
                uv_of[key] = len(uv)
                uv.append(m.vertices[vid, :2] * 0.2 + 0.5 + (0.1 if i < 16 else 0))
            faces_uv[i, k] = uv_of[key]
    return m.vertices.astype(np.float32), f, np.asarray(uv, np.float32), faces_uv


def test_topology_matches_jax_bit_for_bit():
    v, f, uv, fuv = _seamed_torus()
    rng = np.random.default_rng(2)
    mask = rng.uniform(size=len(f)) < 0.5
    open_faces = f[: len(f) // 2]
    pairs = [
        (jtopo.unique_edges(f), ttopo.unique_edges(f)),
        (jtopo.get_boundary(open_faces), ttopo.get_boundary(open_faces)),
        (jtopo.dilate_face_mask(f, mask, len(v), 2),
         ttopo.dilate_face_mask(f, mask, len(v), 2)),
        (jtopo.erode_face_mask(f, mask, len(v)),
         ttopo.erode_face_mask(f, mask, len(v))),
        (jtopo.dilate_erode_face_mask(f, mask, len(v)),
         ttopo.dilate_erode_face_mask(f, mask, len(v))),
    ]
    for paired in (False, True):
        pairs += list(zip(jtopo.get_boundary_tex(f, fuv, paired=paired),
                          ttopo.get_boundary_tex(f, fuv, paired=paired)))
    for reverse in (False, True):
        pairs += list(zip(jtopo.get_seams_submesh(v, f, uv, fuv, reverse=reverse),
                          ttopo.get_seams_submesh(v, f, uv, fuv, reverse=reverse)))
    assert len(pairs[5][0]) > 0   # the cut ring has seam vertices
    for want, got in pairs:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
