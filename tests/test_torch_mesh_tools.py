"""The rest of ``geometry/mesh.py`` in the port against the JAX package,
on the CPU: PBR meshes and point clouds, face areas, tangents, the edge
Laplacian (and its gradient), bounding-box scaling, edges, face-mask
erosion, barycentric lookups in all three attribute forms, and
``ops/grid_sample.sample_texture``; within 1e-5, masks and indices
exact."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitex_tpu.geometry import mesh as jmesh
from unitex_tpu.geometry import topology as jtopo
from unitex_tpu.geometry.primitives import make_torus

from unitex_torch.geometry import mesh as tmesh
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

jgs = importlib.import_module("unitex_tpu.ops.grid_sample")
tgs = importlib.import_module("unitex_torch.ops.grid_sample")

TOL = 1e-5


@pytest.fixture(scope="module")
def torus():
    """The torus with a UV table of its own (a cylinder map) and seeded
    attributes."""
    m = make_torus(n_major=16, n_minor=8)
    v = m.vertices.astype(np.float32)
    f = m.faces.astype(np.int64)
    uv = np.stack([np.arctan2(v[:, 1], v[:, 0]) / (2 * np.pi) + 0.5,
                   v[:, 2] * 2 + 0.5], -1).astype(np.float32)
    rng = np.random.default_rng(0)
    return {"v": v, "f": f, "uv": uv,
            "tex": rng.uniform(0, 1, (12, 16, 3)).astype(np.float32),
            "vattr": rng.normal(size=(len(v), 2)).astype(np.float32),
            "const": np.asarray([0.25, 0.5], np.float32),
            "fidx": rng.integers(0, len(f), 50),
            "bary": rng.dirichlet(np.ones(3), 50).astype(np.float32),
            "fmask": np.arange(len(f)) < 0.6 * len(f)}


def _geometry(m, x, edges):
    v, f, uv = x["v"], x["f"], x["uv"]
    return {
        "gather": m.gather_face_vertices(v, f),
        "areas": m.compute_face_areas(v, f),
        "tangents": m.compute_vertex_tangents(v, f, uv),
        "tangents_uv": m.compute_vertex_tangents(v, f, uv, faces_uv=f),
        "smooth": m.laplacian_smooth(v, edges, v.shape[0], depth=3),
        "loss": m.laplacian_loss(v, edges, v.shape[0], depth=2),
        "bbox": m.scale_to_bbox(v * 3 + 1),
        "bbox_axes": m.scale_to_bbox(v * 3 + 1, 0.5, uniform=False),
        "edges": m.mesh_edges(f),
        "erode": m.erode_face_mask(f, x["fmask"], v.shape[0], rings=2),
        "interp": m.interpolate_attributes(x["vattr"], f, x["fidx"], x["bary"]),
    }


def test_mesh_functions_match_jax(torus):
    edges = jtopo.unique_edges(torus["f"])
    want = jit_reference(lambda d, e: _geometry(jmesh, d, e))(
        {k: jnp.asarray(a) for k, a in torus.items()}, jnp.asarray(edges))
    got = _geometry(tmesh, {k: torch.from_numpy(np.asarray(a))
                            for k, a in torus.items()},
                    torch.from_numpy(edges.astype(np.int64)))
    for k in want:
        w = np.asarray(want[k])
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=TOL,
                                       err_msg=k)
    assert 0 < np.asarray(want["erode"]).sum() < torus["fmask"].sum()


def test_laplacian_loss_gradient_matches_jax(torus):
    edges = jtopo.unique_edges(torus["f"])
    V = len(torus["v"])
    want = jit_reference(jax.grad(lambda v: jmesh.laplacian_loss(
        v, jnp.asarray(edges), V, depth=3)))(jnp.asarray(torus["v"]))
    v = torch.from_numpy(torus["v"]).requires_grad_(True)
    tmesh.laplacian_loss(v, torch.from_numpy(edges.astype(np.int64)), V,
                         depth=3).backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("form", ["map", "vertex", "constant"])
def test_sample_pbr_attribute_matches_jax(torus, form):
    attr = {"map": torus["tex"], "vertex": torus["vattr"],
            "constant": torus["const"]}[form]
    arrays = dict(vertices=torus["v"], faces=torus["f"], uv=torus["uv"],
                  faces_uv=torus["f"])
    jm = jmesh.PBRMesh(**{k: jnp.asarray(a) for k, a in arrays.items()},
                       albedo=jnp.asarray(attr))
    tm = tmesh.PBRMesh(**{k: torch.from_numpy(a) for k, a in arrays.items()},
                       albedo=torch.from_numpy(attr))
    want = jmesh.sample_pbr_attribute(jm, jm.albedo, jnp.asarray(torus["fidx"]),
                                      jnp.asarray(torus["bary"]))
    got = tmesh.sample_pbr_attribute(tm, tm.albedo,
                                     torch.from_numpy(torus["fidx"]),
                                     torch.from_numpy(torus["bary"]))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    assert tm.mesh.faces is tm.faces and tm.mesh.uv is tm.uv


def test_sample_texture_matches_jax(torus):
    """UVs in and past [0, 1] (border padding), v up."""
    uv = np.random.default_rng(3).uniform(-0.2, 1.2, (40, 2)).astype(np.float32)
    want = jgs.sample_texture(jnp.asarray(torus["tex"]), jnp.asarray(uv))
    got = tgs.sample_texture(torch.from_numpy(torus["tex"]), torch.from_numpy(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_point_clouds_split_and_concat_as_jax():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    nrm = rng.normal(size=(10, 3)).astype(np.float32)
    valid = rng.uniform(size=10) < 0.5
    jpc = jmesh.PointCloud(jnp.asarray(pts), normals=jnp.asarray(nrm),
                           valid=jnp.asarray(valid))
    tpc = tmesh.PointCloud(torch.from_numpy(pts), normals=torch.from_numpy(nrm),
                           valid=torch.from_numpy(valid))
    assert tpc.n_points == 10 and tpc.mask().tolist() == valid.tolist()
    assert tmesh.PointCloud(tpc.points).mask().all()
    jparts = jmesh.split_point_cloud(jpc, [3, 7])
    tparts = tmesh.split_point_cloud(tpc, [3, 7])
    for jp, tp in zip(jparts, tparts):
        np.testing.assert_array_equal(tp.points.numpy(), np.asarray(jp.points))
        assert tp.colors is None
    jm, jint = jmesh.concat_point_clouds(jparts + [jmesh.PointCloud(jpc.points)])
    tm, tint = tmesh.concat_point_clouds(tparts + [tmesh.PointCloud(tpc.points)])
    np.testing.assert_array_equal(tint.numpy(), np.asarray(jint))
    np.testing.assert_array_equal(tm.points.numpy(), np.asarray(jm.points))
    assert tm.normals is None and jm.normals is None
