"""Volume and field sampling (``render/volume.py``) and the field
visualization (``render/field_vis.py``) in the port against the JAX
package, on the CPU.

Every function of ``volume.py`` against its JAX counterpart (jitted): the
samplers, queries and coordinate maps within 1e-6 of the largest
reference value (f32, one order of taps), the integer coordinates exact,
the splat within 1e-6 (sums of a few points in other orders), the Cauchy
queries within 1e-5 (complex64 sums of ~100 terms).  ``field_vis`` is a
numpy copy: the grid, the tetrahedra mesh and the exported GLB bit for
bit (the GLB's header names its generator, ``unitex_torch`` or
``unitex_tpu``; the rest is compared)."""

import importlib

import numpy as np
import pytest
import torch

from unitex_torch.render import field_vis as tfield
from unitex_torch.render import volume as tvol
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

jvol = importlib.import_module("unitex_tpu.render.volume")
jfield = importlib.import_module("unitex_tpu.render.field_vis")

REL = 1e-6
CAUCHY_REL = 1e-5


def _close(got, want, rel=REL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    scale = max(float(np.abs(want).max()), 1e-12)
    wide = np.complex128 if np.iscomplexobj(want) else np.float64
    assert np.abs(got.astype(wide) - want.astype(wide)).max() <= rel * scale


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_3d_matches_jax(align_corners):
    """Inside, on the edges and past them (zero taps)."""
    rng = np.random.default_rng(int(align_corners))
    vol = rng.normal(size=(5, 6, 7, 3)).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (4, 33, 3)).astype(np.float32)
    coords[0, :3] = [[-1, -1, -1], [1, 1, 1], [1, -1, 0.5]]
    want = jit_reference(jvol.grid_sample_3d, static_argnums=2)(vol, coords, align_corners)
    _close(tvol.grid_sample_3d(_t(vol), _t(coords), align_corners), want)


def test_plane_queries_match_jax():
    """``triplane_query`` and ``box_query``, sum and concat, border taps."""
    rng = np.random.default_rng(2)
    planes = rng.normal(size=(3, 9, 11, 4)).astype(np.float32)
    faces = rng.normal(size=(6, 9, 11, 4)).astype(np.float32)
    coords = rng.uniform(-1.1, 1.1, (2, 40, 3)).astype(np.float32)
    for mode in ("sum", "concat"):
        want = jit_reference(jvol.triplane_query, static_argnums=2)(planes, coords, mode)
        _close(tvol.triplane_query(_t(planes), _t(coords), mode), want)
        want = jit_reference(jvol.box_query, static_argnums=2)(faces, coords, mode)
        _close(tvol.box_query(_t(faces), _t(coords), mode), want)


def test_splat_points_to_grid_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.05, 1.05, (500, 3)).astype(np.float32)
    vals = rng.normal(size=(500, 2)).astype(np.float32)
    valid = rng.random(500) > 0.25
    for mask in (None, valid):
        want = jit_reference(jvol.splat_points_to_grid, static_argnums=2)(
            pts, vals, 6, mask)
        got = tvol.splat_points_to_grid(_t(pts), _t(vals), 6,
                                        None if mask is None else _t(mask))
        _close(got, want)


def test_coordinate_maps_match_jax():
    """(Un)discretization in 2D and 3D, the pixel and voxel grids, the
    range remap and the unisphere contraction."""
    rng = np.random.default_rng(4)
    x3 = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    x2 = rng.uniform(-1, 1, (50, 2)).astype(np.float32)
    pix = rng.integers(0, 30, (50, 2)).astype(np.int32)
    far = (rng.normal(size=(50, 3)) * 2).astype(np.float32)
    bbox = (-1.5, 2.0)
    for ac in (False, True):
        _close(tvol.discretize_3d(_t(x3), 16, ac), jvol.discretize_3d(x3, 16, ac))
        _close(tvol.undiscretize_3d(_t(x3 * 8 + 8), 16, ac),
               jvol.undiscretize_3d(x3 * 8 + 8, 16, ac))
        for ndc in (True, False):
            src = x2 if ndc else x2 * 0.5 + 0.5
            np.testing.assert_array_equal(
                tvol.discretize_2d(_t(src), 24, 32, ndc, ac).numpy(),
                np.asarray(jvol.discretize_2d(src, 24, 32, ndc, ac)))
            _close(tvol.undiscretize_2d(_t(pix), 24, 32, ndc, ac),
                   jvol.undiscretize_2d(pix, 24, 32, ndc, ac))
    for ndc in (True, False):
        _close(tvol.make_grid_2d(5, 7, ndc, device="cpu"), jvol.make_grid_2d(5, 7, ndc))
        _close(tvol.make_grid_3d(3, 5, 7, ndc, device="cpu"),
               jvol.make_grid_3d(3, 5, 7, ndc))
    _close(tvol.scale_tensor(_t(far), bbox, (-1.0, 1.0)),
           jvol.scale_tensor(far, bbox, (-1.0, 1.0)))
    _close(tvol.scale_tensor(_t(far), None, None), jvol.scale_tensor(far, None, None))
    for unbounded in (False, True):
        _close(tvol.contract_to_unisphere(_t(far), bbox, unbounded),
               jit_reference(jvol.contract_to_unisphere, static_argnums=(1, 2))(
                   far, bbox, unbounded))


def test_cauchy_queries_match_jax():
    """``create_circle``, ``cauchy_integrate``, ``query_circle`` and
    ``query_cylinder`` (one ring and four), in complex64."""
    rng = np.random.default_rng(5)
    for a, b in zip(tvol.create_circle(24, 0.8, 0.1, device="cpu"),
                    jvol.create_circle(24, 0.8, 0.1)):
        _close(a, b)
    r = np.sqrt(rng.uniform(0, 0.7, (2, 30)))
    th = rng.uniform(0, 2 * np.pi, (2, 30))
    pos2 = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    circles = rng.normal(size=(2, 3, 32)).astype(np.float32)
    _close(tvol.query_circle(_t(pos2), _t(circles)),
           jit_reference(jvol.query_circle)(pos2, circles), CAUCHY_REL)
    _, _, gamma, dgamma = jvol.create_circle(16)
    z = (pos2[..., 0] + 1j * pos2[..., 1]).astype(np.complex64)
    f = (rng.normal(size=(2, 30, 17, 2)) + 1j * rng.normal(size=(2, 30, 17, 2))
         ).astype(np.complex64)
    _close(tvol.cauchy_integrate(_t(z), _t(np.asarray(gamma)), _t(np.asarray(dgamma)),
                                 _t(f)),
           jit_reference(jvol.cauchy_integrate)(z, gamma, dgamma, f), CAUCHY_REL)
    pos3 = np.concatenate([pos2, rng.uniform(-1.2, 1.2, (2, 30, 1))], -1
                          ).astype(np.float32)
    for Dc in (1, 4):
        cyl = rng.normal(size=(2, 3, Dc, 32)).astype(np.float32)
        _close(tvol.query_cylinder(_t(pos3), _t(cyl)),
               jit_reference(jvol.query_cylinder)(pos3, cyl), CAUCHY_REL)


def _sphere_sdf(x, y, z):
    """A tilted ellipsoid's implicit function: products and sums only, so
    numpy and PyTorch round it alike."""
    return 0.36 - (x * x + 1.2 * y * y + z * z) + 0.05 * x * y


def _glb_parts(path):
    """(the JSON chunk without the generator's name, the binary chunk)."""
    import json
    import struct

    with open(path, "rb") as f:
        data = f.read()
    n = struct.unpack("<I", data[12:16])[0]
    doc = json.loads(data[20:20 + n])
    doc["asset"].pop("generator")
    return doc, data[20 + n:]


def test_field_grid_and_tetrahedra_bit_for_bit():
    """The grid of a field (numpy in the JAX package; numpy, and tensors
    with ``device``, in the port) and its marching-tetrahedra mesh."""
    want = jfield.create_grid(_sphere_sdf, 12, 14, 16)
    np.testing.assert_array_equal(tfield.create_grid(_sphere_sdf, 12, 14, 16), want)
    on_dev = tfield.create_grid(lambda x, y, z: _sphere_sdf(x, y, z), 12, 14, 16,
                                device="cpu")
    np.testing.assert_array_equal(on_dev, want)
    for iso in (0.0, 0.2):
        tv, tf = tfield.marching_tetrahedra(want, iso=iso)
        jv, jf = jfield.marching_tetrahedra(want, iso=iso)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
    assert tf.shape[0] > 100
    empty = tfield.marching_tetrahedra(np.full((4, 4, 4), -1.0, np.float32))
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def test_export_isosurface_writes_the_jax_glb(tmp_path):
    from unitex_torch.geometry.io.mesh_io import load_mesh

    a = tfield.export_isosurface(_sphere_sdf, str(tmp_path / "t.glb"), resolution=20)
    b = jfield.export_isosurface(_sphere_sdf, str(tmp_path / "j.glb"), resolution=20)
    # the same bytes but for the generator's name in the header
    doc_a, bin_a = _glb_parts(a)
    doc_b, bin_b = _glb_parts(b)
    assert doc_a == doc_b and bin_a[8:] == bin_b[8:]
    host = load_mesh(a)
    assert host.faces.shape[0] > 100 and host.vertices.shape[1] == 3
