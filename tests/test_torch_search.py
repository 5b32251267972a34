"""KNN's top-k branch, ``query_ball`` and ``knn_gather_blend``
(``ops/knn.py``), the camera conversions (``camera/conversion.py``) and
``min_pool2d``, ``disk_blur`` and ``uv_dilation`` (``ops/image_ops.py``)
in the port against the JAX package, on the CPU.

The search's indices are exact and in JAX's order: ascending distance,
ties to the lower reference index (duplicated references make exact
ties, since both packages compute the same distance for equal rows);
squared distances within 1e-5 (a query on a reference has a d² of
rounding noise, about 1e-7, whose root is about 1e-3.5 in either
package).  A query whose k-th and (k+1)-th distances differ
by less than 1e-5 may pick either side of that boundary (f32 rounding of
the product), so the seeded points keep those gaps wider.  The camera
conversions within 1e-6, the pools exact, the blurs and the dilation
within 1e-6."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitex_torch.camera import conversion as tconv
from unitex_torch.ops import image_ops as timg
from unitex_torch.ops import knn as tknn
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

jknn = importlib.import_module("unitex_tpu.ops.knn")
jimg = importlib.import_module("unitex_tpu.ops.image_ops")
jconv = importlib.import_module("unitex_tpu.camera.conversion")

DIST_ATOL = 1e-5
CAM_ATOL = 1e-6
BLUR_ATOL = 1e-6


def _points(seed=0, n_ref=400, n_q=300, on_refs=True):
    """References with exact duplicates (rows 0-59 repeated, some twice)
    and queries, a few on references (``on_refs``), a third of the
    references masked."""
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=(n_ref, 3)).astype(np.float32)
    ref = np.concatenate([ref, ref[:60], ref[:20]])
    q = rng.normal(size=(n_q, 3)).astype(np.float32)
    if on_refs:
        q[:10] = ref[:10]
    valid = rng.random(ref.shape[0]) > 0.3
    valid[:60] = valid[n_ref:n_ref + 60] = True
    return q, ref, valid


@pytest.mark.parametrize("k", [9, 16])
def test_knn_top_k_matches_jax(k):
    q, ref, valid = _points(k)
    for mask in (None, valid):
        jd, ji = jknn.knn(jnp.asarray(q), jnp.asarray(ref), k=k, chunk=128,
                          ref_valid=None if mask is None else jnp.asarray(mask))
        td, ti = tknn.knn(torch.from_numpy(q), torch.from_numpy(ref), k=k, chunk=128,
                          ref_valid=None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(td.numpy() ** 2, np.asarray(jd) ** 2,
                                   atol=DIST_ATOL)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the duplicated rows are exact ties: the lower index comes first
    first = ti.numpy()[:10, :2]
    assert (first[:, 0] < first[:, 1]).all()


def test_query_ball_matches_jax():
    """The ``cap`` nearest in-radius references and the true count (above
    the cap for the dense queries), with masked references."""
    q, ref, valid = _points(3)
    for radius, cap in ((0.6, 8), (1.5, 32)):
        ji, jm, jc = jknn.query_ball(jnp.asarray(q), jnp.asarray(ref), radius,
                                     cap=cap, chunk=128, ref_valid=jnp.asarray(valid))
        ti, tm, tc = tknn.query_ball(torch.from_numpy(q), torch.from_numpy(ref),
                                     radius, cap=cap, chunk=128,
                                     ref_valid=torch.from_numpy(valid))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(np.where(tm.numpy(), ti.numpy(), -1),
                                      np.where(np.asarray(jm), np.asarray(ji), -1))
    assert (tc.numpy() > cap).any()


def test_knn_gather_blend_matches_jax():
    """No query on a reference: there the weight 1 / (d + 1e-8) turns on
    rounding noise."""
    q, ref, valid = _points(4, on_refs=False)
    vals = np.random.default_rng(5).random((ref.shape[0], 3)).astype(np.float32)
    want = jknn.knn_gather_blend(jnp.asarray(q), jnp.asarray(ref),
                                 jnp.asarray(vals), k=12, chunk=128,
                                 ref_valid=jnp.asarray(valid))
    got = tknn.knn_gather_blend(torch.from_numpy(q), torch.from_numpy(ref),
                                torch.from_numpy(vals), k=12, chunk=128,
                                ref_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _cameras(perspective):
    rng = np.random.default_rng(6 + perspective)
    ang = rng.uniform(0, 2 * np.pi, 3)
    c2ws = np.zeros((3, 4, 4), np.float32)
    for i, a in enumerate(ang):
        c, s = np.cos(a), np.sin(a)
        c2ws[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        c2ws[i, :3, 3] = 2.8 * np.array([s, 0.3, c])
        c2ws[i, 3, 3] = 1.0
    intr = np.array([[0.9, 0, 0.48], [0, 1.1, 0.52], [0, 0, 1]], np.float32)
    return c2ws, np.broadcast_to(intr, (3, 3, 3)).copy()


@pytest.mark.parametrize("perspective", [True, False], ids=["perspective", "ortho"])
def test_camera_conversions_match_jax(perspective):
    """``proj_to_intr``, ``transform_points_homo``, ``project``,
    ``unproject``, ``discretize``, ``undiscretize``, ``c2ws_to_rays`` and
    ``c2ws_to_ray_matrices``, each JAX side jitted."""
    c2ws, intr = _cameras(perspective)
    rng = np.random.default_rng(8)
    pts = np.concatenate([rng.normal(size=(3, 50, 3)), np.ones((3, 50, 1))], -1)
    pts[..., 2] -= 3.0
    pts = pts.astype(np.float32)
    ndc = rng.uniform(-1, 1, (3, 50, 2)).astype(np.float32)
    depth = rng.uniform(1, 3, (3, 50, 1)).astype(np.float32)

    def jax_side(c2ws, intr, pts, ndc, depth):
        proj = jconv.intr_to_proj(intr, perspective=perspective)
        return {
            "proj_to_intr": jconv.proj_to_intr(proj, perspective=perspective),
            "homo": jconv.transform_points_homo(pts, proj),
            "project": jconv.project(pts, intr, perspective=perspective),
            "unproject": jconv.unproject(ndc, depth, intr, perspective=perspective),
            "discretize": [jconv.discretize(ndc, 24, 32, is_ndc=n, align_corner=a)
                           for n in (True, False) for a in (True, False)],
            "undiscretize": [jconv.undiscretize(ndc * 9 + 10, 24, 32, to_ndc=n,
                                                align_corner=a)
                             for n in (True, False) for a in (True, False)],
            "rays": jconv.c2ws_to_rays(c2ws),
            "ray_matrices": jconv.c2ws_to_ray_matrices(c2ws, intr, 6, 5,
                                                       perspective=perspective),
        }

    want = jit_reference(jax_side)(c2ws, intr, pts, ndc, depth)
    t = {k: torch.from_numpy(v) for k, v in
         dict(c2ws=c2ws, intr=intr, pts=pts, ndc=ndc, depth=depth).items()}
    proj = tconv.intr_to_proj(t["intr"], perspective=perspective)
    got = {
        "proj_to_intr": tconv.proj_to_intr(proj, perspective=perspective),
        "homo": tconv.transform_points_homo(t["pts"], proj),
        "project": tconv.project(t["pts"], t["intr"], perspective=perspective),
        "unproject": tconv.unproject(t["ndc"], t["depth"], t["intr"],
                                     perspective=perspective),
        "discretize": [tconv.discretize(t["ndc"], 24, 32, is_ndc=n, align_corner=a)
                       for n in (True, False) for a in (True, False)],
        "undiscretize": [tconv.undiscretize(t["ndc"] * 9 + 10, 24, 32, to_ndc=n,
                                            align_corner=a)
                         for n in (True, False) for a in (True, False)],
        "rays": tconv.c2ws_to_rays(t["c2ws"]),
        "ray_matrices": tconv.c2ws_to_ray_matrices(t["c2ws"], t["intr"], 6, 5,
                                                   perspective=perspective),
    }
    for key in want:
        w = jax.tree.leaves(want[key])
        g = jax.tree.leaves(got[key])
        assert len(w) == len(g), key
        for a, b in zip(g, w):
            assert tuple(a.shape) == tuple(b.shape), key
            scale = max(1.0, float(np.abs(np.asarray(b)).max()))
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=CAM_ATOL * scale, err_msg=key)


def test_pools_and_disk_blur_match_jax():
    img = np.random.default_rng(9).random((2, 21, 26, 3)).astype(np.float32)
    for k in (3, 5):
        for name in ("min_pool2d", "max_pool2d"):
            want = jit_reference(getattr(jimg, name), static_argnums=1)(jnp.asarray(img), k)
            got = getattr(timg, name)(torch.from_numpy(img), k)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for radius in (2, 4):
        want = jit_reference(jimg.disk_blur, static_argnums=1)(jnp.asarray(img), radius)
        got = timg.disk_blur(torch.from_numpy(img), radius)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BLUR_ATOL)


@pytest.mark.parametrize("max_iters", [-1, 3], ids=["until_full", "three_passes"])
def test_uv_dilation_matches_jax(max_iters):
    rng = np.random.default_rng(10)
    color = rng.random((40, 48, 3)).astype(np.float32)
    yy, xx = np.mgrid[:40, :48]
    mask = (((yy - 20) ** 2 + (xx - 24) ** 2) < 12 ** 2)[..., None]
    mask &= rng.random(mask.shape) > 0.2
    for k in (3, 5):
        want = jimg.uv_dilation(jnp.asarray(color), jnp.asarray(mask),
                                max_iters=max_iters, kernel_size=k)
        got = timg.uv_dilation(torch.from_numpy(color), torch.from_numpy(mask),
                               max_iters=max_iters, kernel_size=k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BLUR_ATOL)
