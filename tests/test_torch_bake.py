"""The bake in the port (unitex_torch render/renderer_inverse reproject route,
ops/knn, ops/image_ops) against the JAX package on the same numpy inputs,
f32 on the CPU.

The whole bake runs at uv 256 from six 64² views of a procedural colour
field (0.5 + 0.5·position, rendered by the JAX package), so both bakes see
identical views.  Visibility is a per-texel decision (depth test at 5e-3,
ray-normal angle), so masks are compared by how many texels disagree and
colours where the masks agree.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitex_tpu.geometry.mesh import Mesh as JMesh
from unitex_tpu.geometry.primitives import make_icosphere
from unitex_tpu.geometry.uv_atlas import unwrap_atlas
from unitex_tpu.render import renderer_inverse as jinv
from unitex_tpu.render.conditioning import condition_cameras
from unitex_tpu.render.renderer import render_views

from unitex_torch.geometry.mesh import Mesh as TMesh
from unitex_torch.ops import image_ops as timg
from unitex_torch.ops import knn as tknn
from unitex_torch.render import renderer_inverse as tinv

# the JAX package's ops/__init__ re-exports functions under their modules'
# names, so the modules are taken from the import system
jimg = importlib.import_module("unitex_tpu.ops.image_ops")
jknn = importlib.import_module("unitex_tpu.ops.knn")

UV, VIEW = 256, 64
MASK_AGREE = 0.999  # share of texels whose visibility / validity must match
TEX_PSNR = 50.0     # dB over the valid texels: f32 on both sides, colours in [0, 1]


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))  # a writable copy
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def scene():
    m = unwrap_atlas(make_icosphere(3), size=UV, gutter=2)
    v = m.vertices.astype(np.float32) * np.float32(0.85)
    jm = JMesh(jnp.asarray(v), jnp.asarray(m.faces), uv=jnp.asarray(m.uv),
               faces_uv=jnp.asarray(m.faces_uv))
    tm = TMesh(_t(v), _t(m.faces, torch.int64), uv=_t(m.uv),
               faces_uv=_t(m.faces_uv, torch.int64))
    c2ws, intr = condition_cameras()
    out = render_views(jm, c2ws, intr, (VIEW, VIEW), render_world_position=True)
    views = np.asarray(0.5 + 0.5 * out.world_position / 0.85, np.float32)
    return jm, tm, np.asarray(c2ws), np.asarray(intr), np.clip(views, 0, 1)


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


@pytest.mark.parametrize("angle", [100.0, 150.0])
def test_bake_reproject_matches_jax(scene, angle):
    """At the default ray-normal threshold every texel of the sphere is
    seen; at 150 degrees about half are not, and the KNN fill colours them."""
    jm, tm, c2ws, intr, views = scene
    kw = dict(uv_size=UV, method="reproject", ray_normal_angle_threshold=angle)
    want = jinv.bake_texture(jm, jnp.asarray(views), jnp.asarray(c2ws),
                             jnp.asarray(intr), **kw)
    got = tinv.bake_texture(tm, _t(views), _t(c2ws), _t(intr), **kw)
    for key in ("mask_2d", "mask_visible_any", "boundary"):
        agree = (got[key].numpy() == np.asarray(want[key])).mean()
        assert agree >= MASK_AGREE, f"{key} agreement {agree:.5f}"
    np.testing.assert_array_equal(got["visible_per_view"].shape,
                                  np.asarray(want["visible_per_view"]).shape)
    valid = got["mask_2d"].numpy()[..., 0] & np.asarray(want["mask_2d"])[..., 0]
    assert valid.mean() > 0.3
    filled = valid & ~np.asarray(want["mask_visible_any"])[..., 0]
    assert (filled.sum() > 0.3 * valid.sum()) == (angle > 100.0)
    tex_t, tex_j = got["texture"].numpy(), np.asarray(want["texture"])
    assert tex_t.shape == tex_j.shape == (UV, UV, 3)
    assert np.isfinite(tex_t).all()
    assert _psnr(tex_t[valid], tex_j[valid]) >= TEX_PSNR
    # everywhere, pull-push included: the gutter texels are filled from
    # the same neighbours
    assert _psnr(tex_t, tex_j) >= TEX_PSNR - 10


def test_deferred_bake_options_raise(scene):
    _, tm, c2ws, intr, views = scene
    args = (tm, _t(views), _t(c2ws), _t(intr))
    for kwargs in ({"method": "kdtree"}, {"low_hbm": True}, {"fill_k": 4},
                   {"paste_mode": "cosine"}, {"visibility_mode": "tri"},
                   {"filt_gradient_points": True}):
        with pytest.raises(NotImplementedError):
            tinv.bake_texture(*args, uv_size=64, **kwargs)


def test_select_masked_points_matches_jax():
    """Stable order of the golden-ratio hash (uint32 in JAX, int64 and a
    mask in the port)."""
    rng = np.random.default_rng(0)
    N = 70_000  # past 2^16, so the ``idx >> 16`` term is exercised
    pts = rng.normal(size=(N, 3)).astype(np.float32)
    vals = rng.uniform(size=(N, 3)).astype(np.float32)
    mask = rng.uniform(size=N) < 0.4
    for max_n in (1024, N):
        got = tinv._select_masked_points(_t(pts), _t(vals), _t(mask), max_n)
        want = jinv._select_masked_points(jnp.asarray(pts), jnp.asarray(vals),
                                          jnp.asarray(mask), max_n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("max_fill", [1 << 20, 100])
def test_fill_invisible_knn_matches_jax(max_fill):
    """k = 1 fill, through the compacted query path and the dense one."""
    rng = np.random.default_rng(1)
    N = 3000
    pos = rng.normal(size=(N, 3)).astype(np.float32)
    color = rng.uniform(size=(N, 3)).astype(np.float32)
    visible = rng.uniform(size=N) < 0.5
    target = ~visible & (rng.uniform(size=N) < 0.7)
    got = tinv._fill_invisible_knn(_t(pos), _t(color), _t(visible), _t(target),
                                   k=1, max_ref=1024, chunk=512, max_fill=max_fill)
    want = jinv._fill_invisible_knn(jnp.asarray(pos), jnp.asarray(color),
                                    jnp.asarray(visible), jnp.asarray(target),
                                    k=1, max_ref=1024, chunk=512,
                                    max_fill=max_fill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_knn_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(500, 3)).astype(np.float32)
    r = rng.normal(size=(300, 3)).astype(np.float32)
    valid = rng.uniform(size=300) < 0.8
    for k in (1, 4):
        d_t, i_t = tknn.knn(_t(q), _t(r), k=k, chunk=128, ref_valid=_t(valid))
        d_j, i_j = jknn.knn(jnp.asarray(q), jnp.asarray(r), k=k, chunk=128,
                            ref_valid=jnp.asarray(valid))
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)


def _mask(seed, shape=(2, 40, 48, 1)):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=shape) < 0.6


@pytest.mark.parametrize("op", ["dilate", "erode", "boundary", "ring_close"])
def test_mask_ops_match_jax(op):
    m = _mask(3)
    fn = {
        "dilate": lambda mod, x: mod.dilate_mask(x, 5),
        "erode": lambda mod, x: mod.erode_mask(x, 3),
        "boundary": lambda mod, x: mod.boundary_mask(x, 3),
        "ring_close": lambda mod, x: mod.ring_close_mask(x, (3, 5)),
    }[op]
    got, want = fn(timg, _t(m)), fn(jimg, jnp.asarray(m))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("op", ["gaussian_blur", "lens_blur", "pull_push"])
def test_image_ops_match_jax(op):
    rng = np.random.default_rng(4)
    img = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    if op == "pull_push":
        m = _mask(5, (64, 64, 1))
        got = timg.pull_push(_t(img * m), _t(m))
        want = jimg.pull_push(jnp.asarray(img * m), jnp.asarray(m))
    else:
        got = getattr(timg, op)(_t(img))
        want = getattr(jimg, op)(jnp.asarray(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
