"""The bake in the port (unitex_torch render/renderer_inverse with every
option of ``bake_texture``, ops/knn, ops/image_ops, ops/poisson) against
the JAX package on the same numpy inputs, f32 on the CPU.

The whole bake runs at uv 128 from six 64² views of a procedural colour
field (0.5 + 0.5·position, rendered by the JAX package), so both bakes see
identical views.  Visibility is a per-texel decision (depth test at 5e-3,
ray-normal angle), so masks are compared by how many texels disagree and
colours where the masks agree.
"""

import importlib

import jax
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
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

# the JAX package's ops/__init__ re-exports functions under their modules'
# names, so the modules are taken from the import system
jimg = importlib.import_module("unitex_tpu.ops.image_ops")
jknn = importlib.import_module("unitex_tpu.ops.knn")

UV, VIEW = 128, 64
KD_UV = 64          # the atlas of the ``bake_kdtree`` and blending cases
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
    seen; at 150 degrees about half are not, and the KNN fill colours them.
    The fill's reference set is capped at 2048 visible texels, below the
    3103 seen at 150 degrees of the 128² atlas, so both bakes take the
    same golden-ratio subset (the default cap of 65536 would take them
    all)."""
    jm, tm, c2ws, intr, views = scene
    kw = dict(uv_size=UV, method="reproject", ray_normal_angle_threshold=angle,
              knn_max_ref=2048)
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


def _bake_both(scene, views=None, **kw):
    """The same bake in both packages (uv 128, a 2048-texel fill cap)."""
    jm, tm, c2ws, intr, scene_views = scene
    views = scene_views if views is None else views
    kw = dict(uv_size=UV, knn_max_ref=2048, **kw)
    jkw = {k: v[0] if k == "query_field" else v for k, v in kw.items()}
    tkw = {k: v[1] if k == "query_field" else v for k, v in kw.items()}
    want = jinv.bake_texture(jm, jnp.asarray(views), jnp.asarray(c2ws),
                             jnp.asarray(intr), **jkw)
    got = tinv.bake_texture(tm, _t(views), _t(c2ws), _t(intr), **tkw)
    return got, want


def _assert_bakes_agree(got, want):
    """Masks agree on MASK_AGREE of the texels, the texture to TEX_PSNR
    over the valid texels; returns the visible share of the chart."""
    for key in ("mask_2d", "mask_visible_any"):
        agree = (got[key].numpy() == np.asarray(want[key])).mean()
        assert agree >= MASK_AGREE, f"{key} agreement {agree:.5f}"
    valid = got["mask_2d"].numpy()[..., 0] & np.asarray(want["mask_2d"])[..., 0]
    assert valid.mean() > 0.3
    tex_t, tex_j = got["texture"].numpy(), np.asarray(want["texture"])
    assert tex_t.shape == tex_j.shape == (UV, UV, 3) and np.isfinite(tex_t).all()
    assert _psnr(tex_t[valid], tex_j[valid]) >= TEX_PSNR
    return float(np.asarray(want["mask_visible_any"])[..., 0][valid].mean())


@pytest.fixture(scope="module")
def ltm_fields():
    """The ``query_field`` hook of one tiny LTM tree (the port's seeded
    init, carried to JAX as numpy) in both packages."""
    from unitex_tpu.models import ltm as jltm
    from unitex_torch.models import ltm as tltm

    tp = tltm.init_ltm_params(torch.Generator().manual_seed(0),
                              tltm.LTMConfig.tiny(), device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    return (jltm.make_query_field(jp, jltm.LTMConfig.tiny()),
            tltm.make_query_field(tp, tltm.LTMConfig.tiny()))


# one case a bake option; at 150 degrees about 45 % of the chart is seen
# by no view, so the fills have work
BAKE_OPTIONS = {
    "fill_k8": dict(fill_k=8, ray_normal_angle_threshold=150.0),
    "fill_k8_relax": dict(fill_k=8, fill_relax_iters=50,
                          ray_normal_angle_threshold=150.0),
    "filt_gradient_points": dict(filt_gradient_points=True),
    "paste_cosine": dict(paste_mode="cosine", ray_normal_angle_threshold=150.0),
    "visibility_tid": dict(visibility_mode="tid"),
    "visibility_both": dict(visibility_mode="both",
                            ray_normal_angle_threshold=150.0),
}


@pytest.mark.parametrize("option", list(BAKE_OPTIONS))
def test_bake_option_matches_jax(scene, option):
    kw = BAKE_OPTIONS[option]
    got, want = _bake_both(scene, **kw)
    vis = _assert_bakes_agree(got, want)
    assert (vis < 0.7) == (kw.get("ray_normal_angle_threshold") == 150.0
                           or option == "filt_gradient_points"), vis


_PORT_BAKES = {}


def _port_bake(scene, angle=150.0, **kw):
    """The port's bake of the scene (uv 128, a 2048-texel fill cap),
    computed once for each set of options."""
    key = (angle, tuple(sorted((k, id(v) if callable(v) else v)
                               for k, v in kw.items())))
    if key not in _PORT_BAKES:
        _, tm, c2ws, intr, views = scene
        _PORT_BAKES[key] = tinv.bake_texture(
            tm, _t(views), _t(c2ws), _t(intr), uv_size=UV, knn_max_ref=2048,
            ray_normal_angle_threshold=angle, **kw)
    return _PORT_BAKES[key]


def test_query_field_fill_matches_jax(scene, ltm_fields):
    """The learned-fill hook (a tiny LTM in each package; JAX's under
    ``jax.jit``) on the 150-degree bake, 55 % of the chart visible: the
    field colours every texel no view sees."""
    jfield, tfield = ltm_fields
    got, want = _bake_both(scene, ray_normal_angle_threshold=150.0,
                           query_field=(jit_reference(jfield), tfield))
    assert _assert_bakes_agree(got, want) < 0.6
    knn_fill = _port_bake(scene)
    invisible = ~got["mask_visible_any"] & got["mask_2d"]
    assert not torch.equal(got["texture"][invisible[..., 0]],
                           knn_fill["texture"][invisible[..., 0]])


@pytest.mark.parametrize("auto", [0.99, 0.3])
def test_query_field_auto_picks_the_fill(scene, ltm_fields, auto):
    """``query_field_auto`` against the 55 % visible chart: under the
    threshold (0.99) the field without relaxation, at or above it (0.3)
    the k=8 fill and 50 relaxation passes as without a field; each the
    bake :func:`test_query_field_fill_matches_jax` or the "fill_k8_relax"
    case holds to JAX, texel for texel."""
    field = ltm_fields[1]
    got = _port_bake(scene, query_field=field, query_field_auto=auto, fill_k=8,
                     fill_relax_iters=50)
    want = (_port_bake(scene, query_field=field) if auto == 0.99
            else _port_bake(scene, fill_k=8, fill_relax_iters=50))
    torch.testing.assert_close(got["texture"], want["texture"], rtol=0, atol=0)


def test_low_hbm_bake_equals_the_vmapped_bake(scene):
    """Views pasted one at a time in priority order, texels in 32-row
    slabs (``low_hbm_row_chunk``): the texture and masks of the plain
    bake, which :func:`test_bake_reproject_matches_jax` holds to JAX."""
    plain = _port_bake(scene)
    got = _port_bake(scene, low_hbm=True, low_hbm_row_chunk=32)
    for key in ("texture", "mask_visible_any", "visible_per_view", "boundary"):
        torch.testing.assert_close(got[key], plain[key], rtol=0, atol=0)
    with pytest.raises(ValueError, match="priority"):
        _port_bake(scene, low_hbm=True, paste_mode="cosine")


def test_geometry_size_matches_jax(scene):
    """128² colour views over 64² geometry buffers: the colour is sampled
    apart from the depth test, at its own resolution."""
    jm = scene[0]
    c2ws, intr = condition_cameras()
    out = render_views(jm, c2ws, intr, (2 * VIEW, 2 * VIEW),
                       render_world_position=True)
    big = np.clip(np.asarray(0.5 + 0.5 * out.world_position / 0.85, np.float32), 0, 1)
    got, want = _bake_both(scene, views=big, geometry_size=(VIEW, VIEW))
    _assert_bakes_agree(got, want)
    # the visibility test at the geometry's size: the 64² bake's
    same = _port_bake(scene, angle=100.0)
    assert (got["mask_visible_any"] == same["mask_visible_any"]).all()


@pytest.fixture(scope="module")
def kd_inputs(scene):
    """UV and view buffers and the per-view visibility at 150 degrees, in
    both packages: the inputs of ``bake_kdtree``, on a 64² atlas (a quarter
    of the KNN searches' queries)."""
    jm, tm, c2ws, intr, views = scene
    kw = dict(ray_normal_angle_threshold=150.0)
    juv, tuv = jinv.uv_render(jm, KD_UV), tinv.uv_render(tm, KD_UV)
    jmv = jinv.mv_render(jm, jnp.asarray(c2ws), jnp.asarray(intr), (VIEW, VIEW), **kw)
    tmv = tinv.mv_render(tm, _t(c2ws), _t(intr), (VIEW, VIEW), **kw)
    # one compile of the whole visibility instead of an eager compile per op
    jvis = jit_reference(lambda *a: jinv.view_visibility(*a, **kw))(
        juv, jmv, jnp.asarray(c2ws), jnp.asarray(views))
    tvis = tinv.view_visibility(tuv, tmv, _t(c2ws), _t(views), **kw)
    agree = (tvis["visible"].numpy() == np.asarray(jvis["visible"])).mean()
    assert agree >= MASK_AGREE
    return (juv, jvis, jmv, jnp.asarray(views)), (tuv, tvis, tmv, _t(views))


@pytest.mark.parametrize("method", ["order_mean", "order_mean_field", "mean",
                                    "mvpaint"])
def test_bake_kdtree_matches_jax(kd_inputs, ltm_fields, method):
    """``bake_kdtree``'s three methods on the same visibility: the first
    visible view's 4 nearest pixels ("order_mean", ``bake_texture``'s
    kdtree route, with the k=8 fill of the texels no view sees, or with the
    ``query_field`` hook: "order_mean_field"), or all views' 8 nearest
    blended by mean or by inverse distance × normal agreement."""
    jargs, targs = kd_inputs
    kw = dict(method=method, knn_max_ref=1024)
    if method == "order_mean_field":
        kw["method"] = "order_mean"
        jfield, tfield = ltm_fields
        want = jinv.bake_kdtree(*jargs, query_field=jit_reference(jfield), **kw)
        got = tinv.bake_kdtree(*targs, query_field=tfield, **kw)
    else:
        want = jinv.bake_kdtree(*jargs, **kw)
        got = tinv.bake_kdtree(*targs, **kw)
    valid = targs[0]["mask"].numpy()[..., 0]
    assert _psnr(got["texture"].numpy()[valid],
                 np.asarray(want["texture"])[valid]) >= TEX_PSNR


def test_bake_reproject_blending_matches_jax(kd_inputs):
    """Priority paste, k=1 fill, then each view Poisson-cloned over the
    texture with the chart exterior diffusion-outpainted first
    (``ops/poisson.py``; 30 and 15 Jacobi passes instead of 100 and 50)."""
    (juv, jvis, _, _), (tuv, tvis, _, _) = kd_inputs
    kw = dict(n_blend_iters=30, n_outpaint_iters=15, knn_max_ref=2048)
    want = jinv.bake_reproject_blending(juv, jvis, **kw)
    got = tinv.bake_reproject_blending(tuv, tvis, **kw)
    valid = tuv["mask"].numpy()[..., 0]
    assert _psnr(got["texture"].numpy()[valid],
                 np.asarray(want["texture"])[valid]) >= TEX_PSNR
    np.testing.assert_array_equal(got["mask_visible_any"].numpy(),
                                  tvis["visible"].numpy().any(axis=0))


def test_relax_fill_matches_jax_and_holds_the_visible_texels():
    rng = np.random.default_rng(7)
    color = rng.uniform(size=(48, 40, 3)).astype(np.float32)
    support = rng.uniform(size=(48, 40, 1)) < 0.8
    update = support & (rng.uniform(size=(48, 40, 1)) < 0.5)
    got = tinv._relax_fill(_t(color), _t(update), _t(support), 50).numpy()
    want = np.asarray(jinv._relax_fill(jnp.asarray(color), jnp.asarray(update),
                                       jnp.asarray(support), 50))
    np.testing.assert_allclose(got, want, atol=1e-6)
    fixed = ~update[..., 0]
    np.testing.assert_array_equal(got[fixed], color[fixed])
    assert np.abs(got - color)[update[..., 0]].max() > 0.1


@pytest.mark.parametrize("op", ["poisson_blend", "diffusion_inpaint",
                                "soft_blend", "laplacian"])
def test_poisson_ops_match_jax(op):
    from unitex_torch.ops import poisson as tpoi

    jpoi = importlib.import_module("unitex_tpu.ops.poisson")
    rng = np.random.default_rng(8)
    src, dst = (rng.uniform(size=(40, 48, 3)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(size=(40, 48, 1)) < 0.4
    args = {
        "poisson_blend": lambda m, t: m.poisson_blend(t(src), t(dst), t(mask), 60),
        "diffusion_inpaint": lambda m, t: m.diffusion_inpaint(t(src), t(mask), 60),
        "soft_blend": lambda m, t: m.soft_blend(t(src), t(dst), t(mask)),
        "laplacian": lambda m, t: m._laplacian(t(src)),
    }[op]
    got = args(tpoi, _t).numpy()
    want = np.asarray(args(jpoi, jnp.asarray))
    np.testing.assert_allclose(got, want, atol=2e-6)


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
