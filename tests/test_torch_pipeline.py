"""The ported texturing path as a whole against the JAX pipeline.

Both ``CustomRGBTextureFullPipeline``s run one job on the small config of
tests/test_golden_parity.py, cut to 32² views and 128² atlases, with a tiny
random FLUX + VAE (one numpy tree,
made by the port's seeded init and carried into the port by
``params_from_jax``) and
``torch_rng_parity=True``, so both draw identical noise.  Every image
artifact of the two caches is scored by scripts/compare_golden.py;
the worst PSNR must be at least 35 dB (the production floor the JAX
package's own self-parity tests use).  The weightless pipelines (no FLUX
weights under ``pretrain_models``) are held to the same bar.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from compare_golden import compare_caches  # noqa: E402

from unitex_tpu.config import DiffusionConfig
from unitex_tpu.geometry.io.mesh_io import save_mesh
from unitex_tpu.geometry.primitives import make_icosphere
from unitex_tpu.models.flux.config import FluxConfig as JFluxConfig
from unitex_tpu.models.flux.vae import VAEConfig as JVAEConfig
from unitex_tpu.pipeline import CustomRGBTextureFullPipeline as JPipeline

from unitex_torch import config as tconfig
from unitex_torch.models.flux.config import FluxConfig as TFluxConfig
from unitex_torch.models.flux.lora import init_lora_params as t_init_lora
from unitex_torch.models.flux.model import init_flux_params as t_init_flux
from unitex_torch.models.flux.vae import VAEConfig as TVAEConfig
from unitex_torch.models.flux.vae import init_vae_params as t_init_vae
from unitex_torch.pipeline import CustomRGBTextureFullPipeline as TPipeline
from unitex_torch.utils.params import params_from_jax

from test_golden_parity import small_config
from torch_cpu_share import share_cpu

share_cpu()

DIFFUSION = dict(height=32, width=192, dual_size=16, num_inference_steps=2,
                 max_sequence_length=8, torch_rng_parity=True)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _small():
    """tests/test_golden_parity.py's small config with 32² views and 128²
    atlases: every stage and artifact of the job, at a quarter of the
    pixels."""
    jc = small_config()
    return dataclasses.replace(
        jc, camera=dataclasses.replace(jc.camera, view_size=32),
        mesh=dataclasses.replace(jc.mesh, uv_size=128),
        bake=dataclasses.replace(jc.bake, uv_size=128))


def _port_config(jc=None):
    """The port's copy of a JAX pipeline config (default: ``_small()``
    with ``DIFFUSION``)."""
    jc = jc or dataclasses.replace(_small(), diffusion=DiffusionConfig(**DIFFUSION))
    return tconfig.PipelineConfig(
        camera=tconfig.CameraConfig(**dataclasses.asdict(jc.camera)),
        mesh=tconfig.MeshConfig(**dataclasses.asdict(jc.mesh)),
        bake=tconfig.BakeConfig(**dataclasses.asdict(jc.bake)),
        diffusion=tconfig.DiffusionConfig(**dataclasses.asdict(jc.diffusion)),
    )


def _ltm_config():
    """``_small()`` with 64² views (the gradient filter's 31² erosion
    leaves nothing of a 32² view) and no shape bucket (the padded faces
    only slow the rasterizers on the CPU)."""
    jc = _small()
    return dataclasses.replace(
        jc, camera=dataclasses.replace(jc.camera, view_size=64),
        mesh=dataclasses.replace(jc.mesh, shape_bucket=0),
        diffusion=DiffusionConfig(**DIFFUSION))


@pytest.fixture(scope="module", autouse=True)
def _jitted_scores():
    """``compare_caches`` scores every artifact with the JAX package's
    ``psnr`` and ``ssim``: here each runs as one jitted program an image
    size instead of compiling each of its ops eagerly."""
    import unitex_tpu.utils.metrics as metrics

    saved = metrics.psnr, metrics.ssim
    metrics.psnr, metrics.ssim = jax.jit(metrics.psnr), jax.jit(metrics.ssim)
    yield
    metrics.psnr, metrics.ssim = saved


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("assets")
    mesh_path = str(d / "input.glb")
    save_mesh(mesh_path, make_icosphere(3))
    img = np.full((256, 256, 3), 255, np.uint8)
    img[64:192, 64:192] = [200, 60, 30]
    img_path = str(d / "image.png")
    Image.fromarray(img).save(img_path)
    return mesh_path, img_path


def test_pipeline_artifacts_match_jax(assets, tmp_path):
    mesh_path, img_path = assets
    gen = torch.Generator()
    flux = t_init_flux(gen.manual_seed(0), TFluxConfig.tiny(), device="cpu")
    trees = {
        "flux": _numpy_tree(flux),
        "vae": _numpy_tree(t_init_vae(gen.manual_seed(1), TVAEConfig.tiny(),
                                      device="cpu")),
    }
    # non-zero adapters, so the texture/delight merges change the kernels
    rng = np.random.default_rng(2)
    for name, key in (("texture", 2), ("delight", 3)):
        lora = _numpy_tree(t_init_lora(gen.manual_seed(key), flux, rank=2,
                                       device="cpu"))
        trees[name] = jax.tree.map(
            lambda x: (0.02 * rng.standard_normal(x.shape)).astype(np.float32)
            if not np.any(x) else x, lora)

    jcfg = dataclasses.replace(_small(),
                               diffusion=DiffusionConfig(**DIFFUSION))
    jpipe = JPipeline(pretrain_models=None, seed=63, config=jcfg)
    jpipe.flux_cfg, jpipe.vae_cfg = JFluxConfig.tiny(), JVAEConfig.tiny()
    jpipe.transformer_params = jax.tree.map(jax.numpy.asarray, trees["flux"])
    jpipe.vae_params = jax.tree.map(jax.numpy.asarray, trees["vae"])
    jpipe.texture_lora = jax.tree.map(jax.numpy.asarray, trees["texture"])
    jpipe.delight_lora = jax.tree.map(jax.numpy.asarray, trees["delight"])
    jpipe._flux_loaded = True
    jdir = str(tmp_path / "jax")
    jpipe(jdir, img_path, mesh_path)

    tpipe = TPipeline(seed=63, config=_port_config(), device="cpu")
    tpipe.flux_cfg, tpipe.vae_cfg = TFluxConfig.tiny(), TVAEConfig.tiny()
    tpipe.transformer_params = params_from_jax(trees["flux"], "cpu")
    tpipe.vae_params = params_from_jax(trees["vae"], "cpu")
    tpipe.texture_lora = params_from_jax(trees["texture"], "cpu")
    tpipe.delight_lora = params_from_jax(trees["delight"], "cpu")
    tpipe._flux_loaded = True
    tdir = str(tmp_path / "torch")
    _, glb = tpipe(tdir, img_path, mesh_path)
    assert os.path.exists(glb)
    assert torch.isfinite(tpipe.last_texture).all()

    report = compare_caches(os.path.join(tdir, "cache"),
                            os.path.join(jdir, "cache"))
    scored = [v for v in report["artifacts"].values() if v]
    assert len(scored) >= 10, report
    assert report["worst_psnr"] >= 35.0, report


def test_weightless_pipeline_matches_jax(assets, tmp_path):
    """Both pipelines on a root without weights: the control strip stands
    in for the FLUX passes; every image artifact scored by
    scripts/compare_golden.py, worst PSNR at least 35 dB (the bar of
    :func:`test_pipeline_artifacts_match_jax`)."""
    mesh_path, img_path = assets
    empty = str(tmp_path / "no_weights")
    os.makedirs(empty)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcfg = dataclasses.replace(_small(), diffusion=DiffusionConfig(**DIFFUSION))
    JPipeline(pretrain_models=empty, seed=63, config=jcfg)(
        jdir, img_path, mesh_path)
    tpipe = TPipeline(pretrain_models=empty, seed=63, config=_port_config(),
                      device="cpu")
    _, glb = tpipe(tdir, img_path, mesh_path)
    assert not tpipe._flux_loaded and os.path.exists(glb)
    report = compare_caches(os.path.join(tdir, "cache"),
                            os.path.join(jdir, "cache"))
    scored = [v for v in report["artifacts"].values() if v]
    assert len(scored) >= 10, report
    assert report["artifacts"]["mv_rgb_w_light.png"], report
    assert report["worst_psnr"] >= 35.0, report


@pytest.mark.parametrize("ltm_auto", [None, 0.0], ids=["field", "knn"])
def test_ltm_pipeline_matches_jax(assets, tmp_path, monkeypatch, ltm_auto):
    """``RGBTextureFullPipeline`` (the LTM fill, step_2_2) in both packages,
    weightless, with one tiny LTM tree from the JAX init (the counterpart
    of tests/test_pipeline.py's ``TestLTMPipeline``): every image artifact
    scored as in :func:`test_pipeline_artifacts_match_jax`, in both fill
    branches: ``None`` always takes the field, 0.0 always the k=8 fill
    with 50 relaxation passes.  (The default 0.93 takes the field here:
    at 64² views the gradient filter leaves the sphere's chart about 13 %
    visible.)"""
    from unitex_tpu.models.ltm import LTMConfig as JLTMConfig
    from unitex_tpu.models.ltm import init_ltm_params as j_init_ltm
    from unitex_tpu.pipeline import RGBTextureFullPipeline as JLTMPipeline

    from unitex_torch.models.ltm import LTMConfig as TLTMConfig
    from unitex_torch.pipeline import RGBTextureFullPipeline as TLTMPipeline

    import unitex_tpu.models.ltm as jltm_mod

    # the JAX hook under jax.jit: one compile instead of one for each op
    make = jltm_mod.make_query_field
    monkeypatch.setattr(jltm_mod, "make_query_field",
                        lambda *a, **kw: jax.jit(make(*a, **kw)))
    mesh_path, img_path = assets
    empty = str(tmp_path / "no_weights")
    os.makedirs(empty)
    jtree = jax.jit(j_init_ltm, static_argnums=1)(jax.random.key(0),
                                                 JLTMConfig.tiny())
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcfg = _ltm_config()
    JLTMPipeline(pretrain_models=empty, seed=63, config=jcfg, ltm_params=jtree,
                 ltm_cfg=JLTMConfig.tiny(), ltm_auto=ltm_auto)(
        jdir, img_path, mesh_path)
    tpipe = TLTMPipeline(pretrain_models=empty, seed=63,
                         config=_port_config(jcfg),
                         ltm_params=params_from_jax(_numpy_tree(jtree), "cpu"),
                         ltm_cfg=TLTMConfig.tiny(), ltm_auto=ltm_auto,
                         device="cpu")
    _, glb = tpipe(tdir, img_path, mesh_path)
    assert os.path.exists(glb) and torch.isfinite(tpipe.last_texture).all()
    assert tpipe.last_fill["branch"] == ("knn" if ltm_auto == 0.0 else "field"), \
        tpipe.last_fill
    report = compare_caches(os.path.join(tdir, "cache"),
                            os.path.join(jdir, "cache"))
    scored = [v for v in report["artifacts"].values() if v]
    assert len(scored) >= 8 and report["artifacts"]["completed_uv.png"], report
    assert report["worst_psnr"] >= 35.0, report


@pytest.mark.parametrize("stage", ["reproject_stage", "reproject_with_field"])
@pytest.mark.parametrize("view", [32, 64], ids=["camera_size", "larger"])
def test_max_memory_bake_options_match_jax(monkeypatch, stage, view):
    """With ``int8_serving="max_memory"`` and weights held, both packages'
    bake stages ask ``bake_texture`` for the same options: the low-memory
    bake, ``knn_chunk=1024``, and in ``reproject_stage`` for views larger
    than the camera's 32² also the geometry at 32² and 64-row slabs."""
    import unitex_tpu.pipeline as jpipe_mod
    import unitex_tpu.render.renderer_inverse as jinv_mod

    import unitex_torch.pipeline as tpipe_mod
    from unitex_tpu.models.ltm import LTMConfig as JLTMConfig
    from unitex_torch.models.ltm import LTMConfig as TLTMConfig

    class Stop(Exception):
        pass

    seen = {}

    def capture(name):
        def bake(*args, **kwargs):
            seen[name] = kwargs
            raise Stop
        return bake

    monkeypatch.setattr(jpipe_mod, "bake_texture", capture("jax"))
    monkeypatch.setattr(jinv_mod, "bake_texture", capture("jax"))
    monkeypatch.setattr(tpipe_mod, "bake_texture", capture("torch"))
    grid = np.zeros((2 * view, 3 * view, 3), np.float32)
    cond = {"c2ws": np.eye(4, dtype=np.float32)[None].repeat(6, 0),
            "intrinsics": np.eye(3, dtype=np.float32)}
    jpipe = jpipe_mod.RGBTextureFullPipeline(
        pretrain_models=None, config=_small(), int8_serving="max_memory",
        ltm_params={}, ltm_cfg=JLTMConfig.tiny())
    tpipe = tpipe_mod.RGBTextureFullPipeline(
        config=_port_config(), int8_serving="max_memory", ltm_params={},
        ltm_cfg=TLTMConfig.tiny(), device="cpu")
    for pipe, arr in ((jpipe, jax.numpy.asarray), (tpipe, torch.from_numpy)):
        pipe._flux_loaded = True
        with pytest.raises(Stop):
            getattr(pipe, stage)("unused", None, arr(grid),
                                 {k: arr(v) for k, v in cond.items()}, None)
    want, got = seen["jax"], seen["torch"]
    assert callable(want.pop("query_field", None)) == callable(got.pop("query_field", None))
    assert got == want
    assert got["low_hbm"] and got["knn_chunk"] == 1024
    assert ("geometry_size" in got) == (stage == "reproject_stage" and view > 32)


@pytest.fixture(scope="module")
def int8_trees():
    """A tiny W8A8 FLUX tree (the port's seeded float tree quantized by the
    port, which tests/test_torch_quant.py holds equal to the JAX
    package's), a tiny VAE and two nonzero rank-2 adapters, as numpy."""
    from unitex_torch.models.flux.quantize import quantize_flux_params

    gen = torch.Generator()
    flux = t_init_flux(gen.manual_seed(0), TFluxConfig.tiny(), device="cpu")
    rng = np.random.default_rng(3)
    trees = {"flux": _numpy_tree(quantize_flux_params(flux)),
        "vae": _numpy_tree(t_init_vae(gen.manual_seed(1), TVAEConfig.tiny(),
                                      device="cpu"))}
    for name, key in (("texture", 2), ("delight", 3)):
        lora = _numpy_tree(t_init_lora(gen.manual_seed(key), flux, rank=2,
                                       device="cpu"))
        trees[name] = jax.tree.map(
            lambda x: (0.02 * rng.standard_normal(x.shape)).astype(np.float32)
            if not np.any(x) else x, lora)
    return trees


def test_int8_infer_mv_matches_jax(int8_trees, tmp_path):
    """The texture and delight passes of ``int8_serving=True``: W8A8 base
    kernels with both adapters attached at run time (``attach_lora``, the
    JAX package's int8 route), on one condition grid and reference image,
    with the same noise, on a 32×192 strip (S = 792).  The returned grids
    (the delighted strip, permuted) agree to 5e-4 in [0, 1] image units:
    summation order moves a few activations across an int8 rounding
    boundary (one step is 1/127 of the row's amax; the JAX package's own
    jit and eager forwards differ so), measured 6.9e-5 here."""
    rng = np.random.default_rng(4)
    grid = {k: rng.uniform(size=(64, 96, 3)).astype(np.float32)
            for k in ("normal", "ccm")}
    ref_image = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    jcfg = dataclasses.replace(_small(),
                               diffusion=DiffusionConfig(**DIFFUSION))
    jpipe = JPipeline(pretrain_models=None, seed=63, config=jcfg,
                      int8_serving=True, save_artifacts=False)
    jpipe.flux_cfg, jpipe.vae_cfg = JFluxConfig.tiny(), JVAEConfig.tiny()
    for attr, key in (("transformer_params", "flux"), ("vae_params", "vae"),
                      ("texture_lora", "texture"), ("delight_lora", "delight")):
        setattr(jpipe, attr, jax.tree.map(jax.numpy.asarray, int8_trees[key]))
    jpipe._flux_loaded = True
    want = jpipe.infer_mv_stage(
        str(tmp_path), ref_image,
        {k: jax.numpy.asarray(v) for k, v in grid.items()}, apply_sr=False)

    tpipe = TPipeline(seed=63, config=_port_config(),
                      int8_serving=True, save_artifacts=False, device="cpu")
    tpipe.flux_cfg, tpipe.vae_cfg = TFluxConfig.tiny(), TVAEConfig.tiny()
    for attr, key in (("transformer_params", "flux"), ("vae_params", "vae"),
                      ("texture_lora", "texture"), ("delight_lora", "delight")):
        setattr(tpipe, attr, params_from_jax(int8_trees[key], "cpu"))
    tpipe._flux_loaded = True
    got = tpipe.infer_mv_stage(str(tmp_path), ref_image,
                               {k: torch.from_numpy(v) for k, v in grid.items()})
    assert tuple(got.shape) == (64, 96, 3)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 5e-4


@pytest.mark.parametrize("mode,int4", [(True, False), ("max_memory", False),
                                       (True, True)])
def test_params_cache_round_trip(tmp_path, mode, int4):
    """The port builds the tiny serving tree once and writes it; a second
    pipeline reads it back (int4: the re-gridded unpack of the written
    pack); the JAX pipeline reads and validates the port's file; a file
    with another fingerprint is rebuilt and overwritten."""
    from unitex_torch.ops.quant import pack_int4_tree, unpack_int4_tree

    def port_pipe():
        p = TPipeline(config=_port_config(), int8_serving=mode,
                      params_cache=str(tmp_path), params_cache_int4=int4,
                      device="cpu")
        p.flux_cfg, p.vae_cfg = TFluxConfig.tiny(), TVAEConfig.tiny()
        p._init_random_weights()
        return p

    first = port_pipe()
    kind = TPipeline.RANDOM_KIND
    path = first._cache_path(kind)
    assert os.path.exists(path) and kind != "flux_random_s0"
    second = port_pipe()
    want = first.transformer_params
    if int4:
        want = unpack_int4_tree(pack_int4_tree(want))
    g, w = (_flat(t) for t in (second.transformer_params, want))
    assert sorted(g) == sorted(w)
    for k in w:
        torch.testing.assert_close(g[k], w[k], rtol=0, atol=0)
    # the card's int8 GEMM layout is restored on load
    k8 = second.transformer_params["single_blocks"]["proj_out"]["kernel_int8"]
    assert k8.stride()[-2] == 1
    # the JAX pipeline reads the port's file under the same kind and mode
    jpipe = JPipeline(pretrain_models=None, config=small_config(),
                      int8_serving=mode, params_cache=str(tmp_path),
                      params_cache_int4=int4)
    jpipe.flux_cfg = JFluxConfig.tiny()
    jtree = jpipe._load_cached_tree(kind)
    assert jtree is not None
    np.testing.assert_array_equal(
        np.asarray(jtree["dual_blocks"]["ff"]["in"]["bias"]).astype(np.float32),
        first.transformer_params["dual_blocks"]["ff"]["in"]["bias"]
        .float().numpy())
    # a stale fingerprint: rebuilt from the seed and written anew
    from unitex_torch.utils.param_cache import load_meta, save_params

    save_params(path, {"x": torch.zeros(1)}, meta={"version": 0})
    third = port_pipe()
    assert load_meta(path) == third._cache_meta(kind)
    torch.testing.assert_close(
        _flat(third.transformer_params)["x_embedder/kernel"],
        _flat(first.transformer_params)["x_embedder/kernel"], rtol=0, atol=0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_int8_serving_mode_is_checked():
    with pytest.raises(ValueError):
        TPipeline(config=_port_config(), int8_serving="int4", device="cpu")


@pytest.mark.parametrize("src,dst", [((512, 512), (16, 16)), ((100, 60), (37, 90)),
                                     ((16, 16), (64, 64))])
def test_resize_bilinear_matches_jax_image_resize(src, dst):
    """The dual image's resize: ``jax.image.resize(..., "bilinear")``
    antialiases when it shrinks (a widened triangle kernel), which
    ``F.interpolate`` does not reproduce; the port builds JAX's weights."""
    from unitex_torch.pipeline import resize_bilinear

    img = np.random.default_rng(0).uniform(size=(*src, 3)).astype(np.float32)
    want = jax.image.resize(jax.numpy.asarray(img), (*dst, 3), "bilinear")
    got = resize_bilinear(torch.from_numpy(img), *dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
