"""The ported texturing path as a whole against the JAX pipeline.

Both ``CustomRGBTextureFullPipeline``s run one job on the small config of
tests/test_golden_parity.py with a tiny random FLUX + VAE (one numpy-made
tree carried into the port by ``params_from_jax``) and
``torch_rng_parity=True``, so both draw identical noise.  Every image
artifact of the two caches is scored by scripts/compare_golden.py;
the worst PSNR must be at least 35 dB (the production floor the JAX
package's own self-parity tests use).
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
from unitex_tpu.models.flux.lora import init_lora_params as j_init_lora
from unitex_tpu.models.flux.model import init_flux_params as j_init_flux
from unitex_tpu.models.flux.vae import VAEConfig as JVAEConfig
from unitex_tpu.models.flux.vae import init_vae_params as j_init_vae
from unitex_tpu.pipeline import CustomRGBTextureFullPipeline as JPipeline

from unitex_torch import config as tconfig
from unitex_torch.models.flux.config import FluxConfig as TFluxConfig
from unitex_torch.models.flux.vae import VAEConfig as TVAEConfig
from unitex_torch.pipeline import CustomRGBTextureFullPipeline as TPipeline
from unitex_torch.utils.params import params_from_jax

from test_golden_parity import small_config

DIFFUSION = dict(height=64, width=384, dual_size=16, num_inference_steps=2,
                 max_sequence_length=8, torch_rng_parity=True)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_config():
    jc = small_config()
    return tconfig.PipelineConfig(
        camera=tconfig.CameraConfig(**dataclasses.asdict(jc.camera)),
        mesh=tconfig.MeshConfig(**dataclasses.asdict(jc.mesh)),
        bake=tconfig.BakeConfig(**dataclasses.asdict(jc.bake)),
        diffusion=tconfig.DiffusionConfig(**DIFFUSION),
    )


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
    trees = {
        "flux": _numpy_tree(j_init_flux(jax.random.key(0), JFluxConfig.tiny())),
        "vae": _numpy_tree(j_init_vae(jax.random.key(1), JVAEConfig.tiny())),
    }
    # non-zero adapters, so the texture/delight merges change the kernels
    rng = np.random.default_rng(2)
    for name, key in (("texture", 2), ("delight", 3)):
        lora = _numpy_tree(j_init_lora(jax.random.key(key), trees["flux"], rank=2))
        trees[name] = jax.tree.map(
            lambda x: (0.02 * rng.standard_normal(x.shape)).astype(np.float32)
            if not np.any(x) else x, lora)

    jcfg = dataclasses.replace(small_config(),
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


def test_weightless_stand_in_is_not_ported():
    """Without random or caller-set FLUX weights the JAX package substitutes
    the control strip; the port refuses instead."""
    with pytest.raises(NotImplementedError):
        TPipeline(config=_port_config(), device="cpu").infer_mv_stage(
            "unused", None, {})


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
