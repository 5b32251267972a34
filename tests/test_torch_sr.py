"""TSD-SR super-resolution in the port against the JAX package's, on the
same numpy inputs and parameter trees on the CPU: ``sd3_forward``
(unitex_torch/models/sd3/model.py) at ``SD3Config.tiny()`` and at a
narrow 2-layer config with D = 64 heads (the head width kernel B1's
second instantiation serves on the card), and end to end
(unitex_torch/models/sd3/sr_pipeline.py, ``_apply_sr`` of
unitex_torch/pipeline.py): ``TSDSRPipeline`` at
``SD3Config.tiny()`` and ``VAEConfig.tiny()`` with 64² VAE tiles for the
wavelet and AdaIN fixes (the default bf16 decode and f32), int8 serving
and int4 staging, and ``_apply_sr``'s per-view ``"max_memory"`` branch
with the grid-level AdaIN.

Trees are made by the port's seeded init (f32) and carried to JAX as
numpy.  Tolerances: the f32 transformer 1e-4 and f32 [0, 1] images 1e-5
(reduction order); the default
bf16 VAE decode max 5e-2 and mean 5e-3 of the [0, 1] output, because the
two frameworks round the bf16 convolutions at other places (each
package's bf16 decode is ~3e-2 from its own f32 one); int8 relative L2
5e-4 (an activation one rounding away from a .5 boundary lands one int8
step off, as in tests/test_torch_quant.py).
"""

import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitex_tpu.models.flux.vae import VAEConfig as JVAEConfig
from unitex_tpu.models.sd3 import model as jmodel
from unitex_tpu.models.sd3 import sr_pipeline as jsr
from unitex_tpu.models.sd3.config import SD3Config as JSD3Config

from unitex_torch.models.flux.vae import VAEConfig as TVAEConfig
from unitex_torch.models.sd3 import model as tmodel
from unitex_torch.models.sd3 import sr_pipeline as tsr
from unitex_torch.models.sd3.config import SD3Config as TSD3Config

from test_torch_sd3 import _configs, _numpy
from test_torch_sd3 import trees  # noqa: F401  (the module's fixture)
from torch_cpu_share import share_cpu

share_cpu()

jpipeline = importlib.import_module("unitex_tpu.pipeline")
tpipeline = importlib.import_module("unitex_torch.pipeline")

FWD_ATOL = 1e-4       # f32 transformer, reduction order
IMG_ATOL = 1e-5       # f32 [0, 1] images, reduction order
BF16_MAX, BF16_MEAN = 5e-2, 5e-3   # the bf16 VAE decode (module docstring)
INT8_REL = 5e-4       # relative L2 of the int8 paths' outputs


_jax_forward = jax.jit(jmodel.sd3_forward, static_argnums=1)


@pytest.mark.parametrize("name", ["tiny", "d64"])
def test_sd3_forward_matches_jax(trees, name):
    """Patchify, the cropped position table, scale-1.0 timesteps, the joint
    blocks and the context-pre-only final block: at the tiny config on
    the SR pipeline's tile batches (6 tiles of 16² latents, 154 prompt
    tokens, through the JAX package's jitted tile step), and at D = 64 on
    a non-square 10 x 12 latent (5 x 6 patches, off-centre crop)."""
    tcfg, jcfg = _configs(name)
    rng = np.random.default_rng(3)
    if name == "tiny":
        tp, jp = trees[0], trees[2]
        shape, n_txt, forward = (6, 16, 16), 154, jsr._sd3_tile_step
    else:
        tp = tmodel.init_sd3_params(torch.Generator().manual_seed(2), tcfg,
                                    device="cpu")
        jp = jax.tree.map(jnp.asarray, _numpy(tp))
        shape, n_txt, forward = (2, 10, 12), 6, _jax_forward
    lat = rng.normal(size=shape + (tcfg.in_channels,)).astype(np.float32)
    ctx = rng.normal(size=(shape[0], n_txt, tcfg.joint_attention_dim)
                     ).astype(np.float32)
    pooled = rng.normal(size=(shape[0], tcfg.pooled_projection_dim)
                        ).astype(np.float32)
    t = rng.uniform(0, 1000, size=shape[0]).astype(np.float32)
    want = np.asarray(forward(jp, jcfg, lat, ctx, t, pooled))
    got = tmodel.sd3_forward(tp, tcfg, *map(torch.from_numpy,
                                            (lat, ctx, t, pooled)))
    assert got.dtype == torch.float32 and got.shape == lat.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)


# TSDSRConfig at the tiny VAE's downscale of 2: a 20 x 24 input, x4 to
# 80 x 96, tiled encode in 64² pixel tiles (4 tiles), 40 x 48 latents in
# 16² tiles with overlap 4 (12 tiles, two calls of 6: one JAX compile of
# the tile step per tree layout), tiled decode in 32² latent tiles (64²
# pixels, 4 tiles)
SR_KW = dict(upscale=4, latent_tile=16, latent_overlap=4, vae_encoder_tile=64,
             vae_decoder_tile=32, tile_batch=6)
SR_CASES = {
    "wavelet": dict(),
    "wavelet_f32": dict(vae_decode_dtype="float32"),
    "adain_f32": dict(align_method="adain", vae_decode_dtype="float32"),
    "int8": dict(int8_serving=True, vae_decode_dtype="float32"),
    "int4_staging": dict(int8_serving=True, host_params=True,
                         stage_pack_int4=True, vae_decode_dtype="float32"),
}
# the per-view branch's SR: the weights staged, f32 (shares the f32
# cases' JAX compiles)
HOST_F32 = dict(host_params=True, vae_decode_dtype="float32")


def _pipes(trees, case, **more):
    tp, vp, jp, jvp = trees
    kw = {**SR_KW, **SR_CASES.get(case, {}), **more}
    jpipe = jsr.TSDSRPipeline(None, cfg=jsr.TSDSRConfig(**kw),
                              sd3_cfg=JSD3Config.tiny(),
                              transformer_params=jp, vae_params=jvp)
    jpipe.vae_cfg = JVAEConfig.tiny()
    tpipe = tsr.TSDSRPipeline(None, cfg=tsr.TSDSRConfig(**kw),
                              sd3_cfg=TSD3Config.tiny(), transformer_params=tp,
                              vae_params=vp, device="cpu")
    tpipe.vae_cfg = TVAEConfig.tiny()
    return jpipe, tpipe


@pytest.mark.parametrize("case", list(SR_CASES))
def test_sr_pipeline_matches_jax(trees, case):
    img = np.random.default_rng(9).uniform(size=(20, 24, 3)).astype(np.float32)
    jpipe, tpipe = _pipes(trees, case)
    want = np.asarray(jpipe(jnp.asarray(img)))
    got = tpipe(img)
    assert got.shape == (80, 96, 3) and got.dtype == torch.float32
    got = got.numpy()
    if case == "wavelet":
        assert np.abs(got - want).max() <= BF16_MAX
        assert np.abs(got - want).mean() <= BF16_MEAN
    elif case.startswith("int"):
        assert np.linalg.norm(got - want) <= INT8_REL * np.linalg.norm(want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=IMG_ATOL)
    if case == "int4_staging":
        # the host trees are back after the window; the packed tree is kept
        # for the next window while the host tree is the same
        assert tpipe.transformer_params["blocks"]["ff"]["in"][
            "kernel_int8"].device.type == "cpu"
        packed = tpipe._packed[1]
        with tpipe.staged():
            assert tpipe._packed[1] is packed


@pytest.mark.parametrize("align", ["adain", "wavelet"])
def test_apply_sr_per_view_matches_jax(trees, align):
    """``_apply_sr`` under ``"max_memory"`` with FLUX loaded: six views SR'd
    one at a time in one staging window, quantized to uint8, the AdaIN fix
    as one grid-level affine on the host.  Both packages' methods run on
    the same stand-in pipeline state (views of 20 x 24, the SR tests'
    input).  The uint8 views may differ by one level where the two SRs
    straddle a rounding boundary (0.007 % of them here); the grid-level
    AdaIN scales by s.std / t.std, about 2 on these random weights, so
    there a level becomes up to three."""
    rng = np.random.default_rng(11)
    grid = rng.uniform(size=(2 * 20, 3 * 24, 3)).astype(np.float32)
    jpipe, tpipe = _pipes(trees, None, align_method=align, **HOST_F32)
    cam = SimpleNamespace(rows=2, cols=3)

    def state(cls, sr):
        """A pipeline of ``cls`` with only the state ``_apply_sr`` reads."""
        pipe = object.__new__(cls)
        pipe.__dict__.update(sr_pipeline=sr, save_artifacts=False,
                             int8_serving="max_memory", _flux_loaded=True,
                             config=SimpleNamespace(camera=cam))
        return pipe

    want = np.asarray(state(jpipeline.RGBTextureFullPipelineBase, jpipe)
                      ._apply_sr(jnp.asarray(grid)))
    got = state(tpipeline.RGBTextureFullPipelineBase, tpipe)._apply_sr(
        torch.from_numpy(grid))
    assert got.dtype == torch.uint8 and got.shape == (160, 288, 3)
    assert want.dtype == np.uint8
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= (3 if align == "adain" else 1)
    assert (diff > 0).mean() <= 1e-3
    assert tpipe.cfg.align_method == align
