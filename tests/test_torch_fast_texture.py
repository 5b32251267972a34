"""FLUX img2img and inpainting (``run_flux_inpaint``, ``denoise``'s
``t_start``, ``known_tokens``, ``inpaint_mask``, ``fixed_noise`` and
``forward_fn``) and FastTexture (``texture/fast_texture.py``) in the port
against the JAX package, on the CPU.

One tiny FLUX tree and VAE from the port's seeded init feed both packages
(``params_from_jax``); the noise is the same numpy draw.  f32 on both
sides, held to 1e-4 as ``test_torch_flux.py`` holds the generation
pipeline; the kept latent tokens and the kept texels must come back bit
for bit.  64² images (8 x 8 = 64 image tokens), 4 steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitex_tpu.models.flux import pipeline as jpipe
from unitex_tpu.models.flux import vae as jvae
from unitex_tpu.models.flux.config import FluxConfig as JFluxConfig
from unitex_tpu.texture import fast_texture as jfast

from unitex_torch.models.flux import model as tmodel
from unitex_torch.models.flux import pipeline as tpipe
from unitex_torch.models.flux import vae as tvae
from unitex_torch.models.flux.config import FluxConfig as TFluxConfig
from unitex_torch.texture import fast_texture as tfast
from unitex_torch.utils.params import params_from_jax
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

ATOL = 1e-4
SIZE, STEPS, TXT = 64, 4, 8   # image side, denoise steps, prompt tokens


def _np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


# the JAX entry points jitted whole (one compile a call, where an eager
# call compiles its scan and each op apart); configs and the schedule's
# floats static
_STATIC = ("strength", "num_inference_steps", "guidance_scale")
j_inpaint = jit_reference(jpipe.run_flux_inpaint, static_argnums=(1, 3),
                    static_argnames=_STATIC)
j_inpaint_texture = jit_reference(jfast.inpaint_texture, static_argnums=(1, 3),
                            static_argnames=_STATIC)
j_upscale_texture = jit_reference(jfast.upscale_texture, static_argnums=(1, 3),
                            static_argnames=_STATIC + ("scale",))


@pytest.fixture(scope="module")
def trees():
    """(JAX trees, port trees) of the tiny FLUX and VAE."""
    flux = _np(tmodel.init_flux_params(torch.Generator().manual_seed(0),
                                       TFluxConfig.tiny(), device="cpu"))
    vae = _np(tvae.init_vae_params(torch.Generator().manual_seed(1),
                                   tvae.VAEConfig.tiny(), device="cpu"))
    return ((jax.tree.map(jnp.asarray, flux), jax.tree.map(jnp.asarray, vae)),
            (params_from_jax(flux, "cpu"), params_from_jax(vae, "cpu")))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    image = np.stack([np.sin(xx / 7.0), np.cos(yy / 5.0),
                      np.sin((xx + yy) / 11.0)], -1) * 0.4 + 0.5
    mask = ((yy - 40) ** 2 + (xx - 24) ** 2 < 14 ** 2).astype(np.float32)
    hl = SIZE // tvae.VAEConfig.tiny().downscale
    noise = rng.normal(size=(hl, hl, tvae.VAEConfig.tiny().latent_channels))
    embeds = rng.normal(size=(1, TXT, TFluxConfig.tiny().joint_attention_dim))
    pooled = rng.normal(size=(1, TFluxConfig.tiny().pooled_projection_dim))
    return {k: np.asarray(v, np.float32) for k, v in dict(
        image=image, mask=mask, noise=noise, embeds=embeds, pooled=pooled).items()}


def _embeds(x, pkg):
    return (jnp.asarray(x["embeds"]), jnp.asarray(x["pooled"])) if pkg == "jax" \
        else (torch.from_numpy(x["embeds"]), torch.from_numpy(x["pooled"]))


@pytest.mark.parametrize("mode,strength", [("inpaint", 1.0), ("img2img", 0.5),
                                           ("round_trip", 0.0)])
def test_run_flux_inpaint_matches_jax(trees, inputs, mode, strength):
    """Inpainting from pure noise, img2img from t_start = 2 (the JAX
    rounding), and strength 0: no step, the VAE round trip."""
    (jflux, jv), (tflux, tv) = trees
    mask = inputs["mask"] if mode == "inpaint" else None
    want = j_inpaint(
        jflux, JFluxConfig.tiny(), jv, jvae.VAEConfig.tiny(), jax.random.key(0),
        jnp.asarray(inputs["image"]),
        mask=None if mask is None else jnp.asarray(mask), strength=strength,
        num_inference_steps=STEPS, noise=jnp.asarray(inputs["noise"]),
        prompt_embeds=_embeds(inputs, "jax")[0],
        pooled_embeds=_embeds(inputs, "jax")[1])
    got = tpipe.run_flux_inpaint(
        tflux, TFluxConfig.tiny(), tv, tvae.VAEConfig.tiny(), None,
        torch.from_numpy(inputs["image"]),
        mask=None if mask is None else torch.from_numpy(mask),
        strength=strength, num_inference_steps=STEPS, noise=inputs["noise"],
        prompt_embeds=_embeds(inputs, "torch")[0],
        pooled_embeds=_embeds(inputs, "torch")[1], device="cpu")
    assert tuple(got.shape) == (SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def _denoise_case(trees, inputs, pkg, **kw):
    """4 steps from t_start = 1 over the image's tokens, with the kept
    tokens re-pinned under the disc's token mask and a reuse mask."""
    (jflux, jv), (tflux, tv) = trees
    cfg = tvae.VAEConfig.tiny()
    hl = SIZE // cfg.downscale
    img = inputs["image"][None] * 2.0 - 1.0
    m = inputs["mask"].reshape(hl // 2, 2 * cfg.downscale, hl // 2,
                               2 * cfg.downscale).max(axis=(1, 3))
    token_mask = m.reshape(-1, 1) > 0.5
    reuse = np.zeros(STEPS, bool)
    reuse[[1, 3]] = True   # t_start = 1 clears step 1: only step 3 is reused
    if pkg == "jax":
        pk, S = jpipe, jpipe.FlowMatchEulerScheduler
        x0 = pk.pack_latents(jvae.vae_encode_jit(jv, jvae.VAEConfig.tiny(),
                                                 jnp.asarray(img)))
        noise = pk.pack_latents(jnp.asarray(inputs["noise"])[None])
        sched = S.create(STEPS, x0.shape[1])
        args = (jflux, JFluxConfig.tiny())
        lat0 = sched.scale_noise(x0, 1, noise)
        ids = pk.latent_image_ids(hl // 2, hl // 2)
        mask_t, reuse_t = jnp.asarray(token_mask), jnp.asarray(reuse)
    else:
        pk = tpipe
        x0 = pk.pack_latents(tvae.vae_encode(tv, cfg, torch.from_numpy(img)))
        noise = pk.pack_latents(torch.from_numpy(inputs["noise"])[None])
        sched = pk.FlowMatchEulerScheduler.create(STEPS, x0.shape[1],
                                                  device="cpu")
        args = (tflux, TFluxConfig.tiny())
        lat0 = sched.scale_noise(x0, 1, noise)
        ids = pk.latent_image_ids(hl // 2, hl // 2, device="cpu")
        mask_t, reuse_t = torch.from_numpy(token_mask), reuse
    embeds, pooled = _embeds(inputs, pkg)
    txt_ids = embeds[0, :, :3] * 0
    out = pk.denoise(*args, lat0, ids, txt_ids, embeds, pooled, sched, 3.5,
                     t_start=1, known_tokens=x0, inpaint_mask=mask_t,
                     fixed_noise=noise, reuse_mask=reuse_t, **kw)
    return np.asarray(out), np.asarray(x0), token_mask


def test_denoise_t_start_inpaint_and_reuse_match_jax(trees, inputs):
    """``t_start``, the re-pin under a token mask and a reuse mask that
    the late start clears in part; the kept tokens come back as the
    encoded tokens bit for bit; ``forward_fn`` is called in place of the
    transformer on every step that is not reused."""
    want, _, _ = _denoise_case(trees, inputs, "jax")
    calls = []

    def forward(*a, **kw):
        calls.append(1)
        return tmodel.flux_forward(*a, **kw)

    got, x0, token_mask = _denoise_case(trees, inputs, "torch",
                                        forward_fn=forward)
    assert len(calls) == 2   # steps 1 and 2 run, step 3 is extrapolated
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    keep = ~token_mask[:, 0]
    assert keep.any() and (~keep).any()
    np.testing.assert_array_equal(got[:, keep], x0[:, keep])


def test_inpaint_texture_keeps_the_valid_texels(trees, inputs):
    (jflux, jv), (tflux, tv) = trees
    want = j_inpaint_texture(
        jflux, JFluxConfig.tiny(), jv, jvae.VAEConfig.tiny(), jax.random.key(3),
        jnp.asarray(inputs["image"]), jnp.asarray(inputs["mask"]),
        num_inference_steps=STEPS, prompt_embeds=_embeds(inputs, "jax")[0],
        pooled_embeds=_embeds(inputs, "jax")[1])
    got = tfast.inpaint_texture(
        tflux, TFluxConfig.tiny(), tv, tvae.VAEConfig.tiny(), None,
        torch.from_numpy(inputs["image"]), torch.from_numpy(inputs["mask"]),
        num_inference_steps=STEPS, prompt_embeds=_embeds(inputs, "torch")[0],
        pooled_embeds=_embeds(inputs, "torch")[1], noise=_key_noise(3),
        device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    keep = inputs["mask"] == 0
    np.testing.assert_array_equal(got[keep], inputs["image"][keep])
    assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1


def _key_noise(seed):
    """The draw JAX's ``run_flux_inpaint`` makes from ``key(seed)``."""
    cfg = tvae.VAEConfig.tiny()
    hl = SIZE // cfg.downscale
    return np.asarray(jax.random.normal(
        jax.random.key(seed), (1, hl, hl, cfg.latent_channels), jnp.float32))


def test_upscale_texture_matches_jax(trees, inputs):
    """32² -> 64²: JAX's cubic resize, then img2img at strength 0.5."""
    (jflux, jv), (tflux, tv) = trees
    small = inputs["image"][::2, ::2]
    want = j_upscale_texture(
        jflux, JFluxConfig.tiny(), jv, jvae.VAEConfig.tiny(), jax.random.key(4),
        jnp.asarray(small), strength=0.5, num_inference_steps=STEPS,
        prompt_embeds=_embeds(inputs, "jax")[0],
        pooled_embeds=_embeds(inputs, "jax")[1])
    got = tfast.upscale_texture(
        tflux, TFluxConfig.tiny(), tv, tvae.VAEConfig.tiny(), None,
        torch.from_numpy(small), strength=0.5, num_inference_steps=STEPS,
        prompt_embeds=_embeds(inputs, "torch")[0],
        pooled_embeds=_embeds(inputs, "torch")[1], noise=_key_noise(4),
        device="cpu")
    assert tuple(got.shape) == (SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
