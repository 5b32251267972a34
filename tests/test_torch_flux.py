"""FLUX in the port (unitex_torch/models/flux) against the JAX package on
one parameter tree: the JAX init makes it, ``params_from_jax`` carries it
into the port.  Tiny configs, f32, CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitex_tpu.models.flux import lora as jlora
from unitex_tpu.models.flux import model as jmodel
from unitex_tpu.models.flux import pipeline as jpipe
from unitex_tpu.models.flux import scheduler as jsched
from unitex_tpu.models.flux import vae as jvae
from unitex_tpu.models.flux.config import FluxConfig as JFluxConfig

from unitex_torch.models.flux import lora as tlora
from unitex_torch.models.flux import model as tmodel
from unitex_torch.models.flux import pipeline as tpipe
from unitex_torch.models.flux import scheduler as tsched
from unitex_torch.models.flux import vae as tvae
from unitex_torch.models.flux.config import FluxConfig as TFluxConfig
from unitex_torch.utils.params import params_from_jax, tree_shapes

# f32 on both sides; the differences are summation order over tiny depths
REL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.fixture(scope="module")
def flux_tree():
    return _np(jmodel.init_flux_params(jax.random.key(0), JFluxConfig.tiny()))


@pytest.fixture(scope="module")
def vae_tree():
    return _np(jvae.init_vae_params(jax.random.key(1), jvae.VAEConfig.tiny()))


@pytest.mark.parametrize("which", ["flux_tiny", "flux_dev", "vae_tiny", "vae_flux"])
def test_random_init_has_jax_leaves(which):
    """The port's on-device init makes the JAX tree's leaf names/shapes."""
    if which.startswith("flux"):
        jc = JFluxConfig.tiny() if which == "flux_tiny" else JFluxConfig()
        tc = TFluxConfig.tiny() if which == "flux_tiny" else TFluxConfig()
        want = jax.eval_shape(lambda k: jmodel.init_flux_params(k, jc),
                              jax.random.key(0))
        got = tmodel.flux_param_spec(tc)
    else:
        jc = jvae.VAEConfig.tiny() if which == "vae_tiny" else jvae.VAEConfig()
        tc = tvae.VAEConfig.tiny() if which == "vae_tiny" else tvae.VAEConfig()
        want = jax.eval_shape(lambda k: jvae.init_vae_params(k, jc),
                              jax.random.key(0))
        got = tvae.vae_param_spec(tc)
    shapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            got, is_leaf=lambda x: isinstance(x, tuple))[0]:
        shapes["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)] = tuple(leaf[1])
    assert shapes == tree_shapes(want)
    if which == "flux_tiny":
        t = tmodel.init_flux_params(torch.Generator().manual_seed(0),
                                    TFluxConfig.tiny(), device="cpu")
        assert tree_shapes(t) == tree_shapes(want)
        k = t["dual_blocks"]["attn"]["to_q"]["kernel"]
        assert float(k.abs().max()) <= 1.0 / np.sqrt(k.shape[1])


def test_flux_forward_matches_jax(flux_tree):
    cfg_j, cfg_t = JFluxConfig.tiny(), TFluxConfig.tiny()
    rng = np.random.default_rng(0)
    S_img, S_txt = 24, 8
    hs = rng.normal(size=(1, S_img, cfg_j.in_channels)).astype(np.float32)
    ctx = rng.normal(size=(1, S_txt, cfg_j.joint_attention_dim)).astype(np.float32)
    pooled = rng.normal(size=(1, cfg_j.pooled_projection_dim)).astype(np.float32)
    t = np.array([0.7], np.float32)
    g = np.array([3.5], np.float32)
    img_ids = np.array(jpipe.latent_image_ids(4, 6, offset_y=2))  # writable
    txt_ids = np.zeros((S_txt, 3), np.float32)
    want = jmodel.flux_forward(
        jax.tree.map(jnp.asarray, flux_tree), cfg_j, hs, ctx, t, pooled,
        img_ids, txt_ids, guidance=g)
    got = tmodel.flux_forward(
        params_from_jax(flux_tree, "cpu"), cfg_t, *map(torch.from_numpy, (
            hs, ctx, t, pooled, img_ids, txt_ids)), guidance=torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (1, S_img, 16)
    assert _rel_err(got.numpy(), want) <= REL


@pytest.mark.parametrize("mode", ["encode", "encode_sample", "decode"])
def test_vae_matches_jax(vae_tree, mode):
    jc, tc = jvae.VAEConfig.tiny(), tvae.VAEConfig.tiny()
    rng = np.random.default_rng(1)
    tp = params_from_jax(vae_tree, "cpu")
    jp = jax.tree.map(jnp.asarray, vae_tree)
    if mode == "decode":
        z = rng.normal(size=(1, 8, 12, jc.latent_channels)).astype(np.float32)
        want = jvae.vae_decode(jp, jc, z)
        got = tvae.vae_decode(tp, tc, torch.from_numpy(z))
    else:
        img = rng.uniform(-1, 1, size=(1, 16, 24, 3)).astype(np.float32)
        eps = None
        if mode == "encode_sample":
            eps = rng.normal(size=(1, 8, 12, jc.latent_channels)).astype(np.float32)
        want = jvae.vae_encode(jp, jc, img, sample_eps=eps)
        got = tvae.vae_encode(tp, tc, torch.from_numpy(img),
                              sample_eps=None if eps is None else torch.from_numpy(eps))
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel_err(got.numpy(), want) <= REL


def test_group_norm_two_pass_variance():
    """|mean| = 100 x the spread: the two-pass f32 variance keeps the
    normalized values at f32 accuracy (a float64 reference, and the JAX
    package's group_norm)."""
    rng = np.random.default_rng(2)
    x = (100.0 + rng.normal(size=(1, 4, 4, 8))).astype(np.float32)
    p = {"scale": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)}
    got = tvae.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2),
                          params_from_jax(p, "cpu"), 2).permute(0, 2, 3, 1)
    xg = x.astype(np.float64).reshape(1, 4, 4, 2, 4)
    mean = xg.mean(axis=(1, 2, 4), keepdims=True)
    var = ((xg - mean) ** 2).mean(axis=(1, 2, 4), keepdims=True)
    want = ((xg - mean) / np.sqrt(var + 1e-6)).reshape(x.shape)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    jax_out = jvae.group_norm(jnp.asarray(x), jax.tree.map(jnp.asarray, p), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), atol=1e-4)


def test_merge_lora_matches_jax(flux_tree):
    rng = np.random.default_rng(3)
    adapters = []
    for key in (5, 6):
        lo = _np(jlora.init_lora_params(jax.random.key(key), flux_tree, rank=3))
        adapters.append(jax.tree.map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), lo))
    weights = (1.0, 0.5)
    want = jlora.merge_lora(jax.tree.map(jnp.asarray, flux_tree),
                            list(zip(adapters, weights)))
    base = params_from_jax(flux_tree, "cpu")
    snapshot = {k: v.clone() for k, v in
                base["single_blocks"]["proj_out"].items()}
    got = tlora.merge_lora(base, [(params_from_jax(a, "cpu"), w)
                                  for a, w in zip(adapters, weights)])
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf),
                                   rtol=1e-5, atol=1e-5)
    # the base tree is never written; untargeted leaves are shared
    torch.testing.assert_close(base["single_blocks"]["proj_out"]["kernel"],
                               snapshot["kernel"], rtol=0, atol=0)
    assert got["x_embedder"]["kernel"] is base["x_embedder"]["kernel"]


def test_init_lora_is_zero_effect(flux_tree):
    base = params_from_jax(flux_tree, "cpu")
    lo = tlora.init_lora_params(torch.Generator().manual_seed(0), base, rank=4,
                                device="cpu")
    assert tree_shapes(lo) == tree_shapes(
        _np(jlora.init_lora_params(jax.random.key(0), flux_tree, rank=4)))
    merged = tlora.merge_lora(base, [(lo, 1.0)])
    torch.testing.assert_close(merged["dual_blocks"]["ff"]["in"]["kernel"],
                               base["dual_blocks"]["ff"]["in"]["kernel"])


def test_packing_ids_and_scheduler():
    rng = np.random.default_rng(4)
    lat = rng.normal(size=(1, 8, 12, 4)).astype(np.float32)
    packed = tpipe.pack_latents(torch.from_numpy(lat))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jpipe.pack_latents(lat)))
    np.testing.assert_array_equal(tpipe.unpack_latents(packed, 8, 12).numpy(), lat)
    np.testing.assert_array_equal(
        tpipe.latent_image_ids(3, 5, offset_x=5, offset_y=2, device="cpu").numpy(),
        np.asarray(jpipe.latent_image_ids(3, 5, offset_x=5, offset_y=2)))
    js = jsched.FlowMatchEulerScheduler.create(28, 6144)
    ts = tsched.FlowMatchEulerScheduler.create(28, 6144, device="cpu")
    np.testing.assert_array_equal(ts.sigmas.numpy(), np.asarray(js.sigmas))
    np.testing.assert_array_equal(ts.timesteps.numpy(), np.asarray(js.timesteps))


def test_torch_reference_rng_matches_jax():
    a = jpipe.torch_reference_rng(63, (4, 6), dual_hw=(2, 2), control_hw=(4, 6),
                                  latent_channels=4)
    b = tpipe.torch_reference_rng(63, (4, 6), dual_hw=(2, 2), control_hw=(4, 6),
                                  latent_channels=4)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_run_flux_pipeline_matches_jax(flux_tree, vae_tree):
    """Texture-pass shape: control strip + dual image, injected noise and
    posterior draws, two Euler steps, VAE decode."""
    jc, tc = jvae.VAEConfig.tiny(), tvae.VAEConfig.tiny()
    rng = np.random.default_rng(5)
    H, W, ds = 16, 48, 8
    control = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    dual = rng.uniform(0, 1, (ds, ds, 3)).astype(np.float32)
    C = jc.latent_channels
    noise = rng.normal(size=(H // 2, W // 2, C)).astype(np.float32)
    c_eps = rng.normal(size=(1, H // 2, W // 2, C)).astype(np.float32)
    d_eps = rng.normal(size=(1, ds // 2, ds // 2, C)).astype(np.float32)
    jcfg = jpipe.FluxPipelineConfig(height=H, width=W, num_inference_steps=2,
                                    max_sequence_length=8)
    tcfg = tpipe.FluxPipelineConfig(**dataclasses.asdict(jcfg))
    want = jpipe.run_flux_pipeline(
        jax.tree.map(jnp.asarray, flux_tree), JFluxConfig.tiny(),
        jax.tree.map(jnp.asarray, vae_tree), jc, jax.random.key(0), jcfg,
        control_image=jnp.asarray(control), dual_image=jnp.asarray(dual),
        noise=noise, control_eps=c_eps, dual_eps=d_eps)
    got = tpipe.run_flux_pipeline(
        params_from_jax(flux_tree, "cpu"), TFluxConfig.tiny(),
        params_from_jax(vae_tree, "cpu"), tc, None, tcfg,
        control_image=torch.from_numpy(control), dual_image=torch.from_numpy(dual),
        noise=noise, control_eps=c_eps, dual_eps=d_eps, device="cpu")
    assert tuple(got.shape) == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_deferred_branches_raise():
    with pytest.raises(NotImplementedError):
        tmodel.flux_forward({}, dataclasses.replace(TFluxConfig.tiny(),
                                                    attn_qk8=True),
                            *[None] * 6)
    with pytest.raises(NotImplementedError):
        tpipe.run_flux_pipeline(None, TFluxConfig.tiny(), None,
                                tvae.VAEConfig.tiny(), None,
                                tpipe.FluxPipelineConfig(velocity_reuse=2),
                                device="cpu")
