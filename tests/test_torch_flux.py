"""FLUX in the port (unitex_torch/models/flux) against the JAX package on
one parameter tree: the port's seeded init makes it as numpy (the JAX
init's own compile takes longer than the tests), ``params_from_jax``
carries it into the port and ``jnp.asarray`` into JAX.  The forward is
held on the float tree, on its int8 serving trees and with int8-QK
attention.  Tiny configs, f32, CPU."""

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
from unitex_torch.models.flux import quantize as tquant
from unitex_torch.models.flux.config import FluxConfig as TFluxConfig
from unitex_torch.ops import attention as tattn
from unitex_torch.utils.params import params_from_jax, tree_shapes
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

# f32 on both sides; the differences are summation order over tiny depths
REL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _from_port(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.fixture(scope="module")
def flux_tree():
    return _from_port(tmodel.init_flux_params(
        torch.Generator().manual_seed(0), TFluxConfig.tiny(), device="cpu"))


@pytest.fixture(scope="module")
def vae_tree():
    return _from_port(tvae.init_vae_params(
        torch.Generator().manual_seed(1), tvae.VAEConfig.tiny(), device="cpu"))


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


# int8 trees, relative L2: summation order moves a few activations across
# a rounding boundary, each then one int8 step (1/127 of its row's amax)
# off, as the JAX package's own jit and eager forwards differ; measured
# 0.4-1.1e-4.  Skipping the activation quantization moves the output by
# 7e-4, a fault this limit catches.
INT8_REL_L2 = 3e-4
QK8_REL_L2 = 3e-2   # int8 q/k against float attention: the JAX package's limit
INT8_MODES = {"w8a8": {}, "max_memory": {"weight_only_rest": True},
              "fused": {"fuse": True}}


def _forward_inputs():
    """One transformer call: 8 text + 120 image tokens, S = 128 (which
    tiles into blocks of 128, so ``attn_qk8`` quantizes there)."""
    cfg = JFluxConfig.tiny()
    rng = np.random.default_rng(0)
    return (rng.normal(size=(1, 120, cfg.in_channels)).astype(np.float32),
            rng.normal(size=(1, 8, cfg.joint_attention_dim)).astype(np.float32),
            np.array([0.7], np.float32),
            rng.normal(size=(1, cfg.pooled_projection_dim)).astype(np.float32),
            np.array(jpipe.latent_image_ids(10, 12, offset_y=2)),  # writable
            np.zeros((8, 3), np.float32), np.array([3.5], np.float32))


FORWARD_INPUTS = _forward_inputs()


# one compile of the whole forward instead of one for each of its ops
_jax_flux_forward = jit_reference(jmodel.flux_forward, static_argnums=1)


def _forwards(tree, inputs, tcfg=None):
    """(port, JAX) flux_forward of one numpy tree on the same inputs."""
    *args, g = inputs
    want = _jax_flux_forward(jax.tree.map(jnp.asarray, tree),
                             JFluxConfig.tiny(), *args, guidance=g)
    got = tmodel.flux_forward(params_from_jax(tree, "cpu"),
                              tcfg or TFluxConfig.tiny(),
                              *map(torch.from_numpy, args),
                              guidance=torch.from_numpy(g))
    return got, np.asarray(want)


def test_flux_forward_matches_jax(flux_tree):
    got, want = _forwards(flux_tree, FORWARD_INPUTS)
    assert got.dtype == torch.float32 and got.shape == (1, 120, 16)
    assert _rel_err(got.numpy(), want) <= REL


@pytest.mark.parametrize("mode", list(INT8_MODES))
def test_flux_forward_int8_matches_jax(flux_tree, mode):
    """flux_forward on the W8A8, "max_memory" and fused serving trees
    (quantized by the port, equal to the JAX package's by
    tests/test_torch_quant.py) against JAX's flux_forward on the same
    trees, attn_qk8=False."""
    tree = _from_port(tquant.quantize_flux_params(
        params_from_jax(flux_tree, "cpu"), **INT8_MODES[mode]))
    got, want = _forwards(tree, FORWARD_INPUTS)
    got = got.numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= INT8_REL_L2


def test_flux_forward_qk8_matches_jax(flux_tree, monkeypatch):
    """``attn_qk8=True`` runs B3's plain version in every block on the CPU
    (the JAX package ignores qk8 off the TPU): within JAX's 3 % limit of
    its float attention."""
    calls = []
    plain = tattn.attention_qk8_reference
    monkeypatch.setattr(tattn, "attention_qk8_reference",
                        lambda *a: calls.append(1) or plain(*a))
    tcfg = dataclasses.replace(TFluxConfig.tiny(), attn_qk8=True)
    got, want = _forwards(flux_tree, FORWARD_INPUTS, tcfg=tcfg)
    got = got.numpy()
    assert len(calls) == tcfg.num_layers + tcfg.num_single_layers
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert 0 < rel_l2 < QK8_REL_L2


def test_attached_forward_equals_merged(flux_tree):
    """On a float tree the attached LoRA delta is the merged one (two
    adapters, one re-attached on top): within 1e-5 of max|out|."""
    rng = np.random.default_rng(3)
    base = params_from_jax(flux_tree, "cpu")
    shapes = tlora.init_lora_params(torch.Generator().manual_seed(0), base,
                                    rank=2, device="cpu")
    a, b = (jax.tree.map(lambda x: torch.from_numpy(
        0.3 * rng.normal(size=x.shape).astype(np.float32)), shapes)
        for _ in range(2))
    *args, g = map(torch.from_numpy, FORWARD_INPUTS)
    cfg = TFluxConfig.tiny()
    attached = tlora.attach_lora(tlora.attach_lora(base, [(a, 1.0)]),
                                 [(b, 0.5)])
    att = tmodel.flux_forward(attached, cfg, *args, guidance=g)
    mer = tmodel.flux_forward(tlora.merge_lora(base, [(a, 1.0), (b, 0.5)]),
                              cfg, *args, guidance=g)
    assert _rel_err(att.numpy(), mer.numpy()) <= 1e-5


@pytest.mark.parametrize("mode", ["encode", "encode_sample", "decode"])
def test_vae_matches_jax(vae_tree, mode):
    jc, tc = jvae.VAEConfig.tiny(), tvae.VAEConfig.tiny()
    rng = np.random.default_rng(1)
    tp = params_from_jax(vae_tree, "cpu")
    jp = jax.tree.map(jnp.asarray, vae_tree)
    if mode == "decode":
        z = rng.normal(size=(1, 8, 12, jc.latent_channels)).astype(np.float32)
        want = jit_reference(jvae.vae_decode, static_argnums=1)(jp, jc, z)
        got = tvae.vae_decode(tp, tc, torch.from_numpy(z))
    else:
        img = rng.uniform(-1, 1, size=(1, 16, 24, 3)).astype(np.float32)
        eps = None
        if mode == "encode_sample":
            eps = rng.normal(size=(1, 8, 12, jc.latent_channels)).astype(np.float32)
        want = jit_reference(jvae.vae_encode, static_argnums=1)(jp, jc, img,
                                                          sample_eps=eps)
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


def _lora_shapes(key, flux_tree, rank):
    """The JAX package's LoRA tree for ``flux_tree``, shapes only (traced,
    not compiled)."""
    return jax.eval_shape(
        lambda k: jlora.init_lora_params(k, flux_tree, rank=rank),
        jax.random.key(key))


def test_merge_lora_matches_jax(flux_tree):
    rng = np.random.default_rng(3)
    adapters = []
    for key in (5, 6):
        lo = _lora_shapes(key, flux_tree, 3)
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
    assert tree_shapes(lo) == tree_shapes(_lora_shapes(0, flux_tree, 4))
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
    # one jitted program (eagerly its scan and each op compile apart)
    want = jit_reference(jpipe.run_flux_pipeline, static_argnums=(1, 3, 5))(
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
    for parallel in ({"seq_axis": "seq"}, {"tp_axis": "model"}):
        with pytest.raises(NotImplementedError, match="parallelism"):
            tmodel.flux_forward({}, dataclasses.replace(TFluxConfig.tiny(),
                                                        **parallel),
                                *[None] * 6)
