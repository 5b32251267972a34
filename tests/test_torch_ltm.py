"""The LTM texture-function VAE in the port (unitex_torch/models/ltm.py)
against the JAX package's, on the same numpy inputs and parameter trees,
f32 on the CPU: a tiny tree from the JAX init (carried by
``params_from_jax``) and the repo's trained ``ltm_params.npz``
(``LTMConfig.large()``, read by each package's ``load_params``).  The JAX
side runs under ``jax.jit`` (one compile instead of an eager compile per
op); its fusions move the last bits, so colours are held to 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitex_tpu.models import ltm as jltm
from unitex_tpu.utils.param_cache import load_meta as jload_meta
from unitex_tpu.utils.param_cache import load_params as jload_params

from unitex_torch.models import ltm as tltm
from unitex_torch.utils.param_cache import load_meta as tload_meta
from unitex_torch.utils.param_cache import load_params as tload_params
from unitex_torch.utils.params import params_from_jax, tree_shapes
from torch_cpu_share import share_cpu

share_cpu()

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "ltm_params.npz")
COLOR_TOL = 1e-4   # colours in (0, 1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(seed, n=2000, q=1000, valid_share=0.7):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    val = rng.uniform(size=n) < valid_share
    qs = rng.uniform(-1, 1, (q, 3)).astype(np.float32)
    return pts, cols, val, qs


@pytest.fixture(scope="module")
def tiny():
    """LTMConfig.tiny() with the kernel decoder, so both decode paths have
    their leaves; the JAX init's tree in both packages."""
    cfg = dataclasses.replace(jltm.LTMConfig.tiny(), kernel_decode=True)
    jp = jax.jit(jltm.init_ltm_params, static_argnums=1)(jax.random.key(0), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, tltm.LTMConfig(**dataclasses.asdict(cfg)), jp, tp


@pytest.fixture(scope="module")
def large():
    """The repo's trained tree, read by each package."""
    meta = tload_meta(NPZ)
    assert meta == jload_meta(NPZ)
    jcfg = jltm.LTMConfig(**meta["config"])
    tcfg = tltm.LTMConfig(**meta["config"])
    assert tcfg == tltm.LTMConfig.large()
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jload_params(NPZ)), tload_params(NPZ)


def test_load_params_gives_the_jax_packages_leaves(large):
    _, _, jp, tp = large
    jflat = tree_shapes(jp)
    assert tree_shapes(tp) == jflat and len(jflat) == 113
    assert isinstance(tp["self_blocks"], list) and len(tp["self_blocks"]) == 6
    assert isinstance(tp["cross_more"], list) and len(tp["cross_more"]) == 1
    for (path, jl), tl in zip(jax.tree_util.tree_leaves_with_path(jp),
                              jax.tree_util.tree_leaves(
                                  jax.tree.map(lambda x: x.numpy(), tp))):
        np.testing.assert_array_equal(tl, np.asarray(jl), err_msg=str(path))


def test_init_has_the_jax_layout(tiny):
    jcfg, tcfg, jp, _ = tiny
    tp = tltm.init_ltm_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert tree_shapes(tp) == tree_shapes(jp)
    assert float(tp["residual_gate"]) == 0.0
    assert float(tp["kernel_log_tau"]) == float(jp["kernel_log_tau"])


def test_fourier_features_match_jax():
    x = np.random.default_rng(0).uniform(-1, 1, (64, 3)).astype(np.float32)
    got = tltm.fourier_features(_t(x), 8).numpy()
    want = np.asarray(jax.jit(jltm.fourier_features, static_argnums=1)(x, 8))
    assert got.shape == want.shape == (64, 3 + 48)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _encode_decode(jcfg, tcfg, jp, tp, inputs, with_ctx):
    pts, cols, val, qs = inputs

    def jfn(p, a, b, c, q):
        z, mean, logvar = jltm.encode_geometry(p, jcfg, a, b, c)
        return z, logvar, jltm.decode_field(p, jcfg, z, q,
                                            ctx=(a, b, c) if with_ctx else None)

    jz, jlv, jout = jax.jit(jfn)(jp, pts, cols, val, qs)
    tz, _, tlv = tltm.encode_geometry(tp, tcfg, _t(pts), _t(cols), _t(val))
    tout = tltm.decode_field(tp, tcfg, tz, _t(qs),
                             ctx=(_t(pts), _t(cols), _t(val)) if with_ctx else None)
    return (tz.numpy(), tlv.numpy(), tout.numpy()), (
        np.asarray(jz), np.asarray(jlv), np.asarray(jout))


@pytest.mark.parametrize("with_ctx", [False, True], ids=["latent", "kernel"])
def test_encode_and_decode_match_jax_tiny(tiny, with_ctx):
    jcfg, tcfg, jp, tp = tiny
    got, want = _encode_decode(jcfg, tcfg, jp, tp, _inputs(1, 300, 200), with_ctx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5)


def test_encode_and_decode_match_jax_on_the_trained_tree(large):
    """ltm_params.npz with 2000 context points (70 % valid) and 1000
    queries: the kernel decode with its latent residual."""
    jcfg, tcfg, jp, tp = large
    assert float(tp["residual_gate"]) != 0.0
    (z, _, out), (jz, _, jout) = _encode_decode(jcfg, tcfg, jp, tp, _inputs(2), True)
    np.testing.assert_allclose(z, jz, atol=1e-4, rtol=1e-4)
    assert np.abs(out - jout).max() <= COLOR_TOL
    assert out.std() > 0.05   # not a constant field


def test_subsample_context_matches_jax():
    """A stable sort of the golden-ratio hash keys: the pairs of ``h >> 1``
    and the invalid keys tie, so only the stable order picks JAX's
    subset."""
    rng = np.random.default_rng(3)
    N = 70_000
    pts, cols = (rng.normal(size=(N, 3)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(size=N) < 0.3
    for max_ref in (16384, N):
        got = tltm._subsample_context(_t(pts), _t(cols), _t(mask), max_ref)
        want = jltm._subsample_context(jnp.asarray(pts), jnp.asarray(cols),
                                       jnp.asarray(mask), max_ref)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_query_field_matches_jax_on_the_trained_tree(large):
    """``make_query_field`` of ltm_params.npz as the bake calls it (dense
    texel arrays, a visible and a query mask, 6000 texels): the port
    decodes only the masked queries, 1000 rows at a time past a 2048-point
    context, and returns their colours, zeros elsewhere; the JAX hook
    decodes every row in one slice.  The masked rows agree."""
    jcfg, tcfg, jp, tp = large
    pts, cols, val, _ = _inputs(4, n=6000)
    query = ~val & (np.random.default_rng(5).uniform(size=6000) < 0.8)
    jfield = jltm.make_query_field(jp, jcfg, max_ref=2048)
    want = np.asarray(jax.jit(lambda a, b, c, d: jfield(a, b, a, visible_mask=c,
                                                        query_mask=d))(
        pts, cols, val, query))
    field = tltm.make_query_field(tp, tcfg, chunk=1000, max_ref=2048)
    got = field(_t(pts), _t(cols), _t(pts), visible_mask=_t(val),
                query_mask=_t(query)).numpy()
    assert np.abs(got[query] - want[query]).max() <= COLOR_TOL
    assert (got[~query] == 0).all()
    dense = field(_t(pts), _t(cols), _t(pts), visible_mask=_t(val)).numpy()
    np.testing.assert_allclose(dense[query], got[query], atol=1e-6)


def test_vae_loss_matches_jax(tiny):
    """Reconstruction + KL with the encoder's normal draw injected: JAX
    draws it from its key, the port takes the same draw."""
    jcfg, tcfg, jp, tp = tiny
    pts, cols, val, qs = _inputs(6, 300, 200)
    qc = np.random.default_rng(7).uniform(size=(200, 3)).astype(np.float32)
    key = jax.random.key(11)
    noise = np.asarray(jax.random.normal(key, (jcfg.n_latents, jcfg.kl_latent_dim)))
    want = float(jax.jit(lambda p, k: jltm.ltm_vae_loss(
        p, jcfg, pts, cols, val, qs, qc, k))(jp, key))
    got = float(tltm.ltm_vae_loss(tp, tcfg, _t(pts), _t(cols), _t(val), _t(qs),
                                  _t(qc), noise=_t(noise)))
    assert abs(got - want) <= 1e-5 * abs(want)
