"""SigLIP (``models/siglip.py``) and the Redux image prompt
(``models/flux/redux.py``) in the port against the JAX package, on the
CPU.

Trees come from the port's seeded init (a JAX init compiles for seconds),
the JAX forwards run jitted.  f32 on both sides: the forward and the
projection within 1e-5 of the largest reference value (summation order
over two tiny layers), the converters and loaders exact, the preprocess
bit for bit (both resize with PIL), the Redux tokens through the tiny
FLUX pipeline within 1e-4 as ``tests/test_torch_flux.py`` holds the
pipeline.  ``transformers`` stands in as a module for the host fall-back."""

import dataclasses
import json
import logging
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from unitex_tpu.models import siglip as jsig
from unitex_tpu.models.flux import pipeline as jpipe
from unitex_tpu.models.flux import redux as jredux
from unitex_tpu.models.flux import vae as jvae
from unitex_tpu.models.flux.config import FluxConfig as JFluxConfig

from unitex_torch.models import siglip as tsig
from unitex_torch.models.flux import model as tmodel
from unitex_torch.models.flux import pipeline as tpipe
from unitex_torch.models.flux import redux as tredux
from unitex_torch.models.flux import vae as tvae
from unitex_torch.models.flux.config import FluxConfig as TFluxConfig
from unitex_torch.utils.params import params_from_jax, tree_shapes
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

REL = 1e-5        # f32 forwards, of the largest reference value
PIPE_ATOL = 1e-4  # the tiny FLUX pipeline, as test_torch_flux.py holds it
CFG_T = tsig.SiglipVisionConfig.tiny()
CFG_J = jsig.SiglipVisionConfig.tiny()
T5_TINY = TFluxConfig.tiny().joint_attention_dim


def _np(tree):
    return jax.tree.map(lambda t: t.numpy() if torch.is_tensor(t) else np.asarray(t),
                        tree)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _assert_trees_equal(a, b):
    fa, fb = jax.tree_util.tree_leaves_with_path(_np(a)), jax.tree_util.tree_leaves_with_path(_np(b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(x, y, err_msg=str(p))


def _hf_state_dict(cfg, seed=0):
    """A random HF ``SiglipVisionModel`` state dict of ``cfg``'s shapes."""
    rng = np.random.default_rng(seed)
    d, m, p = cfg.hidden_size, cfg.mlp_dim, cfg.patch_size

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.1

    sd = {"vision_model.embeddings.patch_embedding.weight": r(d, cfg.num_channels, p, p),
          "vision_model.embeddings.patch_embedding.bias": r(d),
          "vision_model.embeddings.position_embedding.weight": r(cfg.num_patches, d),
          "vision_model.post_layernorm.weight": 1 + r(d),
          "vision_model.post_layernorm.bias": r(d)}
    for i in range(cfg.num_layers):
        pre = f"vision_model.encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{pre}.{ln}.weight"] = 1 + r(d)
            sd[f"{pre}.{ln}.bias"] = r(d)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{pre}.self_attn.{proj}.weight"] = r(d, d)
            sd[f"{pre}.self_attn.{proj}.bias"] = r(d)
        sd[f"{pre}.mlp.fc1.weight"], sd[f"{pre}.mlp.fc1.bias"] = r(m, d), r(m)
        sd[f"{pre}.mlp.fc2.weight"], sd[f"{pre}.mlp.fc2.bias"] = r(d, m), r(d)
    return sd


def _image(seed=0, size=(40, 52)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (*size, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def sig_tree():
    return _np(tsig.init_siglip_params(torch.Generator().manual_seed(0), CFG_T,
                                       device="cpu"))


@pytest.fixture(scope="module")
def redux_tree():
    return _np(tredux.init_redux_params(torch.Generator().manual_seed(1),
                                        CFG_T.hidden_size, T5_TINY, device="cpu"))


@pytest.fixture(scope="module")
def jax_forward():
    return jit_reference(jsig.siglip_forward, static_argnums=1)


def test_siglip_forward_and_preprocess_match_jax(sig_tree, jax_forward):
    """The tiny tower from one tree on one image: the preprocess bit for
    bit, the forward within ``REL``; 4 heads of 8, so the attention is the
    plain one in both packages."""
    img = _image()
    px_j = np.asarray(jsig.preprocess_siglip(img, CFG_J))
    px_t = tsig.preprocess_siglip(img, CFG_T, device="cpu")
    np.testing.assert_array_equal(px_t.numpy(), px_j)
    want = np.asarray(jax_forward(jax.tree.map(jnp.asarray, sig_tree), CFG_J,
                                  jnp.asarray(px_j)))
    got = tsig.siglip_forward(params_from_jax(sig_tree, "cpu"), CFG_T, px_t)
    assert tuple(got.shape) == (1, CFG_T.num_patches, CFG_T.hidden_size)
    assert _rel_err(got.numpy(), want) <= REL


def test_converter_and_config_from_state_dict_match_jax():
    sd = _hf_state_dict(CFG_T)
    assert tsig.siglip_config_from_sd(sd) == tsig.SiglipVisionConfig(
        **dataclasses.asdict(jsig.siglip_config_from_sd(sd)))
    _assert_trees_equal(tsig.convert_siglip_vision(sd, CFG_T, device="cpu"),
                        jsig.convert_siglip_vision(sd, CFG_J))


@pytest.mark.parametrize("hf_config", [False, True], ids=["shapes", "config_json"])
def test_load_siglip_matches_jax(tmp_path, hf_config):
    """A safetensors file (and its directory) with and without an HF
    ``config.json``, which sets the heads, activation and eps."""
    sd = _hf_state_dict(CFG_T, seed=2)
    save_file(sd, str(tmp_path / "model.safetensors"))
    if hf_config:
        (tmp_path / "config.json").write_text(json.dumps({"vision_config": {
            "num_attention_heads": 2, "hidden_act": "gelu",
            "layer_norm_eps": 1e-5}}))
    for path in (tmp_path / "model.safetensors", tmp_path):
        p_t, c_t = tsig.load_siglip(str(path), device="cpu")
        p_j, c_j = jsig.load_siglip(str(path))
        assert dataclasses.asdict(c_t) == dataclasses.asdict(c_j)
        assert c_t.num_heads == (2 if hf_config else 1)  # 32 // 72 -> 1
        _assert_trees_equal(p_t, p_j)


def test_so400m_shapes_from_the_seeded_init():
    """The full-width tree of the port's init has the JAX init's shapes
    (the JAX side by ``jax.eval_shape``: its init compiles for ~20 s; the
    port's on the meta device, which draws nothing)."""
    cfg = tsig.SiglipVisionConfig.so400m_384()
    assert cfg.num_patches == 729 and cfg.hidden_size // cfg.num_heads == 72
    want = jax.eval_shape(lambda k: jsig.init_siglip_params(
        k, jsig.SiglipVisionConfig.so400m_384()), jax.random.key(0))
    got = tsig.init_siglip_params(torch.Generator().manual_seed(0), cfg,
                                  device="meta")
    assert tree_shapes(got) == tree_shapes(want)
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(got))
    assert sum(t.numel() for t in jax.tree.leaves(got)) == 412_987_248
    redux = tredux.init_redux_params(torch.Generator().manual_seed(1), device="meta")
    assert tree_shapes(redux) == tree_shapes(jax.eval_shape(
        jredux.init_redux_params, jax.random.key(0)))


def test_redux_project_and_ids_match_jax(redux_tree):
    feats = np.random.default_rng(3).normal(size=(2, 5, CFG_T.hidden_size)).astype(np.float32)
    want = np.asarray(jit_reference(jredux.redux_project)(
        jax.tree.map(jnp.asarray, redux_tree), jnp.asarray(feats)))
    got = tredux.redux_project(params_from_jax(redux_tree, "cpu"),
                               torch.from_numpy(feats))
    assert _rel_err(got.numpy(), want) <= REL
    np.testing.assert_array_equal(tredux.redux_image_ids(7, device="cpu").numpy(),
                                  np.asarray(jredux.redux_image_ids(7)))


def _write_root(root, sig_sd, redux_tree, cfg_heads=4):
    (root / "siglip").mkdir(parents=True)
    save_file(sig_sd, str(root / "siglip" / "model.safetensors"))
    (root / "siglip" / "config.json").write_text(json.dumps(
        {"num_attention_heads": cfg_heads}))
    (root / "flux" / "redux").mkdir(parents=True)
    save_file({f"redux_{k}.{leaf}": np.ascontiguousarray(
        redux_tree[k]["kernel"].T if leaf == "weight" else redux_tree[k]["bias"])
        for k in ("up", "down") for leaf in ("weight", "bias")},
        str(root / "flux" / "redux" / "model.safetensors"))


def test_redux_conditioner_from_a_root_matches_jax(tmp_path, redux_tree, caplog):
    """The conditioner reads both trees from ``<root>`` and takes the
    port's tower; its tokens match the JAX conditioner's.  A projection
    file without the expected tensors is a warning that names its
    directory, and the call then refuses."""
    _write_root(tmp_path, _hf_state_dict(CFG_T, seed=4), redux_tree)
    img = _image(5)
    cond = tredux.ReduxConditioner(str(tmp_path), device="cpu")
    assert cond.backend == "port"
    _assert_trees_equal(cond.params, redux_tree)
    emb, ids = cond(img)
    j_emb, j_ids = jredux.ReduxConditioner(str(tmp_path))(img)
    assert tuple(emb.shape) == (1, CFG_T.num_patches, T5_TINY)
    assert _rel_err(emb.numpy(), np.asarray(j_emb)) <= REL
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))

    broken = tmp_path / "broken"
    (broken / "flux" / "redux").mkdir(parents=True)
    save_file({"unrelated": np.zeros(3, np.float32)},
              str(broken / "flux" / "redux" / "model.safetensors"))
    with caplog.at_level(logging.WARNING, logger=tredux.__name__):
        cond = tredux.ReduxConditioner(str(broken), device="cpu")
    assert cond.params is None and jredux.ReduxConditioner(str(broken)).params is None
    assert str(broken / "flux" / "redux") in caplog.text and "KeyError" in caplog.text
    with pytest.raises(RuntimeError, match="projection"):
        cond(siglip_features=np.zeros((1, 4, CFG_T.hidden_size), np.float32))


def test_redux_conditioner_falls_back_to_transformers(tmp_path, monkeypatch, caplog,
                                                     sig_tree, redux_tree):
    """A SigLIP file the port cannot read (no tower tensors: a KeyError,
    which the JAX package also falls through) is a warning; then
    ``transformers``' ``SiglipVisionModel`` (a stand-in here, computing
    the port's forward) encodes on the host, in both packages alike."""
    sig_t = params_from_jax(sig_tree, "cpu")

    class Processor:
        @classmethod
        def from_pretrained(cls, path):
            cls.path = path
            return cls()

        def __call__(self, images, return_tensors):
            return {"pixel_values": tsig.preprocess_siglip(images, CFG_T, "cpu")}

    class Model:
        @classmethod
        def from_pretrained(cls, path):
            return cls()

        def eval(self):
            return self

        def __call__(self, pixel_values):
            return types.SimpleNamespace(
                last_hidden_state=tsig.siglip_forward(sig_t, CFG_T, pixel_values))

    fake = types.ModuleType("transformers")
    fake.SiglipImageProcessor, fake.SiglipVisionModel = Processor, Model
    monkeypatch.setitem(sys.modules, "transformers", fake)
    _write_root(tmp_path, {"unrelated": np.zeros(3, np.float32)}, redux_tree)
    img = _image(6)
    with caplog.at_level(logging.WARNING, logger=tredux.__name__):
        cond = tredux.ReduxConditioner(str(tmp_path), device="cpu")
    assert cond.backend == "transformers" and cond.tower is None
    assert str(tmp_path / "siglip") in caplog.text and "KeyError" in caplog.text
    emb, _ = cond(img)
    j_cond = jredux.ReduxConditioner(str(tmp_path))
    assert j_cond.siglip_jax is None and j_cond.siglip is not None
    assert _rel_err(emb.numpy(), np.asarray(j_cond(img)[0])) <= REL

    monkeypatch.setitem(sys.modules, "transformers", None)   # not installed
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=tredux.__name__):
        cond = tredux.ReduxConditioner(str(tmp_path), device="cpu")
    assert cond.backend is None and "ModuleNotFoundError" in caplog.text
    with pytest.raises(RuntimeError, match="siglip_features"):
        cond(img)


def test_redux_tokens_through_the_flux_pipeline_match_jax(redux_tree):
    """The Redux tokens as ``prompt_embeds`` of the tiny FLUX pipeline (the
    texture pass's control strip and dual image, two steps): the text
    stream takes their length, not ``max_sequence_length``."""
    flux_tree = _np(tmodel.init_flux_params(torch.Generator().manual_seed(0),
                                            TFluxConfig.tiny(), device="cpu"))
    vae_tree = _np(tvae.init_vae_params(torch.Generator().manual_seed(1),
                                        tvae.VAEConfig.tiny(), device="cpu"))
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(1, CFG_T.num_patches, CFG_T.hidden_size)).astype(np.float32)
    embeds = np.array(jredux.redux_project(jax.tree.map(jnp.asarray, redux_tree),
                                             jnp.asarray(feats)))
    jc, tc = jvae.VAEConfig.tiny(), tvae.VAEConfig.tiny()
    H, W, ds = 16, 48, 8
    C = jc.latent_channels
    control = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    dual = rng.uniform(0, 1, (ds, ds, 3)).astype(np.float32)
    noise = rng.normal(size=(H // 2, W // 2, C)).astype(np.float32)
    jcfg = jpipe.FluxPipelineConfig(height=H, width=W, num_inference_steps=2,
                                    max_sequence_length=8)
    tcfg = tpipe.FluxPipelineConfig(**dataclasses.asdict(jcfg))
    want = jit_reference(jpipe.run_flux_pipeline, static_argnums=(1, 3, 5))(
        jax.tree.map(jnp.asarray, flux_tree), JFluxConfig.tiny(),
        jax.tree.map(jnp.asarray, vae_tree), jc, jax.random.key(0), jcfg,
        control_image=jnp.asarray(control), dual_image=jnp.asarray(dual),
        prompt_embeds=jnp.asarray(embeds), noise=noise)
    got = tpipe.run_flux_pipeline(
        params_from_jax(flux_tree, "cpu"), TFluxConfig.tiny(),
        params_from_jax(vae_tree, "cpu"), tc, None, tcfg,
        control_image=torch.from_numpy(control), dual_image=torch.from_numpy(dual),
        prompt_embeds=torch.from_numpy(embeds), noise=noise, device="cpu")
    assert tuple(got.shape) == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PIPE_ATOL)
