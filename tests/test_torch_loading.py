"""Checkpoint and adapter loading, velocity reuse and the matting builder
in the port, against the JAX package on the CPU.

State dicts are seeded numpy (``tests/test_pipeline.py``'s FLUX state
dict, ``chip_smoke.py``'s tree -> diffusers names for the VAE and the
checkpoint), at ``FluxConfig.tiny()`` / ``VAEConfig.tiny()``.  Mappings
and adapter files must give exactly the JAX package's trees; int8 kernels
quantized from them may sit one step apart on at most 0.01 % of the
entries (tests/test_torch_quant.py's rule: a value on a rounding boundary
after f32 arithmetic in another order).
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.numpy import save_file as save_numpy

from unitex_tpu.image import rembg as jrembg
from unitex_tpu.models.flux import loader as jloader
from unitex_tpu.models.flux import lora as jlora
from unitex_tpu.models.flux import pipeline as jfpipe
from unitex_tpu.models.flux import scheduler as jsched
from unitex_tpu.models.flux.config import FluxConfig as JFluxConfig
from unitex_tpu.models.flux.vae import VAEConfig as JVAEConfig
from unitex_tpu.pipeline import CustomRGBTextureFullPipeline as JPipeline

from unitex_torch.image import rembg as trembg
from unitex_torch.models.flux import loader as tloader
from unitex_torch.models.flux import lora as tlora
from unitex_torch.models.flux import pipeline as tfpipe
from unitex_torch.models.flux import scheduler as tsched
from unitex_torch.models.flux.config import FluxConfig as TFluxConfig
from unitex_torch.models.flux.lora import init_lora_params
from unitex_torch.models.flux.model import init_flux_params
from unitex_torch.models.flux.vae import VAEConfig as TVAEConfig
from unitex_torch.models.flux.vae import init_vae_params
from unitex_torch.pipeline import CustomRGBTextureFullPipeline as TPipeline
from unitex_torch.utils.params import params_from_jax

import test_pipeline
from test_golden_parity import small_config
from test_torch_pipeline import _port_config
from torch_cpu_share import share_cpu

share_cpu()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = JFluxConfig.tiny()
DENOISE_ATOL = 1e-4   # tests/test_torch_flux.py's run_flux_pipeline parity


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _chip_smoke()


def _flat(tree, prefix=""):
    """{"a/0/b": numpy array} of a tree of dicts and lists of tensors or
    arrays; bf16 comes out as f32 (the dtype's name is kept beside it)."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if torch.is_tensor(tree):
        name = str(tree.dtype).removeprefix("torch.")
        arr = tree.float().numpy() if tree.dtype == torch.bfloat16 else tree.numpy()
    else:
        name = str(np.asarray(tree).dtype)
        arr = np.asarray(tree)
        arr = arr.astype(np.float32) if name == "bfloat16" else arr
    return {prefix: (name, arr)}


def _assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for path, (dtype, arr) in w.items():
        assert g[path][0] == dtype, path
        assert g[path][1].shape == arr.shape, path
        if dtype == "int8":
            diff = np.abs(g[path][1].astype(np.int32) - arr.astype(np.int32))
            assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-4, path
        else:
            np.testing.assert_array_equal(g[path][1], arr, err_msg=path)


def _seeded(tree, seed, scale=0.05):
    """The same structure of seeded normal f32 values (torch, CPU)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda t: torch.from_numpy(
            (scale * rng.standard_normal(t.shape)).astype(np.float32)), tree)


@pytest.fixture(scope="module")
def trees():
    gen = torch.Generator()
    flux = _seeded(init_flux_params(gen.manual_seed(0), TFluxConfig.tiny(),
                                    device="cpu"), 0)
    lora = init_lora_params(gen.manual_seed(2), flux, rank=2, device="cpu")
    return {
        "flux": flux,
        "vae": _seeded(init_vae_params(gen.manual_seed(1), TVAEConfig.tiny(),
                                       device="cpu"), 1),
        "texture": _seeded(lora, 2),
        "delight": _seeded(lora, 3),
    }


@pytest.fixture(scope="module")
def checkpoint(trees, tmp_path_factory):
    """A tiny checkpoint root written by chip_smoke.py's writer: the
    transformer in shards of at most 1 MB."""
    root = str(tmp_path_factory.mktemp("ckpt") / "models")
    chip_smoke.write_checkpoint(root, trees["flux"], trees["vae"],
                                {k: trees[k] for k in ("texture", "delight")},
                                shard_bytes=1e6)
    return root


# --------------------------------------------------------------- mappings


def test_flux_state_dict_mapping_matches_jax():
    sd = test_pipeline.TestLoaders._fake_state_dict(None, TINY)
    want = jloader.flux_params_from_state_dict(sd, TINY)
    got = tloader.flux_params_from_state_dict(sd, TFluxConfig.tiny(),
                                              device="cpu")
    _assert_trees_equal(got, want)


def test_vae_state_dict_mapping_matches_jax(trees):
    sd = {k: t.contiguous().numpy()
          for k, t in chip_smoke.vae_state_dict(trees["vae"])}
    want = jloader.vae_params_from_state_dict(sd, JVAEConfig.tiny())
    got = tloader.vae_params_from_state_dict(sd, TVAEConfig.tiny(),
                                             device="cpu")
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, trees["vae"])


def test_sharded_directory_reads_through_loader(checkpoint, trees):
    """Both packages read the sharded transformer directory to the tree
    it was written from; the port also casts on the way (bf16)."""
    tdir = os.path.join(checkpoint, "flux", "transformer")
    assert len(os.listdir(tdir)) > 3
    got = tloader.load_flux_transformer(tdir, TFluxConfig.tiny(), device="cpu")
    _assert_trees_equal(got, trees["flux"])
    _assert_trees_equal(got, jloader.load_flux_transformer(tdir, TINY))
    bf16 = tloader.load_flux_transformer(tdir, TFluxConfig.tiny(), device="cpu",
                                         dtype=torch.bfloat16)
    _assert_trees_equal(bf16, jax.tree.map(lambda t: t.to(torch.bfloat16),
                                           trees["flux"]))


def test_missing_safetensors_raise_file_not_found(tmp_path):
    for path in (str(tmp_path / "none"), str(tmp_path)):
        with pytest.raises(FileNotFoundError):
            tloader.load_vae(path, TVAEConfig.tiny(), device="cpu")


# ------------------------------------------------------------ LoRA files


def _lora_case(case, lora, path):
    """Write ``lora`` as ``case`` says; return it as both packages must read
    it back."""
    n = (TINY.num_layers, TINY.num_single_layers)
    if case == "jax_writes":
        jlora.save_lora_safetensors(path, jax.tree.map(np.asarray, lora))
        return lora
    tlora.save_lora_safetensors(path, lora)
    if case == "port_writes":
        return lora
    from safetensors.numpy import load_file

    sd = load_file(path)
    if case == "peft_prefix":
        sd = {"base_model.model." + k[len("transformer."):]: v
              for k, v in sd.items()}
        save_numpy(sd, path)
        return lora
    # missing_layer: layer 1 of the dual to_q adapter is left out: zeros
    assert case == "missing_layer" and n[0] > 1
    save_numpy({k: v for k, v in sd.items()
                if not k.startswith("transformer.transformer_blocks.1.attn.to_q.")},
               path)
    want = jax.tree.map(lambda t: t.clone(), lora)
    for leaf in want["dual_blocks"]["attn"]["to_q"].values():
        leaf[1] = 0.0
    return want


@pytest.mark.parametrize("case", ["jax_writes", "port_writes", "peft_prefix",
                                  "missing_layer"])
def test_lora_files_read_the_same_in_both_packages(trees, tmp_path, case):
    path = str(tmp_path / "lora.safetensors")
    want = _lora_case(case, trees["texture"], path)
    n = (TINY.num_layers, TINY.num_single_layers)
    _assert_trees_equal(tlora.load_lora_safetensors(path, *n, device="cpu"), want)
    _assert_trees_equal(jlora.load_lora_safetensors(path, *n), want)


# --------------------------------------------------- the pipeline's loader


@pytest.fixture
def tiny_configs(monkeypatch):
    """Both pipelines build FluxConfig.tiny() / VAEConfig.tiny()."""
    for cls in (JFluxConfig, TFluxConfig):
        monkeypatch.setattr(cls, "flux1_dev", cls.tiny)
    for cls in (JVAEConfig, TVAEConfig):
        monkeypatch.setattr(cls, "flux", cls.tiny)


@pytest.mark.parametrize("mode", [False, True, "max_memory"],
                         ids=["bf16", "int8", "max_memory"])
def test_try_load_weights_matches_jax(checkpoint, tiny_configs, tmp_path, mode):
    """The serving tree (bf16, or quantized from it), VAE and both
    adapters the two packages load from one checkpoint; the port's
    params cache of it (with the checkpoint's fingerprint) is read back
    by the port, in place of the checkpoint, and by the JAX package."""
    jpipe = JPipeline(pretrain_models=checkpoint, config=small_config(),
                      int8_serving=mode, require_weights=True)
    tpipe = TPipeline(pretrain_models=checkpoint, config=_port_config(),
                      int8_serving=mode, require_weights=True,
                      params_cache=str(tmp_path), device="cpu")
    assert tpipe._flux_loaded
    for attr in ("transformer_params", "vae_params", "texture_lora",
                 "delight_lora"):
        _assert_trees_equal(getattr(tpipe, attr), getattr(jpipe, attr))
    if mode:
        k8 = tpipe.transformer_params["single_blocks"]["proj_out"]["kernel_int8"]
        assert k8.stride()[-2] == 1  # the int8 GEMM's layout
    again = TPipeline(pretrain_models=checkpoint, config=_port_config(),
                      int8_serving=mode, params_cache=str(tmp_path),
                      device="cpu")
    _assert_trees_equal(again.transformer_params, tpipe.transformer_params)
    reader = JPipeline(pretrain_models=None, config=small_config(),
                       int8_serving=mode, params_cache=str(tmp_path))
    reader.pretrain_models = checkpoint
    assert reader._load_cached_tree("flux") is not None


def test_missing_checkpoint_runs_weightless(checkpoint, tiny_configs, tmp_path,
                                            capsys):
    """A root without the files: the JAX package's message and the
    weightless pipeline, or FileNotFoundError under require_weights; a
    root with the transformer but no VAE sets no tree."""
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    pipe = TPipeline(pretrain_models=empty, config=_port_config(), device="cpu")
    assert not pipe._flux_loaded and pipe.transformer_params is None
    assert "FLUX weights not found" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        TPipeline(pretrain_models=empty, require_weights=True,
                  config=_port_config(), device="cpu")
    with pytest.raises(FileNotFoundError):
        TPipeline(require_weights=True, config=_port_config(), device="cpu")
    partial = tmp_path / "partial" / "flux"
    os.makedirs(partial)
    os.symlink(os.path.join(checkpoint, "flux", "transformer"),
               partial / "transformer")
    pipe = TPipeline(pretrain_models=str(partial.parent), config=_port_config(),
                     device="cpu")
    assert not pipe._flux_loaded and pipe.transformer_params is None


@pytest.mark.parametrize("root", ["checkpoint", "missing", None])
def test_cache_meta_matches_jax(checkpoint, tmp_path, root):
    root = {"checkpoint": checkpoint, "missing": str(tmp_path / "x"),
            None: None}[root]
    jpipe = JPipeline(pretrain_models=None, config=small_config())
    tpipe = TPipeline(config=_port_config(), device="cpu")
    jpipe.pretrain_models = tpipe.pretrain_models = root
    for kind in ("flux", TPipeline.RANDOM_KIND):
        assert tpipe._cache_meta(kind) == jpipe._cache_meta(kind)


# --------------------------------------------------------- velocity reuse


@pytest.mark.parametrize("steps", [6, 28, 50])
@pytest.mark.parametrize("reuse", [0, 2, 8, 30])
def test_make_reuse_mask_matches_jax(steps, reuse):
    want = jfpipe.make_reuse_mask(steps, reuse)
    got = tfpipe.make_reuse_mask(steps, reuse)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, np.asarray(want))


def test_make_reuse_mask_of_the_fast_cli_job():
    mask = tfpipe.make_reuse_mask(28, 8)
    assert list(np.nonzero(mask)[0]) == [10, 12, 15, 17, 19, 21, 24, 26]


def test_denoise_with_reuse_matches_jax(monkeypatch):
    """``denoise`` over 10 steps with 3 extrapolated (4, 6 and 8, so step
    6 extrapolates from an extrapolated velocity), against the JAX
    ``lax.cond`` loop on the same tree and noise; the port calls the
    transformer once for each step not reused."""
    steps, reuse = 10, 3
    from unitex_torch.models.flux import model as tmodel

    flux = jax.tree.map(lambda t: t.numpy(), init_flux_params(
        torch.Generator().manual_seed(0), TFluxConfig.tiny(), device="cpu"))
    rng = np.random.default_rng(5)
    S, C = 24, TINY.in_channels
    noise = rng.normal(size=(1, S, C)).astype(np.float32)
    cond = rng.normal(size=(1, 8, C)).astype(np.float32)
    img_ids = np.array(jfpipe.latent_image_ids(4, 8))
    txt_ids = np.zeros((4, 3), np.float32)
    prompt = rng.normal(size=(1, 4, TINY.joint_attention_dim)).astype(np.float32)
    pooled = rng.normal(size=(1, TINY.pooled_projection_dim)).astype(np.float32)
    mask = tfpipe.make_reuse_mask(steps, reuse)
    sched = jsched.FlowMatchEulerScheduler.create(steps, S)
    jmask = jfpipe.make_reuse_mask(steps, reuse)
    # one jitted program (eagerly the scan and each op compile apart)
    want = jax.jit(lambda tree, x, c: jfpipe.denoise(
        tree, TINY, x, img_ids, txt_ids, prompt, pooled, sched, 3.5,
        condition_latents=c, reuse_mask=jmask))(
        jax.tree.map(jax.numpy.asarray, flux), noise, cond)
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return tmodel.flux_forward(*args, **kwargs)

    monkeypatch.setattr(tfpipe, "flux_forward", counted)
    got = tfpipe.denoise(
        params_from_jax(flux, "cpu"), TFluxConfig.tiny(), torch.from_numpy(noise),
        torch.from_numpy(img_ids), torch.from_numpy(txt_ids),
        torch.from_numpy(prompt), torch.from_numpy(pooled),
        tsched.FlowMatchEulerScheduler.create(steps, S, device="cpu"), 3.5,
        condition_latents=torch.from_numpy(cond), reuse_mask=mask)
    assert len(calls) == steps - int(mask.sum()) == steps - reuse
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DENOISE_ATOL)


def test_run_flux_pipeline_passes_velocity_reuse(monkeypatch):
    """``FluxPipelineConfig.velocity_reuse`` reaches ``denoise`` as the
    mask of ``make_reuse_mask``."""
    seen = {}

    def fake_denoise(*args, reuse_mask=None, **kwargs):
        seen["mask"] = reuse_mask
        return args[2]

    monkeypatch.setattr(tfpipe, "denoise", fake_denoise)
    monkeypatch.setattr(tfpipe, "vae_decode",
                        lambda p, c, lat: torch.zeros(1, 8, 8, 3))
    tfpipe.run_flux_pipeline(
        None, TFluxConfig.tiny(), None, TVAEConfig.tiny(),
        torch.Generator().manual_seed(0),
        tfpipe.FluxPipelineConfig(height=16, width=16, num_inference_steps=28,
                                  max_sequence_length=4, velocity_reuse=8),
        device="cpu")
    np.testing.assert_array_equal(seen["mask"], tfpipe.make_reuse_mask(28, 8))


# --------------------------------------------------------------- matting


def test_background_remover_without_learned_weights_is_the_heuristic(tmp_path):
    """No root, or a root without learned-matting weights: the heuristic,
    with the JAX package's mask."""
    img = np.full((96, 128, 3), 240, np.uint8)
    img[20:70, 30:100] = [200, 60, 30]
    img[5:9, 5:9] = [10, 10, 10]   # a second, smaller blob
    image = Image.fromarray(img)
    want = np.asarray(jrembg.build_background_remover(str(tmp_path))(image))
    for root in (None, str(tmp_path)):
        remover = trembg.build_background_remover(root)
        assert isinstance(remover, trembg.SaliencyRemover)
        np.testing.assert_array_equal(np.asarray(remover(image)), want)
