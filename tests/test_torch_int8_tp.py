"""int8 serving, the serving-tree cache and T5 across gloo ranks on the
CPU, against the JAX package's one-device functions and the port's one
rank.

One spawn of two ranks (``tests/torch_dist_workers.int8_tp_worker``, a
``model = 2`` mesh) serves the module; the JAX references and the one-rank
cache files are computed here while the ranks run:

* each rank's cut int8 tree, for W8A8 and "max_memory", is the slices of
  the one-device quantized tree bit for bit (a row kernel's ``scale``
  whole on every rank: the one-device scale over the whole d_in), whether
  the whole tree is quantized then cut or each node as it is made;
* the W8A8 row product with the row's amax reduced over the ranks and
  int32 partials summed is the one-device product bit for bit, where a
  per-rank amax is not;
* the TP FLUX forward in both modes with an adapter attached, against the
  JAX package's ``quantize_flux_params`` + ``attach_lora`` +
  ``flux_forward``; the TP SD3 forward in W8A8 against JAX's
  ``quantize_linears`` + ``sd3_forward``; the SR stage on the mesh in
  W8A8 against one rank, ``host_params`` refused;
* a cache written on two ranks is the one-rank file leaf for leaf, and
  read back on the mesh gives each rank its slices, int4 included;
* the TP T5 encoder against ``text_jax.t5_encoder_forward``.

Tolerances: the slices and the row product exact; the forwards and the SR
image within 1e-5 of max|ref| (f32, other summation orders), but for
"max_memory"'s FLUX forward: 5e-5, one W8A8 activation's int8 step
(``test_int8_tp_forward_matches_jax``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitex_tpu.models.flux import lora as jlora
from unitex_tpu.models.flux import model as jflux
from unitex_tpu.models.flux import quantize as jfq
from unitex_tpu.models.flux.config import FluxConfig as JFluxConfig
from unitex_tpu.models.sd3 import model as jsd3
from unitex_tpu.models.sd3.config import SD3Config as JSD3Config
from unitex_tpu.models import text_jax as jtext
from unitex_tpu.ops import quant as jquant

from unitex_torch.models.flux.config import FluxConfig
from unitex_torch.models.flux.lora import attach_lora
from unitex_torch.models.flux.model import flux_forward
from unitex_torch.models.flux.quantize import quantize_flux_params
from unitex_torch.models.flux.vae import VAEConfig, init_vae_params
from unitex_torch.models.text import init_t5_encoder_params
from unitex_torch.ops.quant import quantize_kernel, unpack_int4_tree, pack_int4_tree
from unitex_torch.parallel.sharding import shard_node, shard_tree
from unitex_torch.utils.param_cache import load_params

import torch_dist_workers as workers
from test_torch_parallel import FLUX_ARGS, SD3_ARGS, _jax_args, _nested, make_inputs
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

REL = 1e-5
# the TP FLUX forwards, by int8 mode (test_int8_tp_forward_matches_jax)
FWD_REL = {"w8a8": 1e-5, "max_memory": 5e-5}
N = 2   # the model axis


def _close(got, want, rel=REL):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


def _inputs(d) -> dict:
    inputs = make_inputs()
    rng = np.random.default_rng(11)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    q, s = quantize_kernel(torch.from_numpy(w))
    inputs["row/x"] = rng.normal(size=(3, 5, 64)).astype(np.float32)
    inputs["row/q"], inputs["row/scale"] = q.contiguous().numpy(), s.numpy()
    cfg = workers.t5_config()
    inputs.update(workers._prefixed("t5", init_t5_encoder_params(
        torch.Generator().manual_seed(4), cfg, device="cpu")))
    inputs["t5_ids"] = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int64)
    inputs.update(workers._prefixed("sd3vae", init_vae_params(
        torch.Generator().manual_seed(6), VAEConfig.tiny(), device="cpu")))
    inputs["sr_image"] = rng.uniform(size=(20, 24, 3)).astype(np.float32)
    inputs["cache_dir"] = np.array(str(d / "mesh_cache"))
    return inputs


def _jax_references(inputs, d) -> dict:
    flux, cfg = _nested(inputs, "flux"), JFluxConfig.tiny()
    lora = _nested(inputs, "lora")
    args = _jax_args(inputs, "x", FLUX_ARGS)
    refs = {}
    for name, mode in workers.INT8_MODES.items():
        served = jlora.attach_lora(jfq.quantize_flux_params(
            flux, weight_only_rest=mode == "max_memory"), [(lora, 1.0)])
        refs[f"{name}/forward"] = np.asarray(jit_reference(
            jflux.flux_forward, static_argnums=1)(served, cfg, *args))
        one = attach_lora(quantize_flux_params(
            workers.unflatten(inputs, "flux"),
            weight_only_rest=mode == "max_memory"),
            [(workers.unflatten(inputs, "lora"), 1.0)])
        refs[f"{name}/one_rank"] = flux_forward(
            one, FluxConfig.tiny(), *workers._flux_args(inputs)).numpy()
    refs["sd3"] = np.asarray(jit_reference(jsd3.sd3_forward, static_argnums=1)(
        jquant.quantize_linears(_nested(inputs, "sd3")), JSD3Config.tiny(),
        *_jax_args(inputs, "sd3x", SD3_ARGS)))
    refs["sr"] = workers._sr_stage(inputs, None, int8_serving=True).numpy()
    tcfg = workers.t5_config()
    refs["t5"] = np.asarray(jit_reference(jtext.t5_encoder_forward,
                                          static_argnums=1)(
        _nested(inputs, "t5"),
        jtext.T5EncoderConfig(**dataclasses.asdict(tcfg)),
        jnp.asarray(inputs["t5_ids"])))
    for name, (mode, int4) in workers.CACHE_CASES.items():
        pipe = workers.cache_pipeline(str(d / "one_rank" / name), mode, int4)
        refs[f"cache/{name}"] = (pipe.transformer_params,
                                 pipe._cache_path(pipe.RANDOM_KIND))
    return refs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("int8_tp")
    inputs = _inputs(d)
    spawned = workers.spawn("int8_tp_worker", N, str(d / "ranks"), inputs)
    refs = _jax_references(inputs, d)
    return spawned.join(), inputs, refs


def _slices(tree, m):
    """Rank ``m``'s slices of a whole tree, by the one-device rule."""
    return shard_tree(tree, lambda path, node: shard_node(path, node, m, N))


def _prefixed(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items()
            if k.startswith(prefix + "/")}


def _assert_tree_equal(got: dict, tree):
    want = workers.flatten(tree)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("name", list(workers.INT8_MODES))
def test_int8_slices_are_the_one_device_tree_cut(run, name):
    """Quantized whole then cut, or quantized then cut node by node as the
    loaders and the random init do: the slices of the one-device serving
    tree, bit for bit; a row kernel's scale is whole on every rank."""
    ranks, inputs, _ = run
    whole = quantize_flux_params(workers.unflatten(inputs, "flux"),
                                 weight_only_rest=name == "max_memory")
    for m, res in enumerate(ranks):
        for how in ("cut", "made"):
            _assert_tree_equal(_prefixed(res, f"{name}/{how}"),
                               _slices(whole, m))
        sb = _prefixed(res, f"{name}/cut/single_blocks/proj_out")
        np.testing.assert_array_equal(
            sb["scale"], whole["single_blocks"]["proj_out"]["scale"].numpy())
        hidden = FluxConfig.tiny().hidden_size
        assert sb["kernel_int8_attn"].shape[-2] == hidden // N
        ff = _prefixed(res, f"{name}/cut/dual_blocks/ff/out")
        np.testing.assert_array_equal(
            ff["scale"], whole["dual_blocks"]["ff"]["out"]["scale"].numpy())


def test_w8a8_row_product_is_the_one_device_product(run):
    """The row's amax reduced (MAX) over the ranks and the int32 partial
    products summed: bit for bit the one-device product.  Each rank's own
    amax with the dequantized partials summed is not."""
    ranks, _, _ = run
    for res in ranks:
        np.testing.assert_array_equal(res["row/tp"], res["row/one_device"])
        assert not np.array_equal(res["row/local_amax"], res["row/one_device"])


@pytest.mark.parametrize("name", list(workers.INT8_MODES))
def test_int8_tp_forward_matches_jax(run, name):
    """Against the port's one-rank forward and the JAX package's: W8A8
    within 1e-5; "max_memory" within 5e-5, where one W8A8 activation
    flips one int8 step (1/127 of its row's amax) under another summation
    order of the weight-only products before it: 2.5e-5 of max|ref|,
    measured both between the one-rank port and JAX and across ranks,
    which order flips it depending on the thread count."""
    ranks, _, refs = run
    for res in ranks:
        for ref in ("one_rank", "forward"):
            _close(res[f"{name}/forward"], refs[f"{name}/{ref}"], FWD_REL[name])


def test_sd3_int8_tp_matches_jax_and_sr_stage_one_rank(run):
    """The TP SD3 forward in W8A8 against JAX's one-device forward; the SR
    stage (``TSDSRConfig(int8_serving=True)``) on the mesh against one
    rank; ``host_params`` on a mesh refused, saying why."""
    ranks, _, refs = run
    for res in ranks:
        _close(res["sd3"], refs["sd3"])
        _close(res["sr"], refs["sr"])
        assert "undoes the tensor-parallel cut" in str(res["host_params_refused"])


@pytest.mark.parametrize("name", list(workers.CACHE_CASES))
def test_cache_on_the_mesh_is_the_one_rank_file(run, name):
    """The file written on two ranks equals the one-rank file leaf for
    leaf; each rank's tree, built or read back from it, is its slices of
    the one-rank tree (int4: of its re-gridded unpack)."""
    ranks, inputs, refs = run
    tree, path = refs[f"cache/{name}"]
    mesh_path = os.path.join(str(inputs["cache_dir"]), name,
                             os.path.basename(path))
    got, want = load_params(mesh_path), load_params(path)
    _assert_tree_equal(workers.flatten(got), want)
    if workers.CACHE_CASES[name][1]:
        tree = unpack_int4_tree(pack_int4_tree(tree))
    for m, res in enumerate(ranks):
        _assert_tree_equal(_prefixed(res, f"cache/{name}/read"), _slices(tree, m))
        if not workers.CACHE_CASES[name][1]:
            _assert_tree_equal(_prefixed(res, f"cache/{name}/built"),
                               _slices(tree, m))


def test_t5_tp_matches_jax(run):
    ranks, _, refs = run
    for res in ranks:
        _close(res["t5"], refs["t5"])
