"""Tensor parallelism of the port (``unitex_torch/parallel``, the TP forwards
of FLUX and SD3) against the JAX package, across gloo ranks on the CPU.

One spawn of four ranks (``tests/torch_dist_workers.parallel_worker``)
serves the module: a ``model = 4`` mesh, and a ``data 2 x model 2`` mesh
whose model pairs are two-way tensor parallel.  The JAX references run
here, in the parent, on the virtual CPU devices of ``tests/conftest.py``,
while the ranks run.  The trees are the port's seeded tiny FLUX and SD3
(f32) with non-zero adapters, the same numpy tree in both packages.

Tolerances: the slices are exact (they are copies of the tree's
numbers); the merged adapter kernels, whose ``a @ b`` is summed in
another blocking, within 1e-6 of max|ref|; the forwards within 1e-5 of
max|ref| (f32: the row-parallel products are summed across ranks in
another order than one product).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from unitex_tpu.models.flux import lora as jlora
from unitex_tpu.models.flux import model as jflux
from unitex_tpu.models.flux.config import FluxConfig as JFluxConfig
from unitex_tpu.models.flux.pp import prepare_flux_params_tp_pp
from unitex_tpu.models.sd3 import model as jsd3
from unitex_tpu.models.sd3.config import SD3Config as JSD3Config
from unitex_tpu.parallel.mesh import make_mesh as jax_mesh
from unitex_tpu.parallel.sharding import (
    flux_param_shardings,
    sd3_param_shardings,
    shard_params,
)

from unitex_torch.models.flux.config import FluxConfig
from unitex_torch.models.flux.loader import flux_params_from_state_dict
from unitex_torch.models.flux.lora import init_lora_params, merge_lora
from unitex_torch.models.flux.model import init_flux_params
from unitex_torch.models.sd3.config import SD3Config
from unitex_torch.models.sd3.model import init_sd3_params
from unitex_torch.parallel.mesh import Mesh
from unitex_torch.parallel.sharding import (
    shard_flux_params,
    shard_hook,
    shard_sd3_params,
)

import torch_dist_workers as workers
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_REL = 1e-5      # forwards, of max|ref| (f32, another summation order)
MERGE_REL = 1e-6    # merged adapter kernels, of max|ref|
LAYOUTS = {"tp4": 4, "tp2": 2}   # mesh name -> model axis size


def _adapters(flux, seed):
    """A rank-2 adapter tree of ``flux`` with non-zero a and b."""
    gen = torch.Generator().manual_seed(seed)
    lora = init_lora_params(gen, flux, rank=2, device="cpu")

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return 0.05 * torch.randn(node.shape, generator=gen)

    return fill(lora)


def make_inputs(seed: int = 0) -> dict:
    """The seeded tiny trees and forward inputs, flattened for the ranks."""
    gen = torch.Generator().manual_seed(seed)
    cfg, scfg = FluxConfig.tiny(), SD3Config.tiny()
    flux = init_flux_params(gen, cfg, device="cpu")
    sd3 = init_sd3_params(gen, scfg, device="cpu")
    rng = np.random.default_rng(seed)
    S_img, S_txt = 16, 8
    ids = np.stack(np.meshgrid(np.arange(4), np.arange(4), indexing="ij"), -1)
    inputs = {
        "x/hidden": rng.normal(size=(1, S_img, cfg.in_channels)),
        "x/context": rng.normal(size=(1, S_txt, cfg.joint_attention_dim)),
        "x/timestep": np.array([0.7]),
        "x/pooled": rng.normal(size=(1, cfg.pooled_projection_dim)),
        "x/img_ids": np.concatenate([np.zeros((S_img, 1)),
                                     ids.reshape(S_img, 2)], axis=1),
        "x/txt_ids": np.zeros((S_txt, 3)),
        "x/guidance": np.array([3.5]),
        "sd3x/latents": rng.normal(size=(2, 8, 8, scfg.in_channels)),
        "sd3x/context": rng.normal(size=(2, 8, scfg.joint_attention_dim)),
        "sd3x/timestep": np.array([1000.0, 400.0]),
        "sd3x/pooled": rng.normal(size=(2, scfg.pooled_projection_dim)),
    }
    inputs = {k: np.asarray(v, np.float32) for k, v in inputs.items()}
    inputs.update(workers._prefixed("flux", flux))
    inputs.update(workers._prefixed("lora", _adapters(flux, seed + 1)))
    inputs.update(workers._prefixed("sd3", sd3))
    return inputs


def _nested(inputs, prefix):
    """The JAX tree (nested dicts of jnp arrays) under ``prefix``."""
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        workers.unflatten(inputs, prefix))


def _placed(tree, specs, jmesh) -> dict:
    """{"a/b/c": placed JAX array} of ``tree`` under ``specs(tree, jmesh)``."""
    leaves = jax.tree_util.tree_leaves_with_path(
        shard_params(tree, specs(tree, jmesh)))
    return {"/".join(k.key for k in path): x for path, x in leaves}


def _shard_of(arr, jmesh, m):
    """The shard of a placed JAX array on the model axis' device ``m``."""
    dev = jmesh.devices.reshape(-1)[m]
    return np.asarray({s.device: s for s in arr.addressable_shards}[dev].data)


def _fake_mesh(m: int, n: int) -> Mesh:
    """Model coordinate ``m`` of ``n``, with no process groups: enough for
    the cuts, which read only the coordinates."""
    return Mesh({"data": 1, "seq": 1, "model": n},
                {"data": 0, "seq": 0, "model": m}, {}, torch.device("cpu"))


def _slices(res, name, tree):
    prefix = f"{name}/{tree}/"
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


FLUX_ARGS = ("hidden", "context", "timestep", "pooled", "img_ids", "txt_ids",
             "guidance")
SD3_ARGS = ("latents", "context", "timestep", "pooled")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The spawned ranks and the inputs, and the JAX references, computed
    here while the ranks run."""
    inputs = make_inputs()
    spawned = workers.spawn("parallel_worker", 4,
                            str(tmp_path_factory.mktemp("parallel")), inputs)
    flux, lora = _nested(inputs, "flux"), _nested(inputs, "lora")
    merged = jlora.merge_lora(flux, [(lora, 1.0)])
    refs = {
        "merged": merged,
        "flux": np.asarray(jit_reference(jflux.flux_forward, static_argnums=1)(
            merged, JFluxConfig.tiny(), *_jax_args(inputs, "x", FLUX_ARGS))),
        "sd3": np.asarray(jit_reference(jsd3.sd3_forward, static_argnums=1)(
            _nested(inputs, "sd3"), JSD3Config.tiny(),
            *_jax_args(inputs, "sd3x", SD3_ARGS))),
    }
    return spawned.join(), inputs, refs


def _jax_args(inputs, prefix, names):
    return [jnp.asarray(inputs[f"{prefix}/{n}"]) for n in names]


def test_mesh_coordinates_and_groups(run):
    ranks = run[0]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["tp4/coords"], [0, 0, r])
        np.testing.assert_array_equal(res["tp4/model_ranks"], [0, 1, 2, 3])
        np.testing.assert_array_equal(res["tp4/data_ranks"], [r])
        # data 2 x model 2: the ranks laid out as JAX's reshape(data, model)
        np.testing.assert_array_equal(res["tp2/coords"], [r // 2, 0, r % 2])
        np.testing.assert_array_equal(res["tp2/model_ranks"],
                                      [2 * (r // 2), 2 * (r // 2) + 1])
        np.testing.assert_array_equal(res["tp2/data_ranks"], [r % 2, r % 2 + 2])
        assert "not divisible by data=3" in str(res["bad_mesh"])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_flux_and_sd3_slices_match_the_jax_shards(run, name):
    """Every leaf of each rank's FLUX slices (cut on the ranks' mesh) and
    SD3 slices equals the shard JAX places on that rank's model device
    under ``flux_param_shardings`` / ``sd3_param_shardings``; exact.  The
    single blocks' ``proj_out`` is pre-split (its own test)."""
    ranks, inputs, _ = run
    n = LAYOUTS[name]
    jmesh = jax_mesh(data=1, model=n, devices=jax.devices()[:n])
    flux = _placed(_nested(inputs, "flux"), flux_param_shardings, jmesh)
    sd3 = _placed(_nested(inputs, "sd3"), sd3_param_shardings, jmesh)
    for r, res in enumerate(ranks):
        m = r % n
        mine = _slices(res, name, "flux")
        mine_sd3 = workers.flatten(shard_sd3_params(
            workers.unflatten(inputs, "sd3"), _fake_mesh(m, n)))
        for want, got in ((flux, mine), (sd3, mine_sd3)):
            assert {k for k in want if "single_blocks/proj_out/kernel" not in k} \
                <= set(got)
            for path, arr in want.items():
                if path != "single_blocks/proj_out/kernel":
                    np.testing.assert_array_equal(
                        got[path], _shard_of(arr, jmesh, m), err_msg=path)


def test_single_blocks_proj_out_presplit_matches_pp(run):
    """The single blocks' ``proj_out`` as the JAX package's TP x PP layout
    cuts it (``prepare_flux_params_tp_pp``: the rows of ``kernel[:, :d]``
    and ``kernel[:, d:]``, each over the model axis); exact."""
    ranks, inputs, _ = run
    jmesh = JMesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("pipe", "model"))
    prepared = prepare_flux_params_tp_pp(_nested(inputs, "flux"),
                                         JFluxConfig.tiny(), jmesh)
    po = prepared["single_blocks"]["proj_out"]
    for r, res in enumerate(ranks):
        for part in ("kernel_attn", "kernel_mlp"):
            np.testing.assert_array_equal(
                res[f"tp4/flux/single_blocks/proj_out/{part}"],
                _shard_of(po[part], jmesh, r))
        np.testing.assert_array_equal(res["tp4/flux/single_blocks/proj_out/bias"],
                                      np.asarray(po["bias"]))
        assert "tp4/flux/single_blocks/proj_out/kernel" not in res


def test_adapter_slices_and_merged_kernels_match_jax(run):
    """The adapters are cut by the kernels' rule (b of a column kernel by
    columns, a of a row kernel by rows, the other factor whole; exact),
    and merging a rank's adapter slices into its kernel slices gives its
    shard of the JAX package's merged tree (within 1e-6 of max|ref|)."""
    ranks, inputs, refs = run
    jmesh = jax_mesh(data=1, model=4, devices=jax.devices()[:4])
    merged = _placed(refs["merged"], flux_param_shardings, jmesh)
    lora = workers.flatten(workers.unflatten(inputs, "lora"))
    for r, res in enumerate(ranks):
        cut = _slices(res, "tp4", "lora")
        for path in ("dual_blocks/attn/to_q", "dual_blocks/ff/in",
                     "single_blocks/proj_mlp"):
            b = lora[f"{path}/b"]
            k = b.shape[-1] // 4
            np.testing.assert_array_equal(cut[f"{path}/a"], lora[f"{path}/a"])
            np.testing.assert_array_equal(cut[f"{path}/b"],
                                          b[..., r * k:(r + 1) * k])
        for path in ("dual_blocks/attn/to_out", "dual_blocks/ff_context/out"):
            a = lora[f"{path}/a"]
            k = a.shape[-2] // 4
            np.testing.assert_array_equal(cut[f"{path}/a"],
                                          a[..., r * k:(r + 1) * k, :])
            np.testing.assert_array_equal(cut[f"{path}/b"], lora[f"{path}/b"])
        mine = workers.flatten(merge_lora(
            workers.unflatten({f"t/{k}": v for k, v in _slices(
                res, "tp4", "flux").items()}, "t"),
            [(workers.unflatten({f"t/{k}": v for k, v in cut.items()}, "t"),
              1.0)]))
        for path, arr in merged.items():
            if path == "single_blocks/proj_out/kernel":
                continue
            want = _shard_of(arr, jmesh, r)
            assert np.abs(mine[path] - want).max() <= MERGE_REL * np.abs(
                want).max(), path


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tp_flux_forward_matches_jax(run, name):
    """The TP forward on every rank (the adapters merged into each block's
    slices) against the JAX ``flux_forward`` of the merged tree."""
    ranks, _, refs = run
    want = refs["flux"]
    for res in ranks:
        err = np.abs(res[f"{name}/forward"] - want).max()
        assert err <= FWD_REL * np.abs(want).max(), err


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tp_sd3_forward_matches_jax(run, name):
    ranks, _, refs = run
    want = refs["sd3"]
    for res in ranks:
        err = np.abs(res[f"{name}/sd3"] - want).max()
        assert err <= FWD_REL * np.abs(want).max(), err


def test_streaming_cuts_match_the_whole_tree_cut():
    """The random init and the checkpoint loader cut each linear node as
    it is made; the slices equal the cut of the whole tree (exact), so no
    rank needs the whole tree."""
    cfg = FluxConfig.tiny()
    whole = init_flux_params(torch.Generator().manual_seed(3), cfg,
                             device="cpu")
    sd = dict(_chip_smoke().flux_state_dict(whole))
    for m in range(2):
        mesh = _fake_mesh(m, 2)
        want = workers.flatten(shard_flux_params(whole, mesh))
        for got in (init_flux_params(torch.Generator().manual_seed(3), cfg,
                                     device="cpu", hook=shard_hook(mesh)),
                    flux_params_from_state_dict(sd, cfg, device="cpu",
                                                mesh=mesh)):
            got = workers.flatten(got)
            assert set(got) == set(want)
            for path in want:
                np.testing.assert_array_equal(got[path], want[path],
                                              err_msg=path)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
