"""ZeRO-1 full fine-tuning, the pipelined FLUX forward and the multi-rank
launcher in the port, against the JAX package's one-device
``full_train_step`` and ``flux_forward``, across gloo ranks on the CPU.

Two spawns serve the module, started together: four ranks
(``tests/torch_dist_workers.zero_pp_worker``) for two ZeRO-1 steps at data
2 and data 2 x model 2 in f32 (each data rank holding 1/2 of every moment
leaf with a dimension that divides; the bf16-compute twins are in
``tests/test_torch_train_mesh.py``), and the
chained GPipe forward in two microbatches of the batch of 4 at pipe 4 (the
tiny model's 2 + 2 blocks padded to 4 + 4: stages 2 and 3 hold only zero
blocks of the dual stack), pipe 2, data 2 x pipe 2, model 2 x pipe 2
(``prepare_flux_params_tp_pp``) and with ``kv_keep_idx``; and two ranks
(``launcher_worker``) for ``unitex_torch.scripts.train_flux_lora`` with
``--data-mesh``, ``--pipe`` with ``--pipe-n-micro``, and
``--full-finetune`` with ``--bf16-compute``, each resumed from its
checkpoint.  The JAX references (one ``full_train_step`` program, two
steps, one ``flux_forward`` program with and one without
``kv_keep_idx``; no ``shard_map``) run here while the ranks run.  The
port runs in f32.

Tolerances: the forwards, the losses, and the parameters and Adam moments
after two steps within 1e-5 of max|ref| of each tree (the order of sums
differs across ranks); the zero blocks' identity and the adapter's round
trip through the stages exact.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitex_tpu.models.flux import lora as jlora
from unitex_tpu.models.flux import model as jflux
from unitex_tpu.models.flux.config import FluxConfig as JFluxConfig

from unitex_torch.models.flux.config import FluxConfig
from unitex_torch.models.flux.model import flux_forward
from unitex_torch.parallel.pipeline import pad_stacked_blocks
from unitex_torch.training import checkpoint as tckpt

import torch_dist_workers as workers
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference
from torch_train_reference import jax_full_steps, make_train_inputs, max_rel, nested

share_cpu()

REL = 1e-5
FORWARDS = ("pp4", "pp2", "dp2pp2", "tp2pp2", "kv_pp4")
FWD_ARGS = ("hidden", "context", "timestep", "pooled", "img_ids", "txt_ids",
            "guidance")


def _forward_inputs(rng, cfg) -> dict:
    S_img, S_txt = 16, 8
    ids = np.stack(np.meshgrid(np.arange(4), np.arange(4), indexing="ij"), -1)
    x = {
        "hidden": rng.normal(size=(4, S_img, cfg.in_channels)),
        "context": rng.normal(size=(4, S_txt, cfg.joint_attention_dim)),
        "timestep": np.array([0.7, 0.2, 0.5, 0.9]),
        "pooled": rng.normal(size=(4, cfg.pooled_projection_dim)),
        "img_ids": np.concatenate([np.zeros((S_img, 1)), ids.reshape(S_img, 2)],
                                  axis=1),
        "txt_ids": np.zeros((S_txt, 3)),
        "guidance": np.array([3.5, 1.0, 2.0, 4.0]),
    }
    out = {f"ppx/{k}": np.asarray(v, np.float32) for k, v in x.items()}
    out["ppx/keep"] = np.sort(rng.permutation(S_img + S_txt)[:17])
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero_pp")
    inputs = make_train_inputs(batch=4)
    inputs.update(_forward_inputs(np.random.default_rng(5), FluxConfig.tiny()))
    spawned = workers.spawn("zero_pp_worker", 4, str(d / "ranks"), inputs)
    launched = workers.spawn("launcher_worker", 2, str(d / "launcher"), {})
    merged = jlora.merge_lora(nested(inputs, "flux"),
                              [(nested(inputs, "lora"), 1.0)])
    args = [jnp.asarray(inputs[f"ppx/{n}"]) for n in FWD_ARGS]
    fwd = jit_reference(jflux.flux_forward, static_argnums=1)
    refs = {"f32": jax_full_steps(inputs, bf16=False),
            "fwd": np.asarray(fwd(merged, JFluxConfig.tiny(), *args)),
            "fwd_kv": np.asarray(fwd(merged, JFluxConfig.tiny(), *args,
                                     kv_keep_idx=jnp.asarray(inputs["ppx/keep"])))}
    return spawned.join(), launched.join(), inputs, refs, d


def test_zero_steps_match_jax(run):
    """Two ZeRO-1 steps at data 2 and at data 2 x model 2: every rank's loss
    and the whole parameters and moments (gathered over data and model)
    against JAX's one-device ``full_train_step``; each data rank holds
    half of every moment leaf that has a dimension dividing 2, and the
    whole of the others."""
    ranks, _, _, refs, _ = run
    want, tol = refs["f32"], REL
    for case in ("zero_dp2_f32", "zero_dp2tp2_f32"):
        for res in ranks:
            got = {k[len(case) + 1:]: v for k, v in res.items()
                   if k.startswith(case + "/")}
            np.testing.assert_allclose(got["losses"], want["losses"], rtol=REL)
            for tree in ("params", "mu", "nu"):
                assert max_rel(got, want, tree) <= tol, (case, tree)
            np.testing.assert_array_equal(
                got["share"], np.where(got["has_dim"], 0.5, 1.0))
            assert got["has_dim"].mean() > 0.9


def test_full_checkpoint_resumes_on_one_rank(run):
    """The tree rank 0 wrote at data 2 x model 2 (gathered from the model
    slices) reads back on one rank into the one-rank tree's shapes, equal
    to JAX's after the two steps."""
    _, _, inputs, refs, d = run
    mgr = tckpt.CheckpointManager(str(d / "ranks" / "full_ckpt"), 1)
    assert mgr.latest_step() == 2
    got = workers.flatten(mgr.restore_latest(workers.unflatten(inputs, "flux")))
    assert max_rel({f"params/{k}": v for k, v in got.items()}, refs["f32"],
                   "params") <= REL


@pytest.mark.parametrize("case", FORWARDS)
def test_pipelined_forward_matches_jax(run, case):
    """The chained GPipe schedule in two microbatches (the adapter merged in
    each block) on every rank against JAX's one-device forward of the
    merged tree."""
    ranks, _, _, refs, _ = run
    want = refs["fwd_kv" if case.startswith("kv") else "fwd"]
    for res in ranks:
        err = np.abs(res[f"fwd/{case}"] - want).max()
        assert err <= REL * np.abs(want).max(), err


def test_zero_blocks_are_identities_and_padding_strips(run):
    """Zero blocks appended to both stacks leave the forward bit for bit as
    it was; ``strip_lora_padding`` of the stages' gathered
    ``prepare_lora_pp`` is the adapter itself (2 -> 4 layers a stack at
    pipe 4, one a stage)."""
    ranks, _, inputs, _, _ = run
    cfg = FluxConfig.tiny()
    flux = workers.unflatten(inputs, "flux")
    padded = {**flux, **{s: pad_stacked_blocks(flux[s], 3)
                         for s in ("dual_blocks", "single_blocks")}}
    deep = dataclasses.replace(cfg, num_layers=3, num_single_layers=3)
    args = workers._flux_args({f"x/{n}": inputs[f"ppx/{n}"] for n in FWD_ARGS})
    assert torch.equal(flux_forward(padded, deep, *args),
                       flux_forward(flux, cfg, *args))
    lora = workers.flatten(workers.unflatten(inputs, "lora"))
    for res in ranks:
        np.testing.assert_array_equal(res["pp4_depths"], [1, 1])
        got = {k[len("round_trip/"):]: v for k, v in res.items()
               if k.startswith("round_trip/")}
        assert got.keys() == lora.keys()
        for k in lora:
            np.testing.assert_array_equal(got[k], lora[k])


def test_launcher_trains_across_ranks_and_resumes(run):
    """``train_flux_lora --tiny`` on two ranks for each of
    ``LAUNCHER_RUNS`` (``--data-mesh``, ``--pipe`` with
    ``--pipe-n-micro``, ``--full-finetune`` with ``--bf16-compute``): one
    step, then a second run resumed from the first's checkpoint; finite
    losses, the same on both ranks, and the checkpoint the whole tree
    (the adapter stripped of the pipe padding, or every parameter) that
    one rank reads."""
    _, ranks, inputs, _, d = run
    for name in workers.LAUNCHER_RUNS:
        for res in ranks:
            losses = res[f"{name}/losses"]
            assert losses.shape == (2,) and np.isfinite(losses).all(), name
            np.testing.assert_array_equal(losses, ranks[0][f"{name}/losses"])
        root = str(d / "launcher" / name)
        assert sorted(n for n in os.listdir(root)
                      if n.startswith("checkpoint-")) == \
            ["checkpoint-1", "checkpoint-2"], name
        saved = workers.flatten(torch.load(
            os.path.join(root, "checkpoint-2", tckpt.FILE), weights_only=True))
        shapes = workers.flatten(workers.unflatten(
            inputs, "flux" if name == "zero" else "lora"))
        assert saved.keys() == shapes.keys(), name
        for k, v in shapes.items():
            assert saved[k].shape == v.shape, (name, k)
