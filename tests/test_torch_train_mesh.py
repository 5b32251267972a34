"""Training across ranks in the port (the autograd collectives, LoRA
under tensor, data and pipeline parallelism, ZeRO-1 with the bf16
compute) against the JAX package's one-device ``train_step`` and
``full_train_step``, across gloo ranks on the CPU.

One spawn of four ranks (``tests/torch_dist_workers.lora_mesh_worker``)
serves the module; the JAX references (``tests/torch_train_reference``:
one ``train_step`` and one ``full_train_step`` program, each run for two
steps from the same tree, batch and draws; no ``shard_map``) run here
while the ranks run.  The port runs in f32 (the ZeRO cases' compute in
bf16; their f32 twins are in ``tests/test_torch_zero_pp.py``).

Cases: the collectives' gradients on a model = 4 group; the GPipe
schedules' gradients at pipe 4 against the stages applied in order on
one rank; two LoRA steps
(the global-norm clip active: the tiny model's gradient norm is above
``max_grad_norm``) at model 4, model 2 and data 2 x model 2 (the
adapter's slices, the TP forward and backward, the batch of 4 cut over
data), and at pipe 4 (the tiny model's 2 + 2 blocks padded to 4 + 4),
pipe 2 and data 2 x pipe 2 (the chained GPipe schedule in two
microbatches); the data 2 x model 2 adapter read back as a checkpoint on
one rank; two ZeRO-1 steps with the bf16 compute at data 2 and data 2 x
model 2.

Tolerances: the collectives' gradients exact; the losses, the adapter and
the Adam moments after two steps within 1e-5 of max|ref| of each tree
(f32, the order of sums differing across ranks).  With the bf16 compute
each gradient is rounded to bf16 once, in both packages, and a last-bit
difference of the f32 sums before it can round an element to the
neighbouring bf16 value, 2^-8 of it: the parameters and moments are then
held to 1e-2 of max|ref| (measured: 1.4e-4, 2.8e-3 and 5.7e-3), the loss
to 1e-5.
"""

import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from torch_cpu_share import share_cpu
from torch_train_reference import (
    jax_full_steps,
    jax_lora_steps,
    make_train_inputs,
    max_rel,
)

share_cpu()

REL = 1e-5
BF16_REL = 1e-2     # a bf16-rounded gradient, both packages (docstring)
CASES = ("tp4", "tp2", "dp2tp2", "pp4", "pp2", "dp2pp2")


def _collective_inputs(rng) -> dict:
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"col/x": f(4, 3, 5), "col/w": f(3, 5), "col/W": f(4, 5, 2),
            "col/v": f(4, 3, 2), "col/wg": f(3, 20),
            # the schedule: 3 microbatches of [2, 5], 2 phases x 4 stages
            "pipe/x": f(3, 2, 5), "pipe/aux": f(3, 2, 5), "pipe/w": f(3, 2, 5),
            "pipe/W": 0.5 * f(2, 4, 5, 5)}


def _grad_norm(inputs) -> float:
    """The first step's global gradient norm on one rank (the whole tree)."""
    from unitex_torch.models.flux.config import FluxConfig
    from unitex_torch.training import flux_lora as tfl

    lora = workers._requires_grad(workers.unflatten(inputs, "lora"))
    batch, draws = workers._train_args(inputs)
    tfl.flow_match_loss(lora, workers.unflatten(inputs, "flux"),
                        FluxConfig.tiny(), workers._lora_tcfg(), batch, None,
                        **draws[0]).backward()
    return float(torch.sqrt(sum((p.grad ** 2).sum() for p in tfl._leaves(lora))))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_mesh")
    inputs = make_train_inputs(batch=4)
    inputs.update(_collective_inputs(np.random.default_rng(3)))
    spawned = workers.spawn("lora_mesh_worker", 4, str(d / "ranks"), inputs)
    refs = {"lora": jax_lora_steps(inputs),
            "bf16": jax_full_steps(inputs, bf16=True)}
    norm = _grad_norm(inputs)
    return spawned.join(), inputs, refs, norm, d / "ranks"


def test_collectives_differentiate_as_megatron(run):
    """``reduce_from``'s gradient passes unchanged; ``copy_to``'s sums the
    ranks' column parts; ``gather_from``'s is this rank's slice of the
    whole gradient (a reduce-scatter would give 4 times it)."""
    ranks, inputs, _, _, _ = run
    W, v = inputs["col/W"], inputs["col/v"]
    f_want = sum(v[m] @ W[m].T for m in range(4))
    for m, res in enumerate(ranks):
        np.testing.assert_array_equal(res["g_grad"], inputs["col/w"])
        np.testing.assert_allclose(res["f_grad"], f_want, rtol=1e-6)
        np.testing.assert_array_equal(res["gather_grad"],
                                      inputs["col/wg"][:, 5 * m:5 * (m + 1)])


def test_pipeline_schedules_differentiate(run):
    """``pipeline_apply`` (``gpipe_local``, 4 stages) and
    ``gpipe_chain_local`` (two phases of 4) on three microbatches, against
    the stages applied in order on one rank: every rank's output, each
    stage's weight gradients and stage 0's input gradient (the other
    stages' input is unused: 0).  The broadcast's backward hands the
    gradient to the last stage once; a sum over the stages would scale
    every gradient by 4."""
    from torch_dist_workers import pipeline_stage

    ranks, inputs, _, _, _ = run
    for name in ("gpipe", "chain"):
        W = torch.from_numpy(inputs["pipe/W"]).requires_grad_(True)
        x = torch.from_numpy(inputs["pipe/x"]).requires_grad_(True)
        aux = torch.from_numpy(inputs["pipe/aux"])
        h = x
        for a in range(2 if name == "chain" else 1):
            for s in range(4):
                h = pipeline_stage(W[a, s], h, aux, None)
        (torch.from_numpy(inputs["pipe/w"]) * h).sum().backward()
        for s, res in enumerate(ranks):
            np.testing.assert_allclose(res[f"{name}/out"], h.detach().numpy(),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(res[f"{name}/dwa"],
                                       W.grad[0, s].numpy(), rtol=1e-5,
                                       atol=1e-7)
            if name == "chain":
                np.testing.assert_allclose(res[f"{name}/dwb"],
                                           W.grad[1, s].numpy(), rtol=1e-5,
                                           atol=1e-7)
            want_dx = (x.grad.numpy() if s == 0
                       else np.zeros_like(x.grad.numpy()))
            np.testing.assert_allclose(res[f"{name}/dx"], want_dx,
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", CASES)
def test_lora_steps_match_jax(run, case):
    """Two LoRA steps on the mesh: every rank's loss, and the whole adapter
    and moments (gathered from the slices or the stages, the pipe padding
    stripped), against JAX's one-device steps; the clip was active."""
    ranks, _, refs, norm, _ = run
    assert norm > 2 * workers.TRAIN_KW["max_grad_norm"], norm
    want = refs["lora"]
    for res in ranks:
        got = {k[len(case) + 1:]: v for k, v in res.items()
               if k.startswith(case + "/")}
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=REL)
        for tree in ("lora", "mu", "nu"):
            assert max_rel(got, want, tree) <= REL, (case, tree)


def test_checkpoint_resumes_on_one_rank(run):
    """The adapter rank 0 wrote at data 2 x model 2 (the whole tree
    gathered from the slices) reads back on one rank into the one-rank
    adapter's shapes, equal to JAX's after the two steps."""
    from unitex_torch.training.checkpoint import CheckpointManager

    _, inputs, refs, _, d = run
    want = refs["lora"]
    mgr = CheckpointManager(str(d / "lora_ckpt"), 1)
    assert mgr.latest_step() == 2
    got = workers.flatten(mgr.restore_latest(workers.unflatten(inputs, "lora")))
    assert max_rel({f"lora/{k}": v for k, v in got.items()}, want,
                   "lora") <= REL


def test_zero_steps_with_bf16_compute_match_jax(run):
    """Two ZeRO-1 steps with the bf16 compute at data 2 and at data 2 x
    model 2: every rank's loss and the whole parameters and moments
    against JAX's one-device ``full_train_step(bf16_compute=True)``; each
    data rank holds half of every moment leaf that has a dimension
    dividing 2, and the whole of the others."""
    ranks, _, refs, _, _ = run
    want = refs["bf16"]
    for case in ("zero_dp2_bf16", "zero_dp2tp2_bf16"):
        for res in ranks:
            got = {k[len(case) + 1:]: v for k, v in res.items()
                   if k.startswith(case + "/")}
            np.testing.assert_allclose(got["losses"], want["losses"], rtol=REL)
            for tree in ("params", "mu", "nu"):
                assert max_rel(got, want, tree) <= BF16_REL, (case, tree)
            np.testing.assert_array_equal(
                got["share"], np.where(got["has_dim"], 0.5, 1.0))
            assert got["has_dim"].mean() > 0.9
