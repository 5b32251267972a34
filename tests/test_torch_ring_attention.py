"""Sequence-parallel attention of the port (``unitex_torch/ops/
ring_attention.py``) against the JAX package's ``ring_attention`` and
``ulysses_attention``, across gloo ranks on the CPU.

One spawn of four ranks (``tests/torch_dist_workers.ring_worker``) serves
the module: the ring and Ulysses over a ``seq = 4`` mesh and over the two
``seq`` pairs of a ``data 2 x seq 2`` mesh, on q/k/v [1, 16, 4, 8] f32.
The JAX references run in the parent, on 4 and 2 of the virtual CPU
devices, while the ranks run.  Tolerance: 1e-5 of max|ref| (f32; the ring
merges its blocks' normalised outputs by their lse, where JAX keeps
per-block max and sum, the same function in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitex_tpu.ops import ring_attention as jra
from unitex_tpu.parallel.mesh import make_mesh as jax_mesh

from unitex_torch.ops.attention import attention_reference
from unitex_torch.ops.ring_attention import ring_block, ring_finish, ring_merge

import torch_dist_workers as workers
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

REL = 1e-5   # of max|ref|
SIZES = (4, 2)


def _close(got, want, rel=REL):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs = {n: rng.normal(size=(1, 16, 4, 8)).astype(np.float32)
              for n in ("q", "k", "v")}
    inputs.update({n: rng.normal(size=(1, 16, 6, 8)).astype(np.float32)
                   for n in ("q6", "k6", "v6")})
    spawned = workers.spawn("ring_worker", 4,
                            str(tmp_path_factory.mktemp("ring")), inputs)
    qkv = [jnp.asarray(inputs[n]) for n in ("q", "k", "v")]
    refs = {}
    for n in SIZES:
        mesh = jax_mesh(data=1, model=n, devices=jax.devices()[:n])
        for name, fn in (("ring", jra.ring_attention),
                         ("ulysses", jra.ulysses_attention)):
            refs[f"{name}{n}"] = np.asarray(jit_reference(
                functools.partial(fn, mesh=mesh, axis_name="model"))(*qkv))
    return spawned.join(), inputs, refs


@pytest.mark.parametrize("n", SIZES)
def test_ring_attention_matches_jax(run, n):
    ranks, _, refs = run
    for res in ranks:
        _close(res[f"ring{n}"], refs[f"ring{n}"])


@pytest.mark.parametrize("n", SIZES)
def test_ulysses_attention_matches_jax(run, n):
    ranks, _, refs = run
    for res in ranks:
        _close(res[f"ulysses{n}"], refs[f"ulysses{n}"])


def test_ulysses_exchange_is_rank_major(run):
    """The first exchange gives seq rank s the whole sequence, its blocks in
    rank order (JAX's ``all_to_all(tiled=True)``: split axis 2, concat
    axis 1), on heads s·H/n … (s+1)·H/n - 1; the second gives the blocks
    back (exact)."""
    ranks, inputs, _ = run
    q = inputs["q"]
    for n in SIZES:
        h = q.shape[2] // n
        s = q.shape[1] // n
        for r, res in enumerate(ranks):
            idx = r % n          # the seq index (data 2 x seq 2: r = 2d + s)
            np.testing.assert_array_equal(res[f"gathered{n}"],
                                          q[:, :, idx * h:(idx + 1) * h])
            np.testing.assert_array_equal(res[f"round_trip{n}"],
                                          q[:, idx * s:(idx + 1) * s])


def test_auto_mode_takes_the_ring_when_heads_do_not_divide(run):
    """6 heads over 4 ranks: ``sp_mode="auto"`` runs the ring, exact
    attention of each rank's queries (against the plain attention of the
    whole sequence)."""
    ranks, inputs, _ = run
    q, k, v = (torch.from_numpy(inputs[n]) for n in ("q6", "k6", "v6"))
    want, _ = attention_reference(q, k, v)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["auto6"], res["ring6"])
        _close(res["auto6"], want[:, r * 4:(r + 1) * 4].numpy())


def test_ring_merge_matches_plain_attention():
    """The ring's per-block step on one process, as ``chip_smoke.py``
    runs it on the card: 4 query blocks x 4 key blocks, each block product
    through ``ring_block`` (B1's plain version here), merged by lse, held
    to the plain attention of the whole sequence."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 32, 3, 16, generator=gen) for _ in range(3))
    want, _ = attention_reference(q, k, v)
    blocks = []
    for i in range(4):
        qi = q[:, 8 * i:8 * (i + 1)]
        state = None
        for j in range(4):
            kj, vj = k[:, 8 * j:8 * (j + 1)], v[:, 8 * j:8 * (j + 1)]
            state = ring_merge(state, *ring_block(qi, kj, vj))
        blocks.append(ring_finish(state, q.dtype))
    _close(torch.cat(blocks, dim=1).numpy(), want.numpy())
