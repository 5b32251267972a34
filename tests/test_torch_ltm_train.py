"""The LTM trainer in the port (``unitex_torch/training/ltm.py``,
``scripts/train_ltm.py``) against the JAX package's, on the CPU.

The point bank and the mesh batches are host numpy in both packages and
must be equal bit for bit.  The device draws (the field's affine matrix,
frequencies, phases, weights, RBF centres, widths and amplitudes; the
holes' centres and radii; the query shuffle; the encoder's noise) are the
JAX package's own, fed to the port.  Tolerances, all f32: field colours
1e-5 (in [0.05, 0.95]); the occlusion split exact; the IDW fill 1e-5;
the warmup-cosine schedule 1e-6 of the peak rate (optax computes it in
f32, the port in f64); the three train steps' losses 1e-4 of their value
and every parameter within 2e-2 of the learning rate (Adam's first steps
are about ±lr an element, and a gradient near 0 takes its sign from the
summation order); the holdout PSNRs 1e-3 dB.  JAX references run jitted,
each compiled once for the module.
"""

import dataclasses
import json
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unitex_tpu.models import ltm as jltm
from unitex_tpu.training import ltm as jtrain
from unitex_tpu.utils.param_cache import load_meta as jload_meta
from unitex_tpu.utils.param_cache import load_params as jload_params

from unitex_torch.models import ltm as tltm
from unitex_torch.scripts import train_ltm as tscript
from unitex_torch.training import ltm as ttrain
from unitex_torch.training.flux_lora import _leaves, warmup_cosine_decay_schedule
from unitex_torch.utils.params import params_from_jax
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

COLOR_TOL, IDW_TOL, PSNR_TOL = 1e-5, 1e-5, 1e-3
LOSS_REL, PARAM_LR = 1e-4, 2e-2
LR = 1e-3
N_QUERY = 128


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def bank():
    """5 meshes x 256 points, every primitive kind once: both packages'
    banks, which must be equal."""
    want = jtrain.build_point_bank(5, 256, seed=3)
    got = ttrain.build_point_bank(5, 256, seed=3)
    return want, got


def test_build_point_bank_equals_jax(bank):
    want, got = bank
    assert got.shape == (5, 256, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max(axis=(1, 2)) == pytest.approx(0.85)


def _field_draws(key):
    """``random_field_colors``' draws, as it makes them."""
    cur = jtrain.LTMCurriculum()
    ka, kf, kp, kw, kr, kc, ks = jax.random.split(key, 7)
    F, R = cur.n_fourier, cur.n_rbf
    return {
        "A": jax.random.normal(ka, (3, 3)) * 0.8,
        "freqs": jax.random.uniform(kf, (F, 3), minval=-cur.max_freq,
                                    maxval=cur.max_freq),
        "phase": jax.random.uniform(kp, (F,), maxval=2 * jnp.pi),
        "w": jax.random.normal(kw, (F, 3)) / jnp.sqrt(F),
        "mu": jax.random.uniform(kr, (R, 3), minval=-1.0, maxval=1.0),
        "sig": jax.random.uniform(ks, (R,), minval=cur.sig_min,
                                  maxval=cur.sig_max),
        "amp": jax.random.normal(kc, (R, 3)) * 0.7,
    }


def _occlusion_draws(key, points):
    cur = jtrain.LTMCurriculum()
    kc, kr, kq = jax.random.split(key, 3)
    return {
        "centers": jax.random.randint(kc, (cur.n_holes,), 0, points.shape[0]),
        "radii": jax.random.uniform(kr, (cur.n_holes,), minval=cur.r_min,
                                    maxval=cur.r_max),
        "shuffle": jax.random.uniform(kq, (points.shape[0],)),
    }


_jax_batch = jit_reference(jtrain.sample_device_batch, static_argnames=("n_query", "cur"))


def test_field_and_occlusion_split_match_jax_draws(bank):
    """``random_field_colors`` and ``occlusion_split`` fed the JAX
    package's draws, against its ``sample_device_batch`` (the field from
    the first half of the key, the split from the second)."""
    pts = bank[0][1]

    @jit_reference
    def jax_side(key, pts):
        kf, kh = jax.random.split(key)
        return (jtrain.sample_device_batch(key, pts, N_QUERY), _field_draws(kf),
                _occlusion_draws(kh, pts))

    want, fdraws, odraws = jax_side(jax.random.key(5), pts)
    colors = ttrain.random_field_colors(
        _t(pts), draws={k: _t(v) for k, v in fdraws.items()})
    np.testing.assert_allclose(colors.numpy(), np.asarray(want["colors"]),
                               atol=COLOR_TOL, rtol=0)
    got = ttrain.occlusion_split(
        _t(pts), _t(want["colors"]), N_QUERY,
        draws={k: _t(v) for k, v in odraws.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert 0 < int(got["query_in_hole"].sum()) < N_QUERY


@pytest.mark.parametrize("cur", ["r04", "affine_only"])
def test_field_draws_follow_the_curriculum(bank, cur):
    """The port's own draws: the Fourier and RBF parts exist only where
    the curriculum has them, and the field stays in [0.05, 0.95]."""
    c = getattr(ttrain.LTMCurriculum, cur)()
    d = ttrain.field_draws(torch.Generator().manual_seed(0), c, "cpu")
    assert ("freqs" in d) == bool(c.n_fourier) and ("mu" in d) == bool(c.n_rbf)
    if c.n_rbf:
        assert float(d["sig"].min()) >= c.sig_min and float(d["sig"].max()) < c.sig_max
    colors = ttrain.random_field_colors(_t(bank[1][0]), c, draws=d)
    assert float(colors.min()) == pytest.approx(0.05)
    assert float(colors.max()) == pytest.approx(0.95)


def test_idw_fill_baseline_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (600, 3)).astype(np.float32)
    cols = rng.uniform(size=(600, 3)).astype(np.float32)
    valid = rng.uniform(size=600) < 0.6
    qs = rng.uniform(-1, 1, (150, 3)).astype(np.float32)
    want = jit_reference(jtrain.idw_fill_baseline)(pts, cols, valid, qs)
    got = ttrain.idw_fill_baseline(_t(pts), _t(cols), _t(valid), _t(qs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=IDW_TOL, rtol=0)


@pytest.mark.parametrize("steps", [7, 200, 20000])
def test_warmup_cosine_schedule_matches_optax(steps):
    """The trainer's schedule: warmup min(500, steps // 10) from 0 to lr,
    then a cosine to lr x 0.05 at ``steps``; every count up to past the
    end (a stride of 37 at 20000)."""
    lr = 3e-4
    warm = min(500, steps // 10)
    want_fn = optax.warmup_cosine_decay_schedule(0.0, lr, warm, steps, lr * 0.05)
    counts = np.arange(0, steps + 5, 37 if steps > 1000 else 1)
    want = np.asarray(jit_reference(jax.vmap(want_fn))(jnp.asarray(counts)))
    got = warmup_cosine_decay_schedule(0.0, lr, warm, steps, lr * 0.05)
    np.testing.assert_allclose([got(int(c)) for c in counts], want,
                               atol=1e-6 * lr, rtol=0)


@pytest.fixture(scope="module")
def tiny():
    """LTMConfig.tiny(): the JAX package's ``create_ltm_state`` on the
    port's seeded tree (the JAX init compiles for seconds)."""
    jcfg = jltm.LTMConfig.tiny()
    tcfg = jtrain.LTMTrainConfig(learning_rate=LR)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tltm.init_ltm_params(
        torch.Generator().manual_seed(0), tltm.LTMConfig.tiny(), device="cpu"))
    tx = optax.chain(optax.clip_by_global_norm(tcfg.max_grad_norm),
                     optax.adamw(tcfg.learning_rate))
    state = jtrain.LTMTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 opt_state=tx.init(params))
    return jcfg, tcfg, state, tx


def test_three_train_steps_match_jax(tiny, bank):
    """Three ``ltm_train_step``s with the parameters and Adam moments
    carried across, each on a JAX batch with the JAX normal draw as the
    encoder's noise: the losses and the final tree."""
    jcfg, tcfg, jstate, jtx = tiny
    step_j = jit_reference(jtrain.ltm_train_step, static_argnames=("cfg", "tcfg", "tx"))
    cfg = tltm.LTMConfig(**dataclasses.asdict(jcfg))
    tcfg_t = ttrain.LTMTrainConfig(**dataclasses.asdict(tcfg))
    state, tx = ttrain.create_ltm_state(torch.Generator().manual_seed(0), cfg,
                                        tcfg_t, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), "cpu")
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    state = ttrain.LTMTrainState(0, params, tx.init(params))
    for i in range(3):
        kb, kn = jax.random.split(jax.random.key(20 + i))
        batch = _jax_batch(kb, bank[0][i], n_query=N_QUERY)
        jstate, loss_j = step_j(jstate, batch, kn, jcfg, tcfg, jtx)
        noise = jax.random.normal(kn, (jcfg.n_latents, jcfg.kl_latent_dim))
        state, loss_t = ttrain.ltm_train_step(
            state, {k: _t(v) for k, v in batch.items()}, cfg, tcfg_t, tx,
            noise=_t(noise))
        assert abs(float(loss_t) - float(loss_j)) <= LOSS_REL * abs(float(loss_j)), i
    assert state.step == int(jstate.step) == 3
    got = [x.detach().numpy() for x in _leaves(state.params)]
    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=PARAM_LR * LR, rtol=0)


def test_eval_psnr_matches_jax(tiny, bank):
    """The holdout metric of one batch: the hole PSNR of the field and of
    the k=8 IDW fill (the JAX script's ``eval_psnr`` body)."""
    jcfg, _, jstate, _ = tiny
    batch = _jax_batch(jax.random.key(10_050), bank[0][4], n_query=N_QUERY)

    @jit_reference
    def want_fn(params, batch):
        z, _, _ = jltm.encode_geometry(params, jcfg, batch["points"],
                                       batch["colors"], batch["valid"])
        pred = jltm.decode_field(params, jcfg, z, batch["query_points"],
                                 ctx=(batch["points"], batch["colors"],
                                      batch["valid"]))
        idw = jtrain.idw_fill_baseline(batch["points"], batch["colors"],
                                       batch["valid"], batch["query_points"], k=8)
        hole = batch["query_in_hole"]
        n = jnp.maximum(jnp.sum(hole), 1)

        def psnr(p):
            err2 = jnp.mean((p - batch["query_colors"]) ** 2, axis=-1)
            mse = jnp.sum(jnp.where(hole, err2, 0.0)) / n
            return -10.0 * jnp.log10(jnp.maximum(mse, 1e-10))

        return psnr(pred), psnr(idw)

    want = want_fn(jstate.params, batch)
    got = tscript.eval_psnr(
        params_from_jax(jax.tree.map(np.asarray, jstate.params), "cpu"),
        tltm.LTMConfig(**dataclasses.asdict(jcfg)),
        {k: _t(v) for k, v in batch.items()})
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= PSNR_TOL


def test_sample_ltm_batch_equals_jax():
    """The batch of a vertex-coloured mesh: the same arrays."""
    from unitex_tpu.geometry.primitives import make_icosphere as jico

    from unitex_torch.geometry.primitives import make_icosphere as tico

    rng = np.random.default_rng(6)
    vc = rng.uniform(size=(162, 3)).astype(np.float32)
    jm = dataclasses.replace(jico(2), vertex_colors=vc)
    tm = dataclasses.replace(tico(2), vertex_colors=vc)
    cfg = jtrain.LTMTrainConfig(n_visible=300, n_query=100)
    want = jtrain.sample_ltm_batch(jm, cfg, seed=2)
    got = ttrain.sample_ltm_batch(
        tm, ttrain.LTMTrainConfig(**dataclasses.asdict(cfg)), seed=2, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_tiny_cli_writes_an_npz_both_packages_read(tmp_path, monkeypatch):
    """``python -m unitex_torch.scripts.train_ltm --tiny --device cpu``:
    200 steps logged at 1, 50, ..., 200; the npz reads in the JAX package
    (the tiny init's leaves, its meta's config) and in the port's
    pipeline; the report has the JAX script's keys."""
    out, report = str(tmp_path / "ltm.npz"), str(tmp_path / "report.json")
    # what ``python -m`` runs, in this process; the tiny steps are a few
    # hundred small ops each, fastest on one thread
    monkeypatch.setattr(sys, "argv", ["train_ltm", "--tiny", "--device", "cpu",
                                      "--out", out, "--report", report])
    monkeypatch.delitem(sys.modules, "unitex_torch.scripts.train_ltm")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runpy.run_module("unitex_torch.scripts.train_ltm", run_name="__main__",
                         alter_sys=True)
    finally:
        torch.set_num_threads(threads)
    meta = jload_meta(out)
    jcfg = jltm.LTMConfig(**meta["config"])
    assert jcfg == jltm.LTMConfig.tiny() and meta["steps"] == 200
    tree = jload_params(out)
    init = jax.eval_shape(lambda: jltm.init_ltm_params(jax.random.key(0), jcfg))
    assert jax.tree.structure(tree) == jax.tree.structure(init)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(init)):
        assert a.shape == b.shape and np.isfinite(a).all()
    with open(report) as f:
        rep = json.load(f)
    assert sorted(rep) == ["bank", "best_holdout_hole_psnr_db", "best_step",
                           "config", "curriculum", "log", "metric", "steps"]
    assert [r["step"] for r in rep["log"]] == [1, 50, 100, 150, 200]
    assert sorted(rep["log"][0]) == ["elapsed_s", "holdout_hole_psnr_db",
                                     "idw_k8_hole_psnr_db", "loss", "step"]
    assert rep["best_step"] == meta["best_step"] and rep["config"] == "tiny"
    from unitex_torch.pipeline import RGBTextureFullPipeline

    pipe = RGBTextureFullPipeline(ltm_params=out, device="cpu")
    assert pipe.ltm_cfg == tltm.LTMConfig.tiny()
    for a, b in zip(_leaves(pipe.ltm_params), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)
