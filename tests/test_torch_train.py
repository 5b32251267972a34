"""FLUX LoRA training in the port (unitex_torch/training, the launcher)
against the JAX package (unitex_tpu/training), f32 on the CPU.

One tiny FLUX tree and one LoRA tree (b non-zero) are made with numpy and
carried into both packages (``params_from_jax`` for the port).  The JAX
loss draws its timestep, noise and kept tokens from a key; the port is
handed the same draws.  On the CPU the attention gradient is torch
autograd through the plain attention (the kernels B2a/B2b run on the
card, tests/test_torch_kernels.py).
"""

import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unitex_tpu.models.flux.config import FluxConfig as JFluxConfig
from unitex_tpu.training import checkpoint as jckpt
from unitex_tpu.training import data as jdata
from unitex_tpu.training import flux_lora as jfl

from unitex_torch.models.flux import lora as tlora
from unitex_torch.models.flux import model as tmodel
from unitex_torch.models.flux.config import FluxConfig as TFluxConfig
from unitex_torch.models.flux.pipeline import latent_image_ids
from unitex_torch.scripts import train_flux_lora as launcher
from unitex_torch.training import checkpoint as tckpt
from unitex_torch.training import data as tdata
from unitex_torch.training import flux_lora as tfl
from unitex_torch.utils.image_io import save_image
from unitex_torch.utils.params import params_from_jax
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

# f32 on both sides over a 2 + 2 block tiny model; the differences are
# summation order
LOSS_REL = 1e-5    # |Δloss| / |loss|
GRAD_REL = 1e-4    # each gradient leaf: max|Δ| / max|g|
PARAM_REL = 1e-5   # each LoRA leaf after a step: max|Δ| / max|leaf|
OPT_REL = 1e-6     # optimizer on a toy tree: max|Δ| / max|param|, per step
RANK = 2
B, HL, WL, C = 2, 8, 12, 4  # latents [B, HL, WL, C]: 24 noise tokens of 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves_np(tree, prefix=""):
    """Flat {path: numpy} of a JAX or torch tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves_np(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().numpy() if torch.is_tensor(tree) else np.asarray(tree)}


def _max_rel(got, want):
    """max over leaves of max|Δ| / max|want| (trees as flat dicts)."""
    assert got.keys() == want.keys()
    return max(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max() for k in want)


def _torch_lora(lora_np):
    lora = params_from_jax(lora_np, "cpu")
    for leaf in tfl._leaves(lora):
        leaf.requires_grad_(True)
    return lora


@pytest.fixture(scope="module")
def trees():
    """(base tree, LoRA tree with non-zero b), numpy, shapes from the port."""
    base = tmodel.init_flux_params(torch.Generator().manual_seed(0),
                                   TFluxConfig.tiny(), device="cpu")
    shapes = tlora.init_lora_params(torch.Generator().manual_seed(1), base,
                                    rank=RANK, device="cpu")
    rng = np.random.default_rng(2)
    lora = jax.tree.map(
        lambda x: (0.3 * rng.standard_normal(tuple(x.shape))).astype(np.float32),
        _np(jax.tree.map(lambda t: t.numpy(), shapes)))
    return jax.tree.map(lambda t: t.numpy(), base), lora


def _batch(seed, n=B):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {
        "latents": f(n, HL, WL, C),
        "cond_tokens": f(n, 24, 4 * C),
        "cond_ids": latent_image_ids(HL // 2, WL // 2, offset_y=HL // 2,
                                     device="cpu").numpy(),
        "prompt_embeds": f(n, 8, 64),
        "pooled_embeds": f(n, 32),
    }


def _jax_draws(key, tcfg, n=B):
    """The draws JAX's ``flow_match_loss`` makes from ``key``."""
    return {k: np.array(v) for k, v in _drawer(tcfg, n)(key).items()}


@functools.lru_cache(maxsize=None)
def _drawer(tcfg, n):
    """:func:`_jax_draws` as one jitted program (each op compiled eagerly
    took seconds)."""
    def draw(key):
        k_t, k_noise, k_drop = jax.random.split(key, 3)
        draws = {
            "u": jfl.sample_timestep_density(
                k_t, n, tcfg.weighting_scheme, tcfg.logit_mean,
                tcfg.logit_std),
            "noise": jax.random.normal(k_noise, (n, HL, WL, C)),
        }
        if tcfg.drop_rate > 0:
            S = (HL // 2) * (WL // 2)
            n_keep = max(1, int(S * (1.0 - tcfg.drop_rate)))
            draws["keep_idx"] = jnp.sort(
                jax.random.permutation(k_drop, S)[:n_keep])
        return draws

    return jit_reference(draw)


def _configs(**kw):
    return jfl.FluxLoraTrainConfig(rank=RANK, **kw), tfl.FluxLoraTrainConfig(rank=RANK, **kw)


def test_flow_match_loss_and_lora_grads_match_jax(trees):
    """Cond tokens, token drop 0.5, prior preservation ([instance; prior]
    halves) and logit-normal timesteps, in one evaluation."""
    base, lora = trees
    jt, tt = _configs(drop_rate=0.5, prior_preservation=True,
                      weighting_scheme="logit_normal", prior_loss_weight=0.7)
    batch = _batch(3)
    key = jax.random.key(4)
    loss_j, grads_j = jit_reference(jax.value_and_grad(jfl.flow_match_loss),
                              static_argnums=(2, 3))(
        jax.tree.map(jnp.asarray, lora), jax.tree.map(jnp.asarray, base),
        JFluxConfig.tiny(), jt, jax.tree.map(jnp.asarray, batch), key)
    lora_t = _torch_lora(lora)
    loss_t = tfl.flow_match_loss(lora_t, params_from_jax(base, "cpu"),
                                 TFluxConfig.tiny(), tt,
                                 params_from_jax(batch, "cpu"), None,
                                 **_jax_draws(key, jt))
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) <= LOSS_REL * abs(float(loss_j))
    got = _leaves_np(tfl._map(lambda p: p.grad, lora_t))
    for k, want in _leaves_np(grads_j).items():
        assert np.abs(got[k] - want).max() <= GRAD_REL * np.abs(want).max(), k


def test_remat_gradients_equal_plain(trees):
    """``remat=True`` recomputes each block under checkpoint, with the LoRA
    merged inside it: the same gradients as the plain forward."""
    base, lora = trees
    _, tt = _configs(drop_rate=0.25)
    batch = params_from_jax(_batch(5), "cpu")
    rng = np.random.default_rng(6)
    draws = {"u": rng.uniform(size=B).astype(np.float32),
             "noise": rng.normal(size=(B, HL, WL, C)).astype(np.float32),
             "keep_idx": np.sort(rng.permutation(24)[:18])}
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(TFluxConfig.tiny(), remat=remat)
        lora_t = _torch_lora(lora)
        tfl.flow_match_loss(lora_t, params_from_jax(base, "cpu"), cfg, tt,
                            batch, None, **draws).backward()
        grads.append(_leaves_np(tfl._map(lambda p: p.grad, lora_t)))
    assert _max_rel(grads[1], grads[0]) <= 1e-6


@pytest.mark.parametrize("clip", [True, False], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("schedule", ["constant", "constant_with_warmup",
                                      "cosine", "linear"])
def test_optimizer_matches_optax(schedule, clip):
    """Five AdamW steps behind the global-norm clip on a toy tree, against
    ``make_optimizer``'s optax chain; warmup 2 of 6 steps, lr 0.05."""
    kw = dict(learning_rate=0.05, lr_scheduler=schedule, warmup_steps=2,
              max_train_steps=6, max_grad_norm=0.5 if clip else 1e3,
              weight_decay=0.1)
    jt, tt = _configs(**kw)
    rng = np.random.default_rng(7)
    params = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
              "b": rng.normal(size=(5,)).astype(np.float32)}
    jx = jfl.make_optimizer(jt)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jx.init(jp)
    tx = tfl.make_optimizer(tt)
    tp = params_from_jax(params, "cpu")
    tstate = tx.init(tp)
    for step in range(5):
        grads = jax.tree.map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), params)
        norm = np.sqrt(sum((g ** 2).sum() for g in jax.tree.leaves(grads)))
        assert (norm >= jt.max_grad_norm) == clip
        updates, jstate = jx.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tx.step(tp, params_from_jax(grads, "cpu"), tstate)
        assert _max_rel(_leaves_np(tp), _leaves_np(jp)) <= OPT_REL, step
    # every warmup starts from lr 0, so the first update is 0
    assert (tx.lr(0) == 0.0) == (schedule != "constant")


@pytest.mark.parametrize("accum", [1, 2], ids=["train_step", "train_step_accum"])
def test_train_step_matches_jax(trees, accum):
    """One optimizer step on the tiny config (gradients averaged over two
    microbatches for ``train_step_accum``): loss and every LoRA leaf.  Adam's
    first step is g / (|g| + eps): with eps 1e-8 it is the sign of the
    gradients near 0 (|g| ~ 1e-9 here), which summation order decides, so
    the step takes eps 1e-4."""
    base, lora = trees
    jt, tt = _configs(learning_rate=1e-3, adam_eps=1e-4)
    key = jax.random.key(8)
    base_j = jax.tree.map(jnp.asarray, base)
    lora_j = jax.tree.map(jnp.asarray, lora)
    jx = jfl.make_optimizer(jt)
    jstate = jfl.TrainState(step=jnp.zeros((), jnp.int32), lora=lora_j,
                            opt_state=jx.init(lora_j))
    state_t, tx = tfl.create_train_state(torch.Generator().manual_seed(0),
                                         params_from_jax(base, "cpu"), tt,
                                         device="cpu")
    state_t.lora = _torch_lora(lora)
    state_t.opt_state = tx.init(state_t.lora)
    if accum == 1:
        batch = _batch(9, n=1)
        jstate, loss_j = jit_reference(
            jfl.train_step, static_argnames=("cfg", "tcfg", "tx"))(
            jstate, base_j, jax.tree.map(jnp.asarray, batch), key,
            cfg=JFluxConfig.tiny(), tcfg=jt, tx=jx)
        state_t, loss_t = tfl.train_step(
            state_t, params_from_jax(base, "cpu"), params_from_jax(batch, "cpu"),
            None, TFluxConfig.tiny(), tt, tx, draws=_jax_draws(key, jt, n=1))
    else:
        batch = _batch(9, n=2)
        batches = {k: (np.broadcast_to(v, (2, *v.shape)) if k == "cond_ids"
                       else v.reshape(2, 1, *v.shape[1:]))
                   for k, v in batch.items()}
        jstate, loss_j = jit_reference(
            jfl.train_step_accum, static_argnames=("cfg", "tcfg", "tx"))(
            jstate, base_j, jax.tree.map(jnp.asarray, batches), key,
            cfg=JFluxConfig.tiny(), tcfg=jt, tx=jx)
        draws = [_jax_draws(k, jt, n=1) for k in jax.random.split(key, 2)]
        state_t, loss_t = tfl.train_step_accum(
            state_t, params_from_jax(base, "cpu"),
            params_from_jax(batches, "cpu"), None, TFluxConfig.tiny(), tt, tx,
            draws=draws)
    assert state_t.step == int(jstate.step) == 1
    assert abs(float(loss_t) - float(loss_j)) <= LOSS_REL * abs(float(loss_j))
    assert _max_rel(_leaves_np(state_t.lora), _leaves_np(jstate.lora)) <= PARAM_REL


def test_synthetic_dataset_matches_jax(monkeypatch):
    """Two (target, control) samples at view 32.  Seed 11 draws two
    icospheres: the torus puts pixel centres of 32² views exactly on shared
    edges, where the two rasterizers break ties differently (see
    tests/test_torch_render.py).  The JAX dataset's geometry render runs
    as one jitted program (eagerly it compiles each of its ops)."""
    import unitex_tpu.render.conditioning as jcond

    monkeypatch.setattr(jcond, "render_geometry_condition", jit_reference(
        jcond.render_geometry_condition,
        static_argnames=("view_size", "rows", "cols")))
    want = iter(jdata.SyntheticTextureDataset(view_size=32, seed=11))
    got = iter(tdata.SyntheticTextureDataset(view_size=32, seed=11, device="cpu"))
    for _ in range(2):
        w, g = next(want), next(got)
        for key, bg in (("target", 0.0), ("control", 0.5)):
            assert g[key].shape == w[key].shape == (64, 96, 3)
            mw = np.any(np.abs(w[key] - bg) > 0, axis=-1)
            mg = np.any(np.abs(g[key] - bg) > 0, axis=-1)
            agree = mw == mg
            assert agree.mean() >= 0.999 and mw.mean() > 0.3
            assert np.abs(g[key] - w[key])[agree].max() <= 1e-4


@pytest.mark.parametrize("mode", ["texture", "delight"])
def test_directory_dataset_matches_jax(tmp_path, mode):
    """One asset of pipeline artifacts: the grid->strip layout, the dual
    image in texture mode, and the resize of an upscaled albedo."""
    rng = np.random.default_rng(10)
    d = tmp_path / "asset0"
    d.mkdir()
    img = lambda *s: rng.uniform(size=(*s, 3)).astype(np.float32)
    for name, arr in (("mv_normal.png", img(16, 24)), ("mv_ccm.png", img(16, 24)),
                      ("mv_rgb_w_light.png", img(8, 48)), ("mv_rgb.png", img(32, 48)),
                      ("processed_image.png", img(8, 8))):
        save_image(str(d / name), arr)
    w = next(iter(jdata.DirectoryTextureDataset(str(tmp_path), mode=mode)))
    g = next(iter(tdata.DirectoryTextureDataset(str(tmp_path), mode=mode)))
    assert sorted(g) == sorted(w) == (["control", "dual", "target"]
                                      if mode == "texture" else ["control", "target"])
    for key in w:
        np.testing.assert_allclose(g[key], np.asarray(w[key]), atol=1e-6)


def test_checkpoint_manager_matches_jax(tmp_path):
    """Cadence, ``checkpoint-<step>`` layout, latest-resume and pruning:
    the JAX manager reads what the port writes; a restore round-trips and
    refuses a tree of another shape."""
    root = str(tmp_path / "ckpt")
    mgr = tckpt.CheckpointManager(root, save_every=2, total_limit=2)
    jmgr = jckpt.CheckpointManager(root, save_every=2, total_limit=2)
    assert [mgr.should_save(s) for s in range(7)] == \
        [jmgr.should_save(s) for s in range(7)]
    assert mgr.restore_latest({"a": torch.zeros(3)}) is None
    trees = {s: {"a": torch.full((3,), float(s)), "n": {"b": torch.ones(2) * s}}
             for s in (2, 4, 6)}
    for s, tree in trees.items():
        mgr.save(s, tree)
    assert sorted(os.listdir(root)) == ["checkpoint-4", "checkpoint-6"]
    assert mgr.latest_step() == jmgr.latest_step() == 6
    os.makedirs(mgr.path(1))  # an older stray: JAX prunes the oldest first
    jmgr._prune()
    assert sorted(os.listdir(root)) == ["checkpoint-4", "checkpoint-6"]
    template = {"a": torch.zeros(3, dtype=torch.float64), "n": {"b": torch.zeros(2)}}
    got = mgr.restore_latest(template)
    assert got["a"].dtype == torch.float64
    torch.testing.assert_close(got["a"], trees[6]["a"].double())
    torch.testing.assert_close(got["n"]["b"], trees[6]["n"]["b"])
    with pytest.raises(ValueError):
        mgr.restore_latest({"a": torch.zeros(4), "n": {"b": torch.zeros(2)}})


def test_train_state_save_load_round_trip(tmp_path, trees):
    base, _ = trees
    tt = tfl.FluxLoraTrainConfig(rank=RANK)
    state, tx = tfl.create_train_state(torch.Generator().manual_seed(3),
                                       params_from_jax(base, "cpu"), tt, "cpu")
    state.step = 5
    tfl.save_checkpoint(str(tmp_path / "state.pt"), state)
    fresh, _ = tfl.create_train_state(torch.Generator().manual_seed(4),
                                      params_from_jax(base, "cpu"), tt, "cpu")
    loaded = tfl.load_checkpoint(str(tmp_path / "state.pt"), fresh)
    assert loaded.step == 5
    for k, want in _leaves_np(state.lora).items():
        np.testing.assert_array_equal(_leaves_np(loaded.lora)[k], want)
    assert all(leaf.requires_grad for leaf in tfl._leaves(loaded.lora))


def test_launcher_trains_checkpoints_and_resumes(tmp_path, monkeypatch, capsys):
    """``--tiny --device cpu``: 2 steps (with a validation image), a JSONL
    log and checkpoints; a second run resumes from the latest one."""
    # the optional TensorBoard writer imports TensorFlow where it is installed
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    out = str(tmp_path / "run")
    common = ["--tiny", "--device", "cpu", "--output-dir", out,
              "--checkpoint-every", "1", "--checkpoints-total-limit", "2",
              "--lr-scheduler", "constant"]
    launcher.main(common + ["--max-train-steps", "2", "--validation-steps", "1"])
    assert sorted(os.listdir(out)) == ["checkpoint-1", "checkpoint-2",
                                       "train.jsonl", "validation_1.png"]
    saved = torch.load(os.path.join(out, "checkpoint-2", tckpt.FILE),
                       weights_only=True)
    assert float(saved["dual_blocks"]["ff"]["in"]["b"].abs().max()) > 0  # trained
    launcher.main(common + ["--max-train-steps", "3"])
    assert "resumed LoRA from step 2" in capsys.readouterr().out
    with open(os.path.join(out, "train.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert sorted(n for n in os.listdir(out) if n.startswith("checkpoint-")) == \
        ["checkpoint-2", "checkpoint-3"]


@pytest.mark.parametrize("clip", [True, False], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("schedule,lr,wd", [("constant", 1.0, 0.0),
                                            ("cosine", 0.5, 0.1)])
def test_prodigy_matches_optax(schedule, lr, wd, clip):
    """Four Prodigy steps behind the global-norm clip on a toy tree, against
    ``make_optimizer``'s ``optax.contrib.prodigy`` chain: the parameters
    after each step (within 1e-6 of max|param|) and the d-estimate, which
    at lr 1 grows from 1e-6 once the gradients line up with the distance
    travelled (a gradient with a steady part).  No warmup: a first step at
    lr 0 gives both packages d = 0 / 0."""
    kw = dict(optimizer="prodigy", learning_rate=lr, lr_scheduler=schedule,
              warmup_steps=0, max_train_steps=6, weight_decay=wd,
              max_grad_norm=0.5 if clip else 1e3)
    jt, tt = _configs(**kw)
    rng = np.random.default_rng(21)
    params = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
              "b": rng.normal(size=(5,)).astype(np.float32)}
    steady = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                          params)
    jx = jfl.make_optimizer(jt)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jx.init(jp)
    tx = tfl.make_optimizer(tt)
    assert isinstance(tx, tfl.ClippedProdigy)
    tp = params_from_jax(params, "cpu")
    tstate = tx.init(tp)
    for step in range(4):
        grads = jax.tree.map(
            lambda s: (s + 0.3 * rng.normal(size=s.shape)).astype(np.float32),
            steady)
        updates, jstate = jx.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tx.step(tp, params_from_jax(grads, "cpu"), tstate)
        assert _max_rel(_leaves_np(tp), _leaves_np(jp)) <= OPT_REL, step
        d_j = float(jstate[1].estim_lr)
        assert abs(float(tstate["estim_lr"]) - d_j) <= 1e-5 * d_j, step
    assert tstate["count"] == 4
    if schedule == "constant":  # the estimate has grown
        assert float(tstate["estim_lr"]) > np.float32(1e-6)


def _vae_trees():
    from unitex_torch.models.flux.vae import VAEConfig as TVAEConfig
    from unitex_torch.models.flux.vae import init_vae_params

    vae = init_vae_params(torch.Generator().manual_seed(22), TVAEConfig.tiny(),
                          device="cpu")
    return jax.tree.map(lambda t: t.numpy(), vae)


def test_preconditioning_loss_and_lora_grads_match_jax(trees):
    """``preconditioning_loss=True`` (weight 0.7) with half the noise
    tokens dropped: the x0 prediction zt − σ·v, the kept predictions
    scattered back to the full grid (zero velocity elsewhere), decoded
    through the frozen tiny VAE under autograd (its blocks checkpointed),
    and its pixel MSE against ``pixel_values`` added to the flow loss: the
    loss and every LoRA gradient against JAX's ``flow_match_loss`` with
    the VAE.  (Without a drop the scatter is skipped and the rest is the
    same code.)"""
    from unitex_tpu.models.flux.vae import VAEConfig as JVAEConfig
    from unitex_torch.models.flux.vae import VAEConfig as TVAEConfig

    base, lora = trees
    jt, tt = _configs(drop_rate=0.5, preconditioning_loss=True,
                      preconditioning_loss_weight=0.7)
    vae = _vae_trees()
    batch = _batch(23)
    batch["pixel_values"] = np.random.default_rng(24).random(
        (B, 2 * HL, 2 * WL, 3)).astype(np.float32)
    key = jax.random.key(25)

    def jloss(lora, base, batch, vae):
        return jfl.flow_match_loss(lora, base, JFluxConfig.tiny(), jt, batch,
                                   key, vae_params=vae,
                                   vae_cfg=JVAEConfig.tiny())

    loss_j, grads_j = jit_reference(jax.value_and_grad(jloss))(
        *(jax.tree.map(jnp.asarray, x) for x in (lora, base, batch, vae)))
    lora_t = _torch_lora(lora)
    loss_t = tfl.flow_match_loss(
        lora_t, params_from_jax(base, "cpu"), TFluxConfig.tiny(), tt,
        params_from_jax(batch, "cpu"), None, **_jax_draws(key, jt),
        vae_params=params_from_jax(vae, "cpu"), vae_cfg=TVAEConfig.tiny())
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) <= LOSS_REL * abs(float(loss_j))
    got = _leaves_np(tfl._map(lambda p: p.grad, lora_t))
    for k, want in _leaves_np(grads_j).items():
        assert np.abs(got[k] - want).max() <= GRAD_REL * np.abs(want).max(), k
    with pytest.raises(ValueError, match="frozen VAE"):
        tfl.flow_match_loss(lora_t, params_from_jax(base, "cpu"),
                            TFluxConfig.tiny(), tt, params_from_jax(batch, "cpu"),
                            None, **_jax_draws(key, jt))


def test_vae_decode_with_grad_equals_plain(trees):
    """The checkpointed decode gives ``vae_decode``'s images bit for bit,
    and the same input gradient as the decode without checkpoints."""
    from unitex_torch.models.flux.vae import (VAEConfig, _decode, vae_decode,
                                              vae_decode_with_grad)

    vae = params_from_jax(_vae_trees(), "cpu")
    z0 = torch.from_numpy(np.random.default_rng(26).normal(
        size=(1, 8, 12, 4)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(27).normal(
        size=(1, 16, 24, 3)).astype(np.float32))
    grads = []
    for decode in (vae_decode_with_grad, _decode):  # checkpointed, plain
        z = z0.clone().requires_grad_(True)
        img = decode(vae, VAEConfig.tiny(), z)
        assert torch.equal(img.detach(), vae_decode(vae, VAEConfig.tiny(), z0))
        (img * w).sum().backward()
        grads.append(z.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-6)


def test_launcher_trains_from_pretrain_models(tmp_path, monkeypatch):
    """``--pretrain-models`` (the full model's path, its config cut to the
    tiny one) with ``--optimizer prodigy --preconditioning-loss
    --preconditioning-loss-weight 0.5``: the launcher reads a seeded
    checkpoint written under the diffusers names into
    ``<root>/flux/{transformer,vae}`` (the trees it trains on are the
    written ones, leaf for leaf), trains 2 steps with finite losses and
    writes the adapter."""
    import importlib.util

    from unitex_torch.models.flux import loader
    from unitex_torch.models.flux.vae import VAEConfig as TVAEConfig
    from unitex_torch.models.flux.vae import init_vae_params

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = dataclasses.replace(TFluxConfig.tiny(), remat=True)
    vcfg = TVAEConfig.tiny()
    monkeypatch.setattr(launcher, "full_size", lambda: (cfg, vcfg, 32))
    gen = torch.Generator()
    written = (tmodel.init_flux_params(gen.manual_seed(28), cfg, device="cpu"),
               init_vae_params(gen.manual_seed(29), vcfg, device="cpu"))
    root = str(tmp_path / "models")
    cs.write_checkpoint(root, *written, {})
    loaded = {}
    for name in ("load_flux_transformer", "load_vae"):
        fn = getattr(loader, name)
        monkeypatch.setattr(loader, name, lambda *a, _fn=fn, _n=name, **k:
                            loaded.setdefault(_n, _fn(*a, **k)))
    out = str(tmp_path / "run")
    losses = []
    state = launcher.main(
        ["--pretrain-models", root, "--device", "cpu", "--optimizer",
         "prodigy", "--preconditioning-loss", "--preconditioning-loss-weight",
         "0.5", "--learning-rate", "1.0", "--lr-scheduler", "constant",
         "--max-train-steps", "2", "--output-dir", out],
        on_step=lambda step, st, loss: losses.append(float(loss)))
    assert len(losses) == 2 and all(np.isfinite(losses))
    for tree, name in zip(written, ("load_flux_transformer", "load_vae")):
        got = dict(cs._named_leaves(loaded[name]))
        for path, leaf in cs._named_leaves(tree):
            assert torch.equal(got[path], leaf), (name, path)
    assert float(state.opt_state["estim_lr"]) >= np.float32(1e-6)
    saved = torch.load(os.path.join(out, "checkpoint-2", tckpt.FILE),
                       weights_only=True)
    assert float(saved["dual_blocks"]["ff"]["in"]["b"].abs().max()) > 0


def test_iterate_host_sharded_matches_jax_and_cuts_over_data():
    """Global batches of 4 from a stream: without a mesh the whole batch,
    as the JAX package's on its one process; on a mesh this data rank's
    slice (index 1 of data 2: examples 2-3 of each batch)."""
    from unitex_torch.parallel.mesh import Mesh

    stream = [{"target": np.full((2, 2, 3), i, np.float32),
               "control": np.full((2, 2, 3), -i, np.float32)} for i in range(8)]
    want = list(jdata.iterate_host_sharded(iter(stream), 4))
    got = list(tdata.iterate_host_sharded(iter(stream), 4))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    mesh = Mesh({"data": 2, "pipe": 1, "seq": 1, "model": 1},
                {"data": 1, "pipe": 0, "seq": 0, "model": 0}, {},
                torch.device("cpu"))
    half = list(tdata.iterate_host_sharded(iter(stream), 4, mesh))
    assert [b["target"][:, 0, 0, 0].tolist() for b in half] == [[2, 3], [6, 7]]
