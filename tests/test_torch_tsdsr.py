"""The TSD-SR trainer in the port (unitex_torch/training/tsdsr.py, the
SD3 forward with ``lora=``, the launcher) against the JAX package's
(unitex_tpu/training/tsdsr.py), f32 on the CPU.

One tiny SD3 tree (the port's seeded init) and two LoRA trees with
non-zero ``b`` are made once and carried into both packages as numpy;
latents are 16² (64 patches) with 8 prompt tokens.  The JAX side is
jitted once per function in this module; the JAX losses draw their
timesteps and noise from a key and the port is handed the same draws.  On
the CPU the attention gradient is torch autograd through the plain
attention (the kernels B2a/B2b at D = 64 run on the card,
tests/test_torch_kernels.py).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unitex_tpu.models.flux import lora as jflora
from unitex_tpu.models.flux import vae as jvae
from unitex_tpu.models.sd3 import model as jmodel
from unitex_tpu.models.sd3.config import SD3Config as JSD3Config
from unitex_tpu.training import tsdsr as jtsd

from unitex_torch.models.flux import vae as tvae
from unitex_torch.models.sd3 import lora as tlora
from unitex_torch.models.sd3 import model as tmodel
from unitex_torch.models.sd3.config import SD3Config as TSD3Config
from unitex_torch.scripts import train_tsdsr as launcher
from unitex_torch.training import tsdsr as ttsd
from unitex_torch.training.flux_lora import _leaves, _map
from unitex_torch.utils import lpips as tlp
from unitex_torch.utils.params import params_from_jax
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

# f32 on both sides over a 2-layer tiny model; the differences are
# summation order
OUT_ATOL = 1e-5    # the velocity, unit-scale inputs
LOSS_REL = 1e-5    # |Δloss| / |loss|
GRAD_REL = 1e-4    # each gradient leaf: max|Δ| / max|g|
RANK = 4
B, HL, C, S_TXT = 1, 16, 4, 8
JCFG, TCFG = JSD3Config.tiny(), TSD3Config.tiny()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: numpy} of a JAX or torch tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().numpy() if torch.is_tensor(tree)
            else np.asarray(tree)}


def _max_rel(got, want):
    assert got.keys() == want.keys()
    return max(float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
               for k in want)


def _port(tree):
    """A numpy LoRA tree as the port's, leaves requiring gradients."""
    out = params_from_jax(tree, "cpu")
    for leaf in _leaves(out):
        leaf.requires_grad_(True)
    return out


def _grads(tree):
    return _flat(_map(lambda p: p.grad, tree))


@pytest.fixture(scope="module")
def trees():
    """(base, student LoRA, regularizer LoRA, batch), numpy; the LoRA
    trees' shapes from the port's ``init_sd3_lora``, their a and b
    random."""
    base = tmodel.init_sd3_params(torch.Generator().manual_seed(0), TCFG,
                                  device="cpu")
    shapes = _flat(tlora.init_sd3_lora(torch.Generator().manual_seed(1), base,
                                       rank=RANK, device="cpu"))
    rng = np.random.default_rng(2)

    def lora():
        tree = {}
        for path, x in shapes.items():
            node = tree
            *keys, last = path.strip("/").split("/")
            for k in keys:
                node = node.setdefault(k, {})
            node[last] = (0.3 * rng.standard_normal(x.shape)).astype(np.float32)
        return tree

    f = lambda *s: rng.normal(size=s).astype(np.float32)
    batch = {"latent_lr": f(B, HL, HL, C), "latent_hr": f(B, HL, HL, C),
             "prompt_embeds": f(B, S_TXT, 32), "pooled_embeds": f(B, 32),
             "prompt_embeds_null": 0.1 * f(B, S_TXT, 32),
             "pooled_embeds_null": 0.1 * f(B, 32)}
    return _np(jax.tree.map(lambda t: t.numpy(), base)), lora(), lora(), batch


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _draws(key, shape):
    """The (t, noise) a JAX TSD loss draws from ``key``."""
    tc = jtsd.TSDTrainConfig()
    k_t, k_noise = jax.random.split(key)
    t = jax.random.randint(k_t, (shape[0],), tc.t_min, tc.t_max)
    return {"t": np.asarray(t.astype(jnp.float32)),
            "noise": np.asarray(jax.random.normal(k_noise, shape))}


def test_sigma_and_gradient_l1_match_jax():
    t = np.array([0.0, 50.0, 333.0, 949.0, 1000.0], np.float32)
    for shift in (3.0, 1.0):
        np.testing.assert_allclose(
            ttsd._sigma(torch.from_numpy(t), shift).numpy(),
            np.asarray(jtsd._sigma(jnp.asarray(t), shift)), rtol=1e-7)
    rng = np.random.default_rng(3)
    a, b = (rng.normal(size=(2, 9, 7, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        float(ttsd.gradient_l1(torch.from_numpy(a), torch.from_numpy(b))),
        float(jtsd.gradient_l1(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def test_zero_lora_forward_is_the_base_forward(trees):
    """Serving calls keep ``lora=None``; an adapter whose b is 0 merges to
    the same kernels, so the same numbers bit for bit."""
    base, stu, _, batch = trees
    zero = jax.tree.map(np.zeros_like, stu)
    args = [torch.from_numpy(batch[k]) for k in ("latent_lr", "prompt_embeds")]
    t = torch.full((B,), 500.0)
    pooled = torch.from_numpy(batch["pooled_embeds"])
    p = params_from_jax(base, "cpu")
    plain = tmodel.sd3_forward(p, TCFG, *args, t, pooled)
    merged = tmodel.sd3_forward(p, TCFG, *args, t, pooled,
                                lora=params_from_jax(zero, "cpu"))
    assert torch.equal(plain, merged)


def test_sd3_forward_with_lora_and_its_grads_match_jax(trees):
    """``sd3_forward(..., lora=)`` against JAX's ``sd3_forward`` of
    ``merge_lora(base, [(lora, 1)])``: the velocity, and the gradients of
    a weighted sum of it with respect to every adapter leaf against
    ``jax.grad``."""
    base, stu, _, batch = trees
    w = np.random.default_rng(4).normal(size=(B, HL, HL, C)).astype(np.float32)
    t = np.array([700.0], np.float32)

    def jloss(lora, base):
        v = jmodel.sd3_forward(jflora.merge_lora(base, [(lora, 1.0)]), JCFG,
                               batch["latent_lr"], batch["prompt_embeds"],
                               jnp.asarray(t), batch["pooled_embeds"])
        return jnp.sum(v * w), v

    (_, v_j), g_j = jit_reference(jax.value_and_grad(jloss, has_aux=True))(
        _j(stu), _j(base))
    lora = _port(stu)
    v_t = tmodel.sd3_forward(
        params_from_jax(base, "cpu"), TCFG,
        torch.from_numpy(batch["latent_lr"]),
        torch.from_numpy(batch["prompt_embeds"]), torch.from_numpy(t),
        torch.from_numpy(batch["pooled_embeds"]), lora=lora)
    np.testing.assert_allclose(v_t.detach().numpy(), np.asarray(v_j),
                               atol=OUT_ATOL)
    (v_t * torch.from_numpy(w)).sum().backward()
    got = _grads(lora)
    for k, want in _flat(g_j).items():
        assert np.abs(got[k] - want).max() <= GRAD_REL * np.abs(want).max(), k


# the step the JAX reference takes: lr 1e-3 and Adam's eps 1e-4 (a first
# Adam step is g / (|g| + eps): with eps 1e-8 it is the sign of the
# gradient elements within the sums' rounding of 0, which summation order
# decides); no clip (max norm 1e9), so each Adam moment mu after the step
# is (1 - b1) · g: the gradients themselves.  The clip and optax's
# defaults are held by test_tsd_optimizer_is_optax_adamw.
STEP = dict(lr=1e-3, eps=1e-4, max_norm=1e9)


def _jax_tx():
    import optax

    return optax.chain(optax.clip_by_global_norm(STEP["max_norm"]),
                       optax.adamw(STEP["lr"], eps=STEP["eps"]))


def _port_tx():
    from unitex_torch.training.flux_lora import ClippedAdamW

    return ClippedAdamW(lambda count: STEP["lr"], 0.9, 0.999, STEP["eps"],
                        1e-4, STEP["max_norm"])


@pytest.fixture(scope="module")
def jax_step(trees):
    """JAX's ``tsd_train_step`` at key 7, jitted once: (student LoRA, reg
    LoRA, their optimizer states, metrics), and the draws of each phase."""
    base, stu, reg, batch = trees
    key = jax.random.key(7)
    tx = _jax_tx()

    def step(s, r, base, batch):
        state = jtsd.TSDTrainState(0, s, r, tx.init(s), tx.init(r))
        new, m = jtsd.tsd_train_step(state, base, JCFG, jtsd.TSDTrainConfig(),
                                     batch, key, tx, tx)
        return (new.student_lora, new.reg_lora, new.opt_state_student,
                new.opt_state_reg, m)

    out = _np(jit_reference(step)(_j(stu), _j(reg), _j(base), _j(batch)))
    k_s, k_r = jax.random.split(key)
    shape = batch["latent_lr"].shape
    return out, {"student": _draws(k_s, shape), "reg": _draws(k_r, shape)}


def _jax_grads(opt_state):
    """The gradients of a phase: its Adam mu after one unclipped step."""
    return jax.tree.map(lambda m: m / (1 - 0.9), opt_state[1][0].mu)


def _student(trees, draws):
    base, stu, reg, batch = trees
    lora = _port(stu)
    loss, aux = ttsd.tsd_student_loss(
        lora, _port(reg), params_from_jax(base, "cpu"), TCFG,
        ttsd.TSDTrainConfig(), params_from_jax(batch, "cpu"),
        **draws["student"])
    return lora, loss, aux


def test_student_loss_and_lora_grads_match_jax(trees, jax_step):
    """The student phase (student forward, the teacher's two CFG forwards,
    the regularizer's, TSD + MSE + gradient-L1 data loss) with JAX's t and
    noise: the loss and its parts against JAX's step's metrics, and the
    gradient of every student adapter leaf against the gradient
    ``jax.value_and_grad`` took in that step."""
    (_, _, opt_s, _, metrics), draws = jax_step
    lora, loss, aux = _student(trees, draws)
    loss.backward()
    for k, got in (("loss", loss), ("tsd_loss", aux["tsd_loss"]),
                   ("data_loss", aux["data_loss"])):
        want = float(metrics[k])
        assert abs(float(got) - want) <= LOSS_REL * abs(want), k
    got = _grads(lora)
    for k, want in _flat(_jax_grads(opt_s)).items():
        assert np.abs(got[k] - want).max() <= GRAD_REL * np.abs(want).max(), k


def test_regularizer_loss_and_lora_grads_match_jax(trees, jax_step):
    """The regularizer phase on the student's sample, with JAX's t and
    noise: the loss and the gradient of every regularizer adapter leaf
    (the final block's context query has none: its context output is
    dropped), against JAX's step."""
    base, _, reg, batch = trees
    (_, _, _, opt_r, metrics), draws = jax_step
    with torch.no_grad():
        latent_stu = _student(trees, draws)[2]["latent_stu"]
    lora = _port(reg)
    loss = ttsd.tsd_regularizer_loss(
        lora, params_from_jax(base, "cpu"), TCFG, ttsd.TSDTrainConfig(),
        latent_stu, torch.from_numpy(batch["prompt_embeds"]),
        torch.from_numpy(batch["pooled_embeds"]), **draws["reg"])
    loss.backward()
    want = float(metrics["reg_loss"])
    assert abs(float(loss) - want) <= LOSS_REL * abs(want)
    got = _grads(lora)
    for k, want in _flat(_jax_grads(opt_r)).items():
        assert np.abs(got[k] - want).max() <= GRAD_REL * np.abs(want).max(), k


def test_train_step_matches_jax(trees, jax_step):
    """One whole ``tsd_train_step`` (both phases, each followed by its
    optimizer step) from the same adapters and fresh optimizer states,
    with JAX's draws: the four metrics, both adapters after the step (each
    leaf moved by about lr, held to 1e-3 of that) and both Adam moments."""
    base, stu, reg, batch = trees
    (s_j, r_j, os_j, or_j, m_j), draws = jax_step
    state, _, _ = ttsd.create_tsd_state(
        torch.Generator().manual_seed(0), params_from_jax(base, "cpu"),
        ttsd.TSDTrainConfig(rank=RANK), device="cpu")
    tx = _port_tx()
    state.student_lora, state.reg_lora = _port(stu), _port(reg)
    state.opt_state_student = tx.init(state.student_lora)
    state.opt_state_reg = tx.init(state.reg_lora)
    state, m_t = ttsd.tsd_train_step(state, params_from_jax(base, "cpu"), TCFG,
                                     ttsd.TSDTrainConfig(),
                                     params_from_jax(batch, "cpu"), tx, tx,
                                     draws=draws)
    assert state.step == 1
    for k, v in m_j.items():
        assert abs(float(m_t[k]) - float(v)) <= LOSS_REL * abs(float(v)), k
    for got, want, opt_t, opt_j in ((state.student_lora, s_j,
                                     state.opt_state_student, os_j),
                                    (state.reg_lora, r_j, state.opt_state_reg,
                                     or_j)):
        adam = opt_j[1][0]  # chain(clip, adamw): adamw's scale_by_adam
        assert opt_t["count"] == int(adam.count) == 1
        for mine, theirs, rel in ((opt_t["mu"], adam.mu, GRAD_REL),
                                  (opt_t["nu"], adam.nu, 2 * GRAD_REL)):
            a, b = _flat(mine), _flat(theirs)
            for k in b:
                assert np.abs(a[k] - b[k]).max() <= rel * np.abs(b[k]).max(), k
        g, w = _flat(got), _flat(want)
        assert max(float(np.abs(g[k] - w[k]).max()) for k in w) <= \
            1e-3 * STEP["lr"]


def test_tsd_optimizer_is_optax_adamw():
    """``create_tsd_state``'s optimizers (``_adamw``) against the JAX
    package's ``optax.chain(clip_by_global_norm(1), adamw(lr))`` (b1 0.9,
    b2 0.999, eps 1e-8, weight decay 1e-4), three steps on a toy tree with
    gradients that trigger the clip: within 1e-6 of max|param| a step."""
    import optax

    tcfg = ttsd.TSDTrainConfig(learning_rate=0.05, reg_learning_rate=0.02)
    assert tcfg.max_grad_norm == jtsd.TSDTrainConfig().max_grad_norm == 1.0
    lora = {"w": np.random.default_rng(11).normal(size=(3, 4)).astype(np.float32)}
    rng = np.random.default_rng(12)
    for lr in (tcfg.learning_rate, tcfg.reg_learning_rate):
        jx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr))
        tx = ttsd._adamw(lr, tcfg.max_grad_norm)
        jp, tp = _j(lora), params_from_jax(lora, "cpu")
        js, ts = jx.init(jp), tx.init(tp)
        for step in range(3):
            g = {"w": (3 * rng.normal(size=(3, 4))).astype(np.float32)}
            upd, js = jx.update(_j(g), js, jp)
            jp = optax.apply_updates(jp, upd)
            tx.step(tp, params_from_jax(g, "cpu"), ts)
            assert _max_rel(_flat(tp), _flat(jp)) <= 1e-6, step


def test_lpips_perceptual_fn_matches_jax(trees):
    """``make_lpips_perceptual_fn`` on the tiny VAE's decodes (LPIPS-Alex of
    the decoded student and HR latents, no gradient through the HR side):
    the value within 1e-5 and its gradient with respect to the student
    latent within 1e-2 of its largest element.  The gradient is not smooth
    in the image: each max-pool routes it to its window's largest value,
    and a window whose top two are within f32 rounding of each other may
    route it elsewhere in the other package (on these inputs the port's
    f32 gradient is 3e-3 from its own f64 one, JAX's 3e-6)."""
    _, _, _, batch = trees
    vcfg = tvae.VAEConfig.tiny()
    vae_t = tvae.init_vae_params(torch.Generator().manual_seed(8), vcfg,
                                 device="cpu")
    lp = tlp.init_lpips_params(torch.Generator().manual_seed(9), "alex",
                               device="cpu")
    vae_j = _j(_flat_to_np(vae_t))
    lp_j = {"net": [[_j({k: v.numpy() for k, v in layer.items()})
                     for layer in stage] for stage in lp["net"]],
            "lins": [jnp.asarray(w.numpy()) for w in lp["lins"]],
            "pnet": "alex"}
    stu, hr = batch["latent_lr"], batch["latent_hr"]
    jfn = jtsd.make_lpips_perceptual_fn(
        lp_j, lambda z: jvae.vae_decode(vae_j, jvae.VAEConfig.tiny(), z)
        * 0.5 + 0.5)
    val_j, g_j = jit_reference(jax.value_and_grad(jfn))(jnp.asarray(stu),
                                                  jnp.asarray(hr))
    tfn = ttsd.make_lpips_perceptual_fn(
        lp, lambda z: tvae.vae_decode_with_grad(vae_t, vcfg, z) * 0.5 + 0.5)
    z = torch.from_numpy(stu).requires_grad_(True)
    val = tfn(z, torch.from_numpy(hr))
    val.backward()
    assert abs(float(val) - float(val_j)) <= LOSS_REL * abs(float(val_j))
    g_j = np.asarray(g_j)
    assert np.abs(z.grad.numpy() - g_j).max() <= 1e-2 * np.abs(g_j).max()


def _flat_to_np(tree):
    """A nested dict / list tree of tensors as numpy."""
    if isinstance(tree, dict):
        return {k: _flat_to_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_flat_to_np(v) for v in tree]
    return tree.numpy()


def test_launcher_trains_and_checkpoints(tmp_path, monkeypatch):
    """``--tiny --cpu`` for 2 steps on a synthetic paired folder (40 x 48
    HR, 10 x 12 LR, 32² crops): a JSONL log of both steps with finite
    losses and the final checkpoint of both adapters, which have left
    b = 0."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    rng = np.random.default_rng(10)
    dirs = {k: tmp_path / k for k in ("hr", "lr")}
    for d in dirs.values():
        d.mkdir()
    for i in range(3):
        hr = (rng.random((40, 48, 3)) * 255).astype(np.uint8)
        Image.fromarray(hr).save(dirs["hr"] / f"{i}.png")
        Image.fromarray(hr[::4, ::4]).save(dirs["lr"] / f"{i}.png")
    out = str(tmp_path / "run")
    seen = []
    state = launcher.main(
        ["--lr-dir", str(dirs["lr"]), "--hr-dir", str(dirs["hr"]), "--tiny",
         "--cpu", "--steps", "2", "--gt-size", "32", "--log-every", "1",
         "--output-dir", out],
        on_step=lambda it, st, m: seen.append(it))
    assert seen == [1, 2] and state.step == 2
    with open(os.path.join(out, "train.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert all(np.isfinite(r[k]) for k in
                   ("loss", "tsd_loss", "data_loss", "reg_loss"))
    saved = torch.load(os.path.join(out, "checkpoints", "checkpoint-2",
                                    "state.pt"), weights_only=True)
    assert sorted(saved) == ["reg_lora", "student_lora"]
    for tree in saved.values():
        assert float(tree["blocks"]["attn"]["to_q"]["b"].abs().max()) > 0
