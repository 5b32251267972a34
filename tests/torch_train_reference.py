"""The inputs and the JAX package's one-device steps that the port's
sharded training steps are held to (tests/test_torch_tp_train.py,
tests/test_torch_pp.py).

One tiny FLUX tree (the port's seeded f32 init) and one rank-2 adapter
with non-zero ``b`` are carried into both packages as numpy, with a
batch and the draws that JAX's ``flow_match_loss`` makes from each
step's key (the port is handed them).  The JAX ``train_step`` and
``full_train_step`` are compiled once each (``jit_reference``), on one
device: no ``shard_map``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from unitex_tpu.models.flux.config import FluxConfig as JFluxConfig
from unitex_tpu.training import flux_lora as jfl
from unitex_tpu.training import full_finetune as jff

from unitex_torch.models.flux.config import FluxConfig
from unitex_torch.models.flux.lora import init_lora_params
from unitex_torch.models.flux.model import init_flux_params
from unitex_torch.models.flux.pipeline import latent_image_ids

import torch_dist_workers as workers
from torch_jax_reference import jit_reference

HL, WL, C = 8, 12, 4     # latents [B, HL, WL, C]: 24 noise tokens of 16
KEYS = (11, 12)          # the two steps' keys


def make_train_inputs(batch: int, seed: int = 0) -> dict:
    """The flattened tree, adapter, batch (``b/*``) and both steps' draws
    (``d0/*``, ``d1/*``)."""
    cfg = FluxConfig.tiny()
    gen = torch.Generator().manual_seed(seed)
    flux = init_flux_params(gen, cfg, device="cpu")
    lora = init_lora_params(gen, flux, rank=workers.TRAIN_KW["rank"],
                            device="cpu")
    rng = np.random.default_rng(seed + 1)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return (0.3 * rng.standard_normal(tuple(node.shape))).astype(np.float32)

    lora = fill(lora)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    inputs = {
        "b/latents": f(batch, HL, WL, C),
        "b/cond_tokens": f(batch, 24, 4 * C),
        "b/cond_ids": latent_image_ids(HL // 2, WL // 2, offset_y=HL // 2,
                                       device="cpu").numpy(),
        "b/prompt_embeds": f(batch, 8, cfg.joint_attention_dim),
        "b/pooled_embeds": f(batch, cfg.pooled_projection_dim),
    }
    tcfg = jfl.FluxLoraTrainConfig(**workers.TRAIN_KW)
    for s, k in enumerate(KEYS):
        inputs.update({f"d{s}/{n}": v for n, v in
                       jax_draws(jax.random.key(k), tcfg, batch).items()})
    inputs.update(workers._prefixed("flux", flux))
    inputs.update(workers._prefixed("lora", lora))
    return inputs


def jax_draws(key, tcfg, n: int) -> dict:
    """The draws JAX's ``flow_match_loss`` makes from ``key``."""
    return {k: np.array(v) for k, v in _drawer(tcfg, n)(key).items()}


@functools.lru_cache(maxsize=None)
def _drawer(tcfg, n: int):
    """:func:`jax_draws` as one jitted program (each op compiled eagerly
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


def nested(inputs: dict, prefix: str):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        workers.unflatten(inputs, prefix))


def _batch(inputs):
    return {k[2:]: jnp.asarray(v) for k, v in inputs.items()
            if k.startswith("b/")}


def _flat(tree) -> dict:
    return workers.flatten(jax.tree.map(np.asarray, tree))


def jax_lora_steps(inputs: dict) -> dict:
    """Two one-device LoRA ``train_step``s: the losses, the adapter and the
    Adam moments after them (flattened by path)."""
    tcfg = jfl.FluxLoraTrainConfig(**workers.TRAIN_KW)
    tx = jfl.make_optimizer(tcfg)
    lora = nested(inputs, "lora")
    state = jfl.TrainState(step=jnp.zeros((), jnp.int32), lora=lora,
                           opt_state=tx.init(lora))
    base, batch = nested(inputs, "flux"), _batch(inputs)
    step = jit_reference(jfl.train_step, static_argnames=("cfg", "tcfg", "tx"))
    losses = []
    for k in KEYS:
        state, loss = step(state, base, batch, jax.random.key(k),
                           cfg=JFluxConfig.tiny(), tcfg=tcfg, tx=tx)
        losses.append(float(loss))
    adam = state.opt_state[1][0]
    return {"losses": np.array(losses),
            **{f"lora/{k}": v for k, v in _flat(state.lora).items()},
            **{f"mu/{k}": v for k, v in _flat(adam.mu).items()},
            **{f"nu/{k}": v for k, v in _flat(adam.nu).items()}}


def jax_full_steps(inputs: dict, bf16: bool) -> dict:
    """Two one-device ``full_train_step``s: the losses, the parameters and
    the Adam moments after them."""
    tcfg = jfl.FluxLoraTrainConfig(**workers.FULL_KW)
    state, tx = jff.create_full_state(nested(inputs, "flux"), tcfg)
    step = jit_reference(jff.full_train_step,
                         static_argnames=("cfg", "tcfg", "tx", "bf16_compute"))
    batch = _batch(inputs)
    losses = []
    for k in KEYS:
        state, loss = step(state, batch, jax.random.key(k),
                           cfg=JFluxConfig.tiny(), tcfg=tcfg, tx=tx,
                           bf16_compute=bf16)
        losses.append(float(loss))
    adam = state.opt_state[1][0]
    return {"losses": np.array(losses),
            **{f"params/{k}": v for k, v in _flat(state.params).items()},
            **{f"mu/{k}": v for k, v in _flat(adam.mu).items()},
            **{f"nu/{k}": v for k, v in _flat(adam.nu).items()}}


def max_rel(got: dict, want: dict, prefix: str) -> float:
    """max|Δ| over the leaves under ``prefix/``, over their max|want|."""
    keys = [k for k in want if k.startswith(prefix + "/")]
    assert keys, prefix
    for k in keys:
        assert got[k].shape == want[k].shape, (k, got[k].shape, want[k].shape)
    return max(float(np.abs(got[k] - want[k]).max()) for k in keys) / max(
        float(np.abs(want[k]).max()) for k in keys)
