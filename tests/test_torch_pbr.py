"""The PBR shading terms (``texture/pbr.py``) and the environment maps
(``texture/envmap.py``) in the port against the JAX package, on the CPU:
the same seeded inputs, within 1e-5 of the largest value (absolute below
1).  The JAX side runs as one jitted program per test."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unitex_torch.texture as ttex
from unitex_torch.texture import envmap as tenv
from unitex_torch.texture import pbr as tpbr
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

jpbr = importlib.import_module("unitex_tpu.texture.pbr")
jenv = importlib.import_module("unitex_tpu.texture.envmap")

TOL = 1e-5
N = 256


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def surf():
    rng = np.random.default_rng(0)
    nrm = _unit(rng.normal(size=(N, 3)))
    # views and lights mostly in front of the surface, some behind
    wo = _unit(nrm + rng.normal(size=(N, 3)) * 0.8)
    wi = _unit(nrm + rng.normal(size=(N, 3)) * 0.8)
    return {
        "nrm": nrm, "wo": wo, "wi": wi,
        "kd": rng.uniform(0, 1, (N, 3)).astype(np.float32),
        "arm": rng.uniform(0, 1, (N, 3)).astype(np.float32),
        "pos": rng.normal(size=(N, 3)).astype(np.float32),
        "view": (rng.normal(size=(N, 3)) * 3).astype(np.float32),
        "light": (rng.normal(size=(N, 3)) * 3).astype(np.float32),
        "pert": _unit(rng.normal(size=(N, 3)) + [0, 0, 1.5]),
        "tng": _unit(rng.normal(size=(N, 3))),
        "geom": _unit(rng.normal(size=(N, 3))),
        "cos": rng.uniform(-0.2, 1.2, (N, 1)).astype(np.float32),
        "cos2": rng.uniform(-0.2, 1.2, (N, 1)).astype(np.float32),
        "alpha": rng.uniform(0, 1, (N, 1)).astype(np.float32),
        "img": rng.uniform(0, 4, (8, 8, 3)).astype(np.float32),
        "target": rng.uniform(0, 4, (8, 8, 3)).astype(np.float32),
    }


def _terms(m, x):
    out = {
        "fresnel": m.fresnel_schlick(x["kd"], 1.0, x["cos"]),
        "ndf": m.ndf_ggx(x["alpha"], x["cos"]),
        "lambda": m.lambda_ggx(x["alpha"], x["cos"]),
        "smith": m.masking_smith(x["alpha"], x["cos"], x["cos2"]),
        "lambert": m.lambert(x["nrm"], x["wi"]),
        "frostbite": m.frostbite_diffuse(x["nrm"], x["wi"], x["wo"],
                                         x["arm"][:, 1:2]),
        "specular": m.pbr_specular(x["kd"], x["nrm"], x["wo"], x["wi"],
                                   x["alpha"]),
        "reflect": m.reflect(x["wo"], x["nrm"]),
        "loss_l1": m.image_loss(x["img"], x["target"]),
        "loss_l2": m.image_loss(x["img"], x["target"], loss="mse"),
        "loss_linear": m.image_loss(x["img"], x["target"], tonemapper="none"),
    }
    for bsdf in ("lambert", "frostbite"):
        out[f"bsdf_{bsdf}"] = m.pbr_bsdf(x["kd"], x["arm"], x["pos"], x["nrm"],
                                         x["view"], x["light"], bsdf=bsdf)
    for opengl in (True, False):
        for two_sided in (True, False):
            out[f"shading_{opengl}_{two_sided}"] = m.prepare_shading_normal(
                x["pos"], x["view"], x["pert"], x["nrm"], x["tng"], x["geom"],
                two_sided_shading=two_sided, opengl=opengl)
    return out


def _check(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=TOL * max(1.0, np.abs(w).max()),
                                   err_msg=k)


def test_bsdf_terms_match_jax(surf):
    want = jit_reference(lambda d: _terms(jpbr, d))(
        {k: jnp.asarray(v) for k, v in surf.items()})
    got = _terms(tpbr, {k: torch.from_numpy(v) for k, v in surf.items()})
    _check(got, want)
    assert (np.asarray(want["specular"]) > 0).any()
    assert (np.asarray(want["frostbite"]) == 0).any()


def test_texture_package_exports_the_terms():
    for name in ("fresnel_schlick", "ndf_ggx", "lambda_ggx", "masking_smith",
                 "lambert", "frostbite_diffuse", "pbr_specular", "pbr_bsdf",
                 "prepare_shading_normal"):
        assert getattr(ttex, name) is getattr(tpbr, name)


@pytest.fixture(scope="module")
def env():
    """A 16 x 32 equirect map: a bright spot above a gradient."""
    yy, xx = np.mgrid[:16, :32]
    e = np.stack([xx / 31.0, yy / 15.0, 0.5 + 0 * xx], -1) * 0.5
    e[2:5, 8:12] += 4.0
    return e.astype(np.float32)


def _env_terms(m, env, x):
    coeffs = m.sh_project_irradiance(env)
    levels = m.prefilter_specular_levels(env, 5)
    rough = x["arm"][:, 1:2]
    return {
        "dirs": m.equirect_dirs(16, 32),
        "to_equirect": m.direction_to_equirect(x["nrm"]),
        "sample": m.sample_envmap(env, x["wo"]),
        "coeffs": coeffs,
        "irradiance": m.sh_irradiance(coeffs, x["nrm"]),
        **{f"level_{i}": lv for i, lv in enumerate(levels)},
        "prefiltered": m.sample_prefiltered(levels, x["wo"], rough),
        "prefiltered_flat": m.sample_prefiltered(levels, x["wo"], rough[:, 0]),
        "lut": m.karis_brdf_lut(x["cos"], rough),
        "shade": m.shade_split_sum(x["kd"], x["arm"], x["nrm"], x["wo"], env),
    }


def test_envmap_matches_jax(surf, env):
    """The equirect mapping, the SH irradiance, the prefiltered levels and
    their lookup, the Karis LUT and the whole split-sum shade."""
    want = jit_reference(lambda e, d: _env_terms(jenv, e, d))(
        jnp.asarray(env), {k: jnp.asarray(v) for k, v in surf.items()})

    class _Port:   # the port's functions, its maps built on the CPU
        def __getattr__(self, name):
            if name == "equirect_dirs":
                return lambda H, W: tenv.equirect_dirs(H, W, device="cpu")
            return getattr(tenv, name)

    got = _env_terms(_Port(), torch.from_numpy(env),
                     {k: torch.from_numpy(v) for k, v in surf.items()})
    _check(got, want)
