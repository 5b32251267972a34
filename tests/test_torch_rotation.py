"""Rotation conversions (``camera/rotation.py``) in the port against the
JAX package, on the CPU: every one of the 20 functions on the same seeded
inputs, within 1e-5.  The random rotations take JAX's normal draws.  The
JAX side runs as one jitted program per test (eagerly it compiles each of
its ops)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitex_torch.camera import rotation as trot
from torch_cpu_share import share_cpu

share_cpu()

jrot = importlib.import_module("unitex_tpu.camera.rotation")

TOL = 1e-5
CONVENTIONS = ("XYZ", "ZYX", "YXZ", "XZX", "ZYZ", "YZY")


def _inputs():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    x = {
        "euler": rng.uniform(-1.2, 1.2, (64, 3)).astype(np.float32),
        "quat": q / np.linalg.norm(q, axis=1, keepdims=True),
        "quat_b": rng.normal(size=(64, 4)).astype(np.float32),
        "aa": np.concatenate([rng.normal(size=(60, 3)),
                              np.full((4, 3), 1e-8)]).astype(np.float32),
        "d6": rng.normal(size=(64, 6)).astype(np.float32),
        "pts": rng.normal(size=(64, 3)).astype(np.float32),
    }
    # rotations by 3.1 rad, where the real part is not the largest
    x["aa_pi"] = (x["aa"][:60] / np.linalg.norm(x["aa"][:60], axis=1,
                                                keepdims=True) * 3.1)
    return x


def _all(m, x):
    """Every conversion of module ``m`` on the inputs ``x``."""
    out = {}
    for c in CONVENTIONS:
        R = m.euler_angles_to_matrix(x["euler"], c)
        out[f"euler_{c}"] = R
        out[f"euler_back_{c}"] = m.matrix_to_euler_angles(R, c)
    R = m.quaternion_to_matrix(x["quat"])
    out["q2m"] = R
    out["m2q"] = m.matrix_to_quaternion(R)
    out["m2q_pi"] = m.matrix_to_quaternion(m.axis_angle_to_matrix(x["aa_pi"]))
    out["aa2m"] = m.axis_angle_to_matrix(x["aa"])
    out["d6"] = m.rotation_6d_to_matrix(x["d6"])
    out["m2d6"] = m.matrix_to_rotation_6d(R)
    out["std"] = m.standardize_quaternion(x["quat_b"])
    out["raw_mul"] = m.quaternion_raw_multiply(x["quat"], x["quat_b"])
    out["mul"] = m.quaternion_multiply(x["quat"], x["quat_b"])
    out["inv"] = m.quaternion_invert(x["quat_b"])
    out["apply"] = m.quaternion_apply(x["quat"], x["pts"])
    out["aa2q"] = m.axis_angle_to_quaternion(x["aa"])
    out["q2aa"] = m.quaternion_to_axis_angle(m.axis_angle_to_quaternion(x["aa"]))
    out["m2aa"] = m.matrix_to_axis_angle(m.axis_angle_to_matrix(x["aa"][:60]))
    out["axis_X"] = m._axis_angle_rotation("X", x["euler"][:, 0])
    return out


def test_conversions_match_jax():
    x = _inputs()
    want = jax.jit(lambda d: _all(jrot, d))(
        {k: jnp.asarray(v) for k, v in x.items()})
    got = _all(trot, {k: torch.from_numpy(v) for k, v in x.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=TOL, err_msg=k)


def test_random_rotations_take_jax_draws():
    key = jax.random.PRNGKey(5)
    draws = np.asarray(jax.random.normal(key, (16, 4)))
    want = jax.jit(lambda: (jrot.random_quaternions(16, key),
                            jrot.random_rotations(16, key),
                            jrot.random_rotation(key)))()
    got = (trot.random_quaternions(16, draws=torch.from_numpy(draws)),
           trot.random_rotations(16, draws=torch.from_numpy(draws)),
           trot.random_rotation(draws=torch.from_numpy(draws[:1])))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
    R = trot.random_rotations(8, generator=torch.Generator().manual_seed(0))
    eye = torch.eye(3).expand(8, 3, 3)
    assert torch.allclose(R @ R.transpose(-1, -2), eye, atol=1e-5)
    assert torch.allclose(torch.linalg.det(R), torch.ones(8), atol=1e-5)


@pytest.mark.parametrize("name", ["euler_angles_to_matrix",
                                  "matrix_to_euler_angles"])
def test_bad_conventions_raise(name):
    with pytest.raises(ValueError, match="3 letters"):
        getattr(trot, name)(torch.zeros(3, 3), "XY")
