"""Texture and camera-pose refinement (``texture/refine.py``) in the port
against the JAX package, on the CPU: 10 Adam steps from the same start
on the same renders, the loss of every step and the result within 1e-4
(the poses refined against a render within 1e-3: see
:func:`test_refine_poses_matches_jax`).  The port's Adam is
``training/flux_lora.ClippedAdamW`` without clipping or decay, which has
optax's arithmetic."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitex_tpu.camera.generator import generate_intrinsics
from unitex_tpu.geometry.mesh import Mesh as JMesh
from unitex_tpu.geometry.primitives import make_torus
from unitex_tpu.geometry.uv_atlas import unwrap_atlas
from unitex_tpu.render.unify import generate_cameras_v1

from unitex_torch.geometry.mesh import Mesh as TMesh
from unitex_torch.texture import refine as trefine
from torch_cpu_share import share_cpu

share_cpu()

jrefine = importlib.import_module("unitex_tpu.texture.refine")

TOL = 1e-4
STEPS = 10


@pytest.fixture(scope="module")
def scene():
    host = unwrap_atlas(make_torus(), size=32, gutter=1)
    v = host.vertices.astype(np.float32) * np.float32(0.9)
    c2ws, _ = generate_cameras_v1(3, True)
    intr = generate_intrinsics(49.1, 49.1, fov=True, degree=True)
    yy, xx = np.mgrid[:32, :32] / 31.0
    tex = np.stack([xx, yy, 0.5 + 0.4 * np.sin(6 * xx)], -1).astype(np.float32)
    rng = np.random.default_rng(0)
    targets = rng.uniform(0.2, 0.8, (3, 32, 32, 3)).astype(np.float32)
    arrays = (v, host.faces, host.uv, host.faces_uv)
    return {
        "jmesh": JMesh(*(jnp.asarray(a) for a in arrays)),
        "tmesh": TMesh(*(torch.from_numpy(np.asarray(a, dt)) for a, dt in zip(
            arrays, (np.float32, np.int64, np.float32, np.int64)))),
        "c2ws": np.asarray(c2ws), "intr": np.asarray(intr), "tex": tex,
        "targets": targets,
    }


@pytest.mark.parametrize("init", [False, True], ids=["zeros", "init"])
def test_refine_texture_matches_jax(scene, init):
    cfg = dict(texture_size=16, steps=STEPS, lr=5e-2, tv_weight=1e-2,
               loss="l2" if init else "l1")
    init_tex = scene["tex"][::2, ::2] if init else None
    want_tex, want_loss = jrefine.refine_texture(
        scene["jmesh"], jnp.asarray(scene["c2ws"]), jnp.asarray(scene["intr"]),
        jnp.asarray(scene["targets"]), perspective=True,
        init_texture=None if init_tex is None else jnp.asarray(init_tex),
        cfg=jrefine.TextureRefineConfig(**cfg))
    got_tex, got_loss = trefine.refine_texture(
        scene["tmesh"], torch.from_numpy(scene["c2ws"]),
        torch.from_numpy(scene["intr"]), torch.from_numpy(scene["targets"]),
        perspective=True,
        init_texture=None if init_tex is None else torch.from_numpy(
            np.ascontiguousarray(init_tex)),
        cfg=trefine.TextureRefineConfig(**cfg))
    assert tuple(got_loss.shape) == (STEPS,) and tuple(got_tex.shape) == (16, 16, 3)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got_tex.numpy(), np.asarray(want_tex), rtol=0,
                               atol=TOL)
    assert got_loss[-1] < got_loss[0]


def _blur(img, k=7, sigma=2.0):
    """A separable gaussian blur of [M, H, W, C], edges repeated."""
    x = np.arange(k) - k // 2
    w = np.exp(-x ** 2 / (2 * sigma ** 2))
    w /= w.sum()
    for axis in (1, 2):
        pad = [(0, 0)] * 4
        pad[axis] = (k // 2, k // 2)
        p = np.pad(img, pad, mode="edge")
        img = sum(w[i] * np.take(p, np.arange(i, i + img.shape[axis]), axis=axis)
                  for i in range(k))
    return img.astype(np.float32)


@pytest.mark.parametrize("target", ["ramp", "render"])
def test_refine_poses_matches_jax(scene, target):
    """The estimates start turned and moved from the cameras of the
    targets.  At the first step every pixel re-projects onto a pixel
    centre, where the bilinear lookup's derivative jumps, and a last-bit
    difference of the projection picks the other side: on a rendered
    target that first gradient differs by about 1 % between the packages
    (off the centres they agree to 5e-7), and Adam carries it on.  So the
    poses are held to 1e-4 on a target whose slopes are the same on both
    sides of every centre (an affine ramp), and to 1e-3 on the render
    from the true poses, blurred so that its silhouette's jumps do not
    move the losses past 1e-4, where the loss must also go down."""
    from unitex_tpu.render.renderer import render_views

    c2ws = scene["c2ws"]
    if target == "ramp":
        yy, xx = np.mgrid[:32, :32] / 31.0
        ramp = np.stack([xx, yy, 0.5 + 0.3 * (xx - yy)], -1).astype(np.float32)
        targets = np.broadcast_to(ramp, (3, 32, 32, 3)).copy()
    else:
        out = render_views(scene["jmesh"], jnp.asarray(c2ws),
                           jnp.asarray(scene["intr"]), (32, 32), perspective=True,
                           map_attr=jnp.asarray(scene["tex"]), render_uv=True,
                           render_map_attr=True)
        targets = _blur(np.asarray(out.map_attr * out.alpha + (1 - out.alpha)))
    a = 0.05
    turn = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]], np.float32)
    start = c2ws.copy()
    start[:, :3, :3] = turn @ c2ws[:, :3, :3]
    start[:, :3, 3] += 0.03
    cfg = jrefine.PoseRefineConfig(steps=STEPS, lr=3e-3)
    want_c2w, want_loss = jrefine.refine_poses(
        scene["jmesh"], jnp.asarray(start), jnp.asarray(scene["intr"]),
        jnp.asarray(targets), jnp.asarray(scene["tex"]), perspective=True, cfg=cfg)
    got_c2w, got_loss = trefine.refine_poses(
        scene["tmesh"], torch.from_numpy(start), torch.from_numpy(scene["intr"]),
        torch.from_numpy(targets), torch.from_numpy(scene["tex"]),
        perspective=True, cfg=trefine.PoseRefineConfig(steps=STEPS, lr=3e-3))
    assert tuple(got_loss.shape) == (STEPS,) and tuple(got_c2w.shape) == (3, 4, 4)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got_c2w.numpy(), np.asarray(want_c2w), rtol=0,
                               atol=TOL if target == "ramp" else 1e-3)
    if target == "render":
        assert got_loss[-1] < got_loss[0]
