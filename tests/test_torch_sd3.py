"""The pieces of TSD-SR super-resolution in the port
(unitex_torch/models/sd3/) against the JAX package's, on the same numpy
inputs and parameter trees on the CPU: the SD3 transformer
(its parameter layout), the state-dict loader, the LoRA trees and merge, both colour fixes, the x4
bicubic of ``jax.image.resize``, the tiling helpers, the weightless
(bicubic) pipeline and the CLI with ``--super-resolution``.  The SD3
forward (at both head widths) and the SR pipeline end to end are in
tests/test_torch_sr.py, which shares the JAX package's tile-step compile
between them.

Trees are made by the port's seeded init (f32) and carried to JAX as
numpy.  Tolerance: [0, 1] images 1e-5 in f32 (reduction order).
"""

import dataclasses
import importlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unitex_tpu.models.flux import lora as jflora
from unitex_tpu.models.sd3 import color_fix as jcolor
from unitex_tpu.models.sd3 import loader as jloader
from unitex_tpu.models.sd3 import lora as jlora
from unitex_tpu.models.sd3 import model as jmodel
from unitex_tpu.models.sd3 import sr_pipeline as jsr
from unitex_tpu.models.sd3.config import SD3Config as JSD3Config

from unitex_torch import run
from unitex_torch.geometry.io.mesh_io import save_mesh
from unitex_torch.geometry.primitives import make_icosphere
from unitex_torch.models.flux.vae import VAEConfig as TVAEConfig
from unitex_torch.models.flux.vae import init_vae_params
from unitex_torch.models.sd3 import color_fix as tcolor
from unitex_torch.models.sd3 import loader as tloader
from unitex_torch.models.sd3 import lora as tlora
from unitex_torch.models.sd3 import model as tmodel
from unitex_torch.models.sd3 import sr_pipeline as tsr
from unitex_torch.models.sd3.config import SD3Config as TSD3Config
from unitex_torch.utils.params import tree_shapes
from unitex_torch.utils.resize import resize_bicubic

from test_torch_pipeline import _port_config
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_ATOL = 1e-5       # f32 [0, 1] images, reduction order
# 2 layers, 2 heads of 64: the head width of SD3-medium
D64 = dict(in_channels=4, out_channels=4, num_layers=2, attention_head_dim=64,
           num_attention_heads=2, joint_attention_dim=32,
           caption_projection_dim=128, pooled_projection_dim=32,
           pos_embed_max_size=16, dtype="float32")


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.detach().numpy()


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            out.update(_flat(v, f"{prefix}/{k}"))
    else:
        out[prefix] = np.asarray(tree)
    return out


def _configs(name):
    if name == "tiny":
        return TSD3Config.tiny(), JSD3Config.tiny()
    return TSD3Config(**D64), JSD3Config(**D64)


@pytest.fixture(scope="module")
def trees():
    """The tiny SD3 tree and the tiny VAE tree, port init, in both
    packages."""
    tcfg, jcfg = _configs("tiny")
    tp = tmodel.init_sd3_params(torch.Generator().manual_seed(0), tcfg,
                                device="cpu")
    vp = init_vae_params(torch.Generator().manual_seed(1), TVAEConfig.tiny(),
                         device="cpu")
    return tp, vp, jax.tree.map(jnp.asarray, _numpy(tp)), \
        jax.tree.map(jnp.asarray, _numpy(vp))


def test_patchify_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 8, 12, 4)).astype(np.float32)
    tok = tmodel.patchify(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jmodel.patchify(x, 2)))
    np.testing.assert_array_equal(tmodel.unpatchify(tok, 8, 12, 2).numpy(), x)


def test_seq_axis_is_refused():
    """A config's sequence and tensor axes hold process groups: a bare axis
    name is refused (``mesh.group(name)`` resolves it), and so is a mesh
    that is not ``parallel.mesh.Mesh``.  Sequence parallelism itself runs
    (tests/test_torch_sp.py)."""
    for axis in ("seq_axis", "tp_axis"):
        with pytest.raises(TypeError, match="process group"):
            dataclasses.replace(TSD3Config.tiny(), **{axis: "sp"})
    with pytest.raises(TypeError, match="Mesh"):
        tsr.TSDSRPipeline(None, mesh=object(), device="cpu")


def test_param_spec_matches_jax_init():
    """The port's tree has the JAX init's leaf paths and shapes."""
    tcfg, jcfg = _configs("tiny")
    want = jax.eval_shape(lambda k: jmodel.init_sd3_params(k, jcfg),
                          jax.random.key(0))
    got = tmodel.init_sd3_params(torch.Generator().manual_seed(0), tcfg,
                                 device="cpu")
    assert tree_shapes(got) == tree_shapes(want)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_loader_matches_jax(trees):
    """A diffusers state dict of the tiny tree (``chip_smoke.py``'s
    writer) through both packages' loaders: the same tree, equal to the
    one written."""
    tp = trees[0]
    cfg = TSD3Config.tiny()
    sd = {k: v.numpy().copy() for k, v in _chip_smoke().sd3_state_dict(tp, cfg)}
    want = _flat(jloader.sd3_params_from_state_dict(sd, JSD3Config.tiny()))
    got = _flat(tloader.sd3_params_from_state_dict(sd, cfg, device="cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], _flat(tp)[k], err_msg=k)


def test_lora_trees_match_jax(trees):
    """The adapter trees have the JAX package's paths and shapes with zero
    ``b`` leaves; merging nonzero adapters (stacked blocks, the unstacked
    final block and VAE encoder kernels) matches JAX's merge."""
    tp, vp, jp, jvp = trees
    gen = torch.Generator().manual_seed(4)
    tl = tlora.init_sd3_lora(gen, tp, rank=8, device="cpu")
    vl = tlora.init_vae_encoder_lora(gen, vp, rank=4, device="cpu")
    key = jax.random.key(0)
    for got, want in (
            (tl, jax.eval_shape(lambda k: jlora.init_sd3_lora(k, jp, 8), key)),
            (vl, jax.eval_shape(lambda k: jlora.init_vae_encoder_lora(k, jvp, 4),
                                key))):
        flat = _flat(got)
        assert tree_shapes(got) == tree_shapes(want)
        assert all(not v.any() for k, v in flat.items() if k.endswith("/b"))
        assert all(v.std() > 0 for k, v in flat.items() if k.endswith("/a"))
    rng = np.random.default_rng(5)
    for base, lora, jbase in ((tp, tl, jp), (vp, vl, jvp)):
        lora = jax.tree.map(
            lambda x: torch.from_numpy(
                rng.normal(size=x.shape).astype(np.float32) * 0.1),
            lora, is_leaf=torch.is_tensor)
        got = tlora.merge_lora(base, [(lora, 0.7)])
        want = jit_reference(lambda p, l: jflora.merge_lora(p, [(l, 0.7)]))(
            jbase, jax.tree.map(jnp.asarray, _numpy(lora)))
        got, want = _flat(got), _flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("fix", ["adain", "wavelet"])
def test_color_fix_matches_jax(fix):
    rng = np.random.default_rng(6)
    target = rng.uniform(size=(40, 52, 3)).astype(np.float32)
    source = (0.5 * target + rng.uniform(size=(40, 52, 3)) * 0.5 + 0.1) \
        .astype(np.float32)
    fn = fix + "_color_fix"
    want = np.asarray(jit_reference(getattr(jcolor, fn))(jnp.asarray(target),
                                                   jnp.asarray(source)))
    got = getattr(tcolor, fn)(torch.from_numpy(target), torch.from_numpy(source))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMG_ATOL)


@pytest.mark.parametrize("src,dst", [((20, 31), (80, 124)), ((17, 9), (34, 27)),
                                     ((40, 24), (10, 13))])
def test_bicubic_matches_jax_image_resize(src, dst):
    """``jax.image.resize(method="bicubic")``: the x4 upscale of a
    non-square image, another upscale, and an (antialiased) downscale."""
    img = np.random.default_rng(7).uniform(size=src + (3,)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), dst + (3,), "bicubic"))
    got = resize_bicubic(torch.from_numpy(img), *dst)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMG_ATOL)


def test_tiling_helpers_match_jax():
    """The blend weights (floored at 1e-6 of the maximum), the offsets with
    the last tile clamped, and both tiled appliers on a nonlinear tile
    function, against the JAX package's."""
    for tile in (8, 64, 128):
        np.testing.assert_array_equal(
            tsr.gaussian_tile_weights(tile).numpy(),
            np.asarray(jsr.gaussian_tile_weights(tile)))
    for size, tile, overlap in ((100, 32, 8), (64, 64, 8), (40, 64, 8),
                                (512, 64, 8), (768, 64, 8), (2048, 512, 128)):
        assert tsr._tile_offsets(size, tile, overlap) == \
            jsr._tile_offsets(size, tile, overlap)
    x = np.random.default_rng(8).normal(size=(1, 28, 36, 3)).astype(np.float32)

    def jfn(t):
        return jnp.sin(t) * 2.0 + t[..., :2].sum(-1, keepdims=True)

    def tfn(t):
        return torch.sin(t) * 2.0 + t[..., :2].sum(-1, keepdim=True)

    def jup(t):
        return jnp.repeat(jnp.repeat(jfn(t), 2, axis=1), 2, axis=2)

    def tup(t):
        return tfn(t).repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    xt = torch.from_numpy(x)

    def jax_side(fn):  # one jitted program instead of an eager op a tile
        return np.asarray(jit_reference(fn)(jnp.asarray(x)))

    for got, want in (
            (tsr.tiled_apply(tfn, xt, 16, 4),
             jax_side(lambda v: jsr.tiled_apply(jfn, v, 16, 4))),
            (tsr.tiled_apply(tup, xt, 16, 4, out_scale=2),
             jax_side(lambda v: jsr.tiled_apply(jup, v, 16, 4, out_scale=2))),
            (tsr.tiled_apply_batched(tfn, xt, 16, 4, tile_batch=4),
             jax_side(lambda v: jsr.tiled_apply_batched(jfn, v, 16, 4,
                                                        tile_batch=4)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=IMG_ATOL)


def test_weightless_sr_is_the_bicubic_upscale():
    img = np.random.default_rng(10).uniform(size=(12, 20, 3)).astype(np.float32)
    got = tsr.TSDSRPipeline(None, device="cpu")(img)
    want = np.asarray(jsr.TSDSRPipeline(None)(jnp.asarray(img)))
    assert got.shape == (48, 80, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMG_ATOL)


def test_auto_decode_batch_on_the_cpu():
    pipe = tsr.TSDSRPipeline(None, cfg=tsr.TSDSRConfig(vae_decode_batch=0),
                             device="cpu")
    assert pipe._auto_decode_batch() == 2


def test_views_take_the_per_view_srs_uint8_grid():
    """The bake reads ``_apply_sr``'s uint8 grid (the ``"max_memory"``
    branch) as the JAX package does: divided by 255 in f32."""
    from unitex_torch.pipeline import CustomRGBTextureFullPipeline

    pipe = CustomRGBTextureFullPipeline(config=_port_config(), device="cpu")
    grid = torch.from_numpy(np.random.default_rng(12).integers(
        0, 256, (2 * 20, 3 * 20, 3), dtype=np.uint8))
    got = pipe._views(grid)
    assert got.dtype == torch.float32 and got.shape == (6, 20, 20, 3)
    torch.testing.assert_close(got, pipe._views(grid.float() / 255.0),
                               rtol=0, atol=0)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    d = tmp_path_factory.mktemp("sr_job")
    mesh_path = str(d / "input.glb")
    save_mesh(mesh_path, make_icosphere(3))
    img = np.full((256, 256, 3), 255, np.uint8)
    img[64:192, 64:192] = [200, 60, 30]
    img_path = str(d / "image.png")
    Image.fromarray(img).save(img_path)
    return mesh_path, img_path


def test_cli_super_resolution_runs_weightless_on_the_cpu(job, tmp_path,
                                                         monkeypatch):
    """``--super-resolution`` without SD3 weights: the bicubic x4 grid is
    baked (``mv_rgb_lr.png`` at the views' size, ``mv_rgb.png`` four times
    larger) and the GLB is written."""
    mesh_path, img_path = job
    config = _port_config()
    monkeypatch.setattr(run, "DEFAULT_CONFIG", config)
    out = str(tmp_path / "out")
    run.main(["--image", img_path, "--mesh", mesh_path, "--out", out,
              "--device", "cpu", "--super-resolution", "--no-export-video"])
    cam = config.camera
    lr = (cam.rows * cam.view_size, cam.cols * cam.view_size)
    for name, size in (("mv_rgb_lr.png", lr), ("mv_rgb.png", (4 * lr[0], 4 * lr[1]))):
        with Image.open(os.path.join(out, "cache", name)) as im:
            assert im.size[::-1] == size, name
    assert os.path.exists(os.path.join(out, "textured_mesh.glb"))
