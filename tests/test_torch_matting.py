"""Learned matting in the port (``unitex_torch/image/isnet.py``,
``unitex_torch/models/birefnet.py``, ``unitex_torch/image/rembg.py``)
against the JAX package's, f32 on the CPU.

Parameters come from one seeded state dict per model, in the checkpoints'
own naming, with random BatchNorm statistics and non-zero offset and
modulator convs (``isnet_state_dict``, ``birefnet_state_dict``); each
package's converter maps it onto its tree.  The JAX forwards run once per
module, jitted (one compile instead of one per op), in fixtures:
``IsnetConfig.tiny()`` at 100² (pools of 25, 13 and 7: every odd-edge
case) and ``BiRefNetConfig.tiny()`` at 64², whose half-scale pass pads
its 2² and 1² Swin grids to the window of 4 and shifts the 2² one, with
deformable convs of k = 1, 3 and 7 at every decoder level.  The riskiest
pieces are held one by one at small shapes, each JAX piece jitted.  The full topologies are
checked on the port only (ISNet ``rmbg14()`` at 128², BiRefNet
``rmbg20()``'s shapes against ``jax.eval_shape`` of the JAX init).
Tolerances: forwards within 2e-5 of the largest reference logit (both
run f32; measured under 1e-6), pieces within 1e-5, converters and
loaders exact, mattes within one uint8 level.
"""

import dataclasses
import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unitex_tpu.image import isnet as jis
from unitex_tpu.image import rembg as jrembg
from unitex_tpu.models import birefnet as jbr

from unitex_torch.image import isnet as tis
from unitex_torch.image import rembg as trembg
from unitex_torch.models import birefnet as tbr
from unitex_torch.utils.params import params_from_jax, tree_shapes
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

FWD_TOL = 2e-5     # of the largest reference logit
PIECE_TOL = 1e-5


def _np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _jax_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _image():
    """A synthetic 96 x 80 reference image: a disc on a gradient."""
    yy, xx = np.mgrid[:80, :96]
    img = np.stack([xx * 2, yy * 3, 255 - xx - yy], -1).astype(np.float64)
    img[(yy - 40) ** 2 + (xx - 50) ** 2 < 24 ** 2] = [200, 60, 30]
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))


@pytest.fixture(scope="module")
def isnet():
    """Tiny ISNet at 100²: the seeded state dict, both trees, the
    remover's input for ``_image()`` and the JAX side outputs on it."""
    cfg = dataclasses.replace(tis.IsnetConfig.tiny(), size=100)
    jcfg = dataclasses.replace(jis.IsnetConfig.tiny(), size=100)
    sd = tis.isnet_state_dict(torch.Generator().manual_seed(0), cfg)
    jp = jis.convert_isnet_torch(_np_sd(sd), jcfg)
    tp = tis.convert_isnet_torch(sd, cfg, "cpu")
    x = tis.normalized_input(_image(), cfg.size, cfg.mean, cfg.std)
    outs = jit_reference(lambda p, x: jis.isnet_forward(p, jcfg, x))(jp, jnp.asarray(x))
    return dict(cfg=cfg, jcfg=jcfg, sd=sd, jp=jp, tp=tp, x=x,
                ref=[np.asarray(o) for o in outs])


@pytest.fixture(scope="module")
def birefnet():
    cfg, jcfg = tbr.BiRefNetConfig.tiny(), jbr.BiRefNetConfig.tiny()
    sd = tbr.birefnet_state_dict(torch.Generator().manual_seed(1), cfg)
    jp = jbr.convert_birefnet_torch(_np_sd(sd), jcfg)
    tp = tbr.convert_birefnet_torch(sd, cfg, "cpu")
    x = tis.normalized_input(_image(), cfg.size, cfg.mean, cfg.std)
    ref = jit_reference(lambda p, x: jbr.birefnet_forward(p, jcfg, x))(
        jp, jnp.asarray(x))
    return dict(cfg=cfg, jcfg=jcfg, sd=sd, jp=jp, tp=tp, x=x,
                ref=np.asarray(ref))


def _assert_trees_equal(jtree, ttree):
    jflat = dict(jax.tree_util.tree_flatten_with_path(jtree)[0])
    tflat = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), ttree))[0])
    assert jflat.keys() == tflat.keys()
    for k, v in jflat.items():
        np.testing.assert_array_equal(np.asarray(v), tflat[k], err_msg=str(k))


# --------------------------------------------------------------- forwards


def test_isnet_forward_matches_jax(isnet):
    """All six side outputs of the tiny ISNet, on the port's tree and on
    the JAX tree carried across by ``params_from_jax``."""
    x = torch.from_numpy(isnet["x"])
    for tree in (isnet["tp"], params_from_jax(_jax_tree(isnet["jp"]), "cpu")):
        outs = tis.isnet_forward(tree, isnet["cfg"], x)
        assert len(outs) == 6
        for got, want in zip(outs, isnet["ref"]):
            assert tuple(got.shape) == want.shape == (1, 100, 100, 1)
            assert np.abs(got.numpy() - want).max() <= FWD_TOL * np.abs(want).max()


def test_birefnet_forward_matches_jax(birefnet):
    ref = birefnet["ref"]
    for tree in (birefnet["tp"],
                 params_from_jax(_jax_tree(birefnet["jp"]), "cpu")):
        got = tbr.birefnet_forward(tree, birefnet["cfg"],
                                   torch.from_numpy(birefnet["x"])).numpy()
        assert got.shape == ref.shape == (1, 64, 64, 1)
        assert np.abs(got - ref).max() <= FWD_TOL * np.abs(ref).max()


# ----------------------------------------------------------------- pieces


@pytest.mark.parametrize("hw", [(7, 9), (6, 7), (25, 25), (1, 3)])
def test_maxpool2_odd_edges_match_jax(hw):
    x = np.random.default_rng(sum(hw)).normal(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(jis._maxpool2(jnp.asarray(x)))
    got = tis._maxpool2(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("src,dst", [((13, 13), (25, 25)), ((7, 4), (13, 7)),
                                     ((1, 2), (4, 3)), ((25, 13), (50, 25))])
def test_upsample_equals_jax_half_pixel_resize(src, dst):
    """``F.interpolate(align_corners=False)`` is JAX's half-pixel bilinear
    on the upsamplings the pools make."""
    x = np.random.default_rng(0).normal(size=(1, *src, 2)).astype(np.float32)
    want = np.asarray(jit_reference(jis._upsample_to)(jnp.asarray(x),
                                                jnp.zeros((1, *dst, 1))))
    got = tis._upsample(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=PIECE_TOL, rtol=0)


@pytest.mark.parametrize("src,dst", [((7, 5), (13, 9)), ((9, 9), (4, 4)),
                                     ((1, 3), (5, 5)), ((8, 6), (1, 3))])
def test_resize_align_corners_matches_jax(src, dst):
    x = np.random.default_rng(1).normal(size=(1, *src, 3)).astype(np.float32)
    want = np.asarray(jit_reference(jbr._resize_ac, static_argnums=1)(
        jnp.asarray(x), dst))
    got = tbr._resize_ac(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=PIECE_TOL, rtol=0)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_deform_conv_matches_jax(k):
    """Offsets of about two pixels cross pixel edges and leave the image
    (corners outside count zero); the modulator is 2·sigmoid."""
    rng = np.random.default_rng(k)
    B, H, W, C, O, K = 2, 9, 11, 3, 4, k * k
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    p = {
        "offset": {"kernel": rng.normal(0, 0.3, (k, k, C, 2 * K)),
                   "bias": rng.normal(0, 2.0, 2 * K)},
        "modulator": {"kernel": rng.normal(0, 0.3, (k, k, C, K)),
                      "bias": rng.normal(0, 0.5, K)},
        "kernel": rng.normal(0, 0.3, (k, k, C, O)),
        "bias": rng.normal(0, 0.1, O),
    }
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    want = np.asarray(jit_reference(jbr._deform_conv, static_argnums=2)(
        p, jnp.asarray(x), k))
    got = tbr._deform_conv(params_from_jax(p, "cpu"),
                           torch.from_numpy(x).permute(0, 3, 1, 2), k)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=PIECE_TOL * np.abs(want).max(), rtol=0)


def _swin_block_params(rng, c, nh, w):
    def dense(i, o, bias=True):
        d = {"kernel": rng.normal(0, i ** -0.5, (i, o))}
        if bias:
            d["bias"] = rng.normal(0, 0.1, o)
        return d

    def ln(n):
        return {"scale": rng.normal(1, 0.1, n), "bias": rng.normal(0, 0.1, n)}

    p = {"norm1": ln(c), "norm2": ln(c),
         "attn": {"qkv": dense(c, 3 * c), "proj": dense(c, c),
                  "bias_table": rng.normal(0, 0.5, ((2 * w - 1) ** 2, nh))},
         "mlp": {"fc1": dense(c, 4 * c), "fc2": dense(4 * c, c)},
         "merge": {"norm": ln(4 * c), "reduction": dense(4 * c, 2 * c, False)}}
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _swin_then_merge(p, x, nh, w, shift):
    y = jbr._swin_block(p, x, nh, w, shift)
    return y, jbr._patch_merge(p["merge"], y)


@pytest.mark.parametrize("hw,shift", [((7, 10), 2), ((7, 10), 0), ((3, 2), 2)])
def test_swin_block_and_patch_merge_match_jax(hw, shift):
    """One Swin block on a grid that needs padding to the window of 4, with
    and without the shift (its -100 mask), then the patch merge of the odd
    grid (its concat order)."""
    rng = np.random.default_rng(hw[0] + shift)
    c, nh, w = 8, 2, 4
    p = _swin_block_params(rng, c, nh, w)
    x = rng.normal(size=(1, *hw, c)).astype(np.float32)
    jy, jm = jit_reference(lambda p, x: _swin_then_merge(p, x, nh, w, shift))(
        p, jnp.asarray(x))
    tp = params_from_jax(p, "cpu")
    ty = tbr._swin_block(tp, torch.from_numpy(x), nh, w, shift)
    tm = tbr._patch_merge(tp["merge"], ty)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=PIECE_TOL, rtol=0)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=PIECE_TOL,
                               rtol=0)


def test_split_patches_is_column_major():
    x = np.arange(2 * 8 * 12 * 3, dtype=np.float32).reshape(2, 8, 12, 3)
    want = np.asarray(jbr._split_patches(jnp.asarray(x), (2, 3)))
    got = tbr._split_patches(torch.from_numpy(x), (2, 3)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------ converters and loaders


def test_isnet_converters_give_equal_trees(isnet):
    _assert_trees_equal(isnet["jp"], isnet["tp"])


def test_birefnet_converters_give_equal_trees(birefnet):
    _assert_trees_equal(birefnet["jp"], birefnet["tp"])


def _save(sd, path):
    if path.endswith(".safetensors"):
        from safetensors.torch import save_file

        save_file(sd, path)
    else:
        torch.save(sd, path)


@pytest.mark.parametrize("fname", ["model.safetensors", "model.pth"])
def test_isnet_loader_round_trips(isnet, tmp_path, fname):
    path = str(tmp_path / fname)
    _save(isnet["sd"], path)
    tp, cfg = tis.load_isnet(path, isnet["cfg"], device="cpu")
    jp, _ = jis.load_isnet(path, isnet["jcfg"])
    assert cfg == isnet["cfg"]
    _assert_trees_equal(jp, tp)
    _assert_trees_equal(isnet["jp"], tp)
    with pytest.raises(ValueError, match="topology"):
        tis.load_isnet(path, device="cpu")     # the tiny checkpoint is not RMBG-1.4's
    with pytest.raises(ValueError, match="topology"):
        jis.load_isnet(path)


@pytest.mark.parametrize("fname", ["model.safetensors", "pytorch_model.bin"])
def test_birefnet_loader_round_trips(birefnet, tmp_path, fname):
    path = str(tmp_path / fname)
    _save(birefnet["sd"], path)
    tp, cfg = tbr.load_birefnet(path, birefnet["cfg"], device="cpu")
    jp, _ = jbr.load_birefnet(path, birefnet["jcfg"])
    assert cfg == birefnet["cfg"]
    _assert_trees_equal(jp, tp)
    _assert_trees_equal(birefnet["jp"], tp)


# ---------------------------------------------------------------- removers


def _matte_pair(jremover, ref_logits, tremover):
    """The JAX remover's matte with its jitted forward replaced by the
    shared JAX logits, and the port remover's own."""
    seen = {}

    def fwd(*args):
        seen["x"] = np.asarray(args[-1])
        return jnp.asarray(ref_logits)

    jremover._fwd = fwd
    image = _image()
    want = np.asarray(jremover(image)).astype(np.int32)
    got = np.asarray(tremover(image)).astype(np.int32)
    return seen["x"], want, got


def test_isnet_remover_matches_jax(isnet):
    jrem = jis.IsnetRemover(isnet["jp"], isnet["jcfg"])
    x, want, got = _matte_pair(jrem, isnet["ref"][0],
                               tis.IsnetRemover(isnet["tp"], isnet["cfg"]))
    np.testing.assert_array_equal(x, isnet["x"])   # same host preprocess
    assert got.shape == want.shape == (80, 96)
    assert np.abs(got - want).max() <= 1


def test_birefnet_remover_matches_jax(birefnet):
    jrem = jbr.BirefnetRemover(birefnet["jp"], birefnet["jcfg"])
    x, want, got = _matte_pair(jrem, birefnet["ref"],
                               tbr.BirefnetRemover(birefnet["tp"],
                                                   birefnet["cfg"]))
    np.testing.assert_allclose(x, birefnet["x"], rtol=0, atol=1e-6)
    assert got.shape == want.shape == (80, 96)
    assert np.abs(got - want).max() <= 1


# ---------------------------------------------------------- full topologies


def test_isnet_rmbg14_topology_runs_in_the_port():
    cfg = tis.IsnetConfig.rmbg14()
    tp = tis.init_isnet_params(torch.Generator().manual_seed(2), cfg)
    jshapes = tree_shapes(jax.eval_shape(
        lambda: jis.init_isnet_params(jax.random.key(0), cfg)))
    assert tree_shapes(tp) == jshapes
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 128, 128, 3)).astype(np.float32))
    with torch.no_grad():
        outs = tis.isnet_forward(tp, cfg, x)
    assert [tuple(o.shape) for o in outs] == [(1, 128, 128, 1)] * 6
    assert all(bool(torch.isfinite(o).all()) for o in outs)


def test_birefnet_rmbg20_shapes_match_jax():
    """Swin-L (embed 192, depths 2/2/18/2, heads 6/12/24/48, window 12):
    the port's init (its converter of a full-size state dict, on the meta
    device) against the JAX init's shapes."""
    cfg = tbr.BiRefNetConfig.rmbg20()
    assert cfg.channels == (3072, 1536, 768, 384)
    assert cfg.cxt == (384, 768, 1536) and cfg.ipt_out == (384, 384, 192, 96, 48)
    jshapes = tree_shapes(jax.eval_shape(
        lambda: jbr.init_birefnet_params(jax.random.key(0),
                                         jbr.BiRefNetConfig.rmbg20())))
    assert tree_shapes(tbr.init_birefnet_params(None, cfg, "meta")) == jshapes
    n = sum(np.prod(s) for s in jshapes.values())
    assert 2.0e8 < n < 2.5e8      # about 220 M parameters


# ----------------------------------------------------- the backend's choice


def _empty_layout(root, rel):
    path = root / rel
    if rel.endswith("RMBG-2.0"):
        path.mkdir(parents=True)
    else:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"")


# the layouts under which the port used to refuse (empty files:
# each load fails and falls through exactly as in the JAX package)
EMPTY_LAYOUTS = (
    "briaai/RMBG-1.4/model.safetensors",
    "briaai/RMBG-1.4/model.pth",
    "briaai/RMBG-1.4/isnet.pth",
    "briaai/RMBG-2.0/model.safetensors",
    "briaai/RMBG-2.0/pytorch_model.bin",
    "briaai/RMBG-2.0/model.pth",
    "briaai/RMBG-2.0/onnx/model.onnx",
    "briaai/RMBG-2.0",
)


def _choices(root):
    j = jrembg.build_background_remover(str(root))
    t = trembg.build_background_remover(str(root), device="cpu")
    return type(j).__name__, type(t).__name__


@pytest.mark.parametrize("rel", EMPTY_LAYOUTS)
def test_backend_choice_for_empty_files(tmp_path, caplog,
                                                       monkeypatch, rel):
    """Each learned backend's files present but empty: every load fails
    and both packages fall through to the heuristic.  The RMBG-2.0
    directory reaches the transformers backend, which both import inside
    a ``try``: here with ``transformers`` unimportable."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    _empty_layout(tmp_path, rel)
    with caplog.at_level(logging.WARNING, logger=trembg.__name__):
        jname, tname = _choices(tmp_path)
    assert tname == jname == "SaliencyRemover"
    # no quiet switch of matting model: the failed load is named
    assert str(tmp_path / rel.split("/onnx")[0]) in caplog.text


def test_backend_choice_falls_through_a_mismatched_topology(tmp_path, isnet, caplog):
    d = tmp_path / "briaai" / "RMBG-1.4"
    d.mkdir(parents=True)
    torch.save(isnet["sd"], d / "model.pth")
    with caplog.at_level(logging.WARNING, logger=trembg.__name__):
        assert _choices(tmp_path) == ("SaliencyRemover", "SaliencyRemover")
    assert "model.pth" in caplog.text and "ValueError" in caplog.text


@pytest.mark.parametrize("err", [torch.cuda.OutOfMemoryError("CUDA out of memory"),
                                 RuntimeError("CUDA error: an illegal memory access")])
def test_backend_choice_raises_a_fault_of_the_card(tmp_path, err):
    """Out of memory or a CUDA error while loading is the card's fault,
    not the checkpoint's: it is raised instead of falling through to
    another matting model."""
    (tmp_path / "model.pth").write_bytes(b"")

    def load(path, device):
        raise err

    with pytest.raises(type(err), match="CUDA"):
        trembg._learned(str(tmp_path), ("model.pth",), load, "cpu")


def test_backend_choice_loads_a_full_size_rmbg14_checkpoint(tmp_path):
    """The RMBG-1.4 topology's checkpoint: both packages convert it (the
    JAX remover's jit has not compiled) and return ISNet."""
    from safetensors.torch import save_file

    d = tmp_path / "briaai" / "RMBG-1.4"
    d.mkdir(parents=True)
    save_file(tis.isnet_state_dict(torch.Generator().manual_seed(5),
                                   tis.IsnetConfig.rmbg14()),
              str(d / "model.safetensors"))
    assert _choices(tmp_path) == ("IsnetRemover", "IsnetRemover")


def test_backend_choice_and_pipeline_take_birefnet_for_rmbg20(tmp_path, birefnet,
                                                       monkeypatch):
    """RMBG-2.0 weights (the default config patched to ``tiny()`` in both
    packages): BiRefNet in both packages, and in the port's pipeline on
    its device; RMBG-1.4 weights beside them take precedence."""
    from unitex_torch.pipeline import CustomRGBTextureFullPipeline

    monkeypatch.setattr(jbr.BiRefNetConfig, "rmbg20",
                        staticmethod(jbr.BiRefNetConfig.tiny))
    monkeypatch.setattr(tbr.BiRefNetConfig, "rmbg20",
                        staticmethod(tbr.BiRefNetConfig.tiny))
    d = tmp_path / "briaai" / "RMBG-2.0"
    d.mkdir(parents=True)
    _save(birefnet["sd"], str(d / "model.safetensors"))
    assert _choices(tmp_path) == ("BirefnetRemover", "BirefnetRemover")
    pipe = CustomRGBTextureFullPipeline(pretrain_models=str(tmp_path),
                                        device="cpu")
    assert isinstance(pipe.rembg, tbr.BirefnetRemover)
    assert pipe.rembg.device == torch.device("cpu")

    monkeypatch.setattr(jis.IsnetConfig, "rmbg14",
                        staticmethod(jis.IsnetConfig.tiny))
    monkeypatch.setattr(tis.IsnetConfig, "rmbg14",
                        staticmethod(tis.IsnetConfig.tiny))
    d = tmp_path / "briaai" / "RMBG-1.4"
    d.mkdir(parents=True)
    sd = tis.isnet_state_dict(torch.Generator().manual_seed(6),
                              tis.IsnetConfig.tiny())
    _save(sd, str(d / "model.pth"))
    assert _choices(tmp_path) == ("IsnetRemover", "IsnetRemover")
