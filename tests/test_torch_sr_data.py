"""The TSD-SR trainer's host side in the port against the JAX package's,
on the CPU: the paired SR data (``training/sr_data.py``: flips, aligned
crops, path pairing, ``PairedImageDataset`` over the disk and packed
backends, ``batch_iterator``), the storage backends
(``utils/file_client.py``), MATLAB's resize and the colour conversions
(``image/matlab.py``) and LPIPS (``utils/lpips.py``).

The data functions are numpy on both sides and draw from a
``numpy.random.Generator`` in the same order: the same seed gives the
same crops and flips, so they are held equal.  Resize and LPIPS are f32
on both sides (summation order).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from unitex_tpu.image import matlab as jmat
from unitex_tpu.training import sr_data as jsd
from unitex_tpu.utils import file_client as jfc
from unitex_tpu.utils import lpips as jlp

from unitex_torch.image import matlab as tmat
from unitex_torch.training import sr_data as tsd
from unitex_torch.utils import file_client as tfc
from unitex_torch.utils import lpips as tlp
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

RESIZE_ATOL = 1e-6   # f32 [0, 1] images, two contractions
LPIPS_REL = 1e-5     # f32 distances of unit-scale features
# the JAX references jitted (an eager first call compiles op by op)
_jimresize = jit_reference(jmat.imresize, static_argnums=(1, 2))


def _write_pairs(root, n=4, hr=(40, 48), scale=4, seed=0, lr=None):
    """``n`` random HR PNGs and their LR (every ``scale``-th pixel, of the
    top-left ``lr`` = (h, w) of them when given) under ``root/{hr,lr}``;
    returns the two folders."""
    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(root, k) for k in ("hr", "lr")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        img = (rng.random((*hr, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(dirs["hr"], f"{i:02d}.png"))
        h, w = lr or (hr[0] // scale, hr[1] // scale)
        Image.fromarray(img[:h * scale:scale, :w * scale:scale]).save(
            os.path.join(dirs["lr"], f"{i:02d}.png"))
    return dirs["lr"], dirs["hr"]


@pytest.mark.parametrize("seed", range(4))
def test_augment_matches_jax(seed):
    """The same flips and transpose from the same generator state, on two
    images and a flow map (its sign flips and dx/dy swap)."""
    rng = np.random.default_rng(100 + seed)
    imgs = [rng.random((6, 5, 3)).astype(np.float32) for _ in range(2)]
    flow = rng.normal(size=(6, 5, 2)).astype(np.float32)
    got = tsd.augment(imgs, np.random.default_rng(seed), flows=flow,
                      return_status=True)
    want = jsd.augment(imgs, np.random.default_rng(seed), flows=flow,
                       return_status=True)
    assert got[2] == want[2]
    for a, b in zip(got[0] + [got[1]], want[0] + [want[1]]):
        np.testing.assert_array_equal(a, b)
    one = tsd.augment(imgs[0], np.random.default_rng(seed), rotation=False)
    np.testing.assert_array_equal(
        one, jsd.augment(imgs[0], np.random.default_rng(seed), rotation=False))


def test_paired_random_crop_matches_jax():
    rng = np.random.default_rng(1)
    gt = rng.random((40, 48, 3)).astype(np.float32)
    lq = rng.random((10, 12, 3)).astype(np.float32)
    for gts, lqs in ((gt, lq), ([gt, gt * 0.5], [lq, lq * 0.5])):
        got = tsd.paired_random_crop_np(np.random.default_rng(2), gts, lqs, 16, 4)
        want = jsd.paired_random_crop_np(np.random.default_rng(2), gts, lqs, 16, 4)
        for a, b in zip(got, want):
            a, b = (x if isinstance(x, list) else [x] for x in (a, b))
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="smaller than patch"):
        tsd.paired_random_crop_np(np.random.default_rng(2), gt, lq, 64, 4)


def test_paired_paths_match_jax(tmp_path):
    """Pairing by GT name (with a file-name template), from a meta file, and
    the missing-LQ error."""
    lr, hr = _write_pairs(str(tmp_path))
    assert tsd.paired_paths_from_folders(lr, hr) == \
        jsd.paired_paths_from_folders(lr, hr)
    meta = tmp_path / "meta.txt"
    meta.write_text("02.png (40,48,3)\n00.png (40,48,3)\n\n")
    assert tsd.paired_paths_from_meta_info_file(lr, hr, str(meta), "{}") == \
        jsd.paired_paths_from_meta_info_file(lr, hr, str(meta), "{}")
    for i in range(4):
        os.rename(os.path.join(lr, f"{i:02d}.png"), os.path.join(lr, f"{i:02d}x4.png"))
    with pytest.raises(FileNotFoundError):
        tsd.paired_paths_from_folders(lr, hr)
    assert tsd.paired_paths_from_folders(lr, hr, "{}x4") == \
        jsd.paired_paths_from_folders(lr, hr, "{}x4")


def _same_samples(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


@pytest.mark.parametrize("phase", ["train", "val"])
def test_paired_dataset_matches_jax(tmp_path, phase):
    """Every sample of two passes (the dataset's generator runs on) on the
    disk backend: the same crops, flips and values; the val phase crops
    the GT to the LQ's reach."""
    lr, hr = _write_pairs(str(tmp_path), hr=(42, 50), lr=(9, 11))
    kw = dict(lq_folder=lr, gt_folder=hr, phase=phase, gt_size=16, seed=3)
    t = tsd.PairedImageDataset(tsd.PairedImageConfig(**kw))
    j = jsd.PairedImageDataset(jsd.PairedImageConfig(**kw))
    assert len(t) == len(j) == 4
    for _ in range(2):
        for i in range(len(t)):
            _same_samples(t[i], j[i])
    if phase == "val":
        assert t[0]["gt"].shape == (36, 44, 3)


def test_packed_store_matches_jax(tmp_path):
    """``make_packed_from_imgs`` writes the JAX package's format (either
    package reads the other's store byte for byte); the packed-backend
    dataset gives the disk one's samples; the backends' errors."""
    lr, hr = _write_pairs(str(tmp_path))
    names = sorted(tfc.scandir(hr))
    stores = {}
    for pkg, fc in (("t", tfc), ("j", jfc)):
        for side, src in (("lq", lr), ("gt", hr)):
            stores[pkg, side] = fc.make_packed_from_imgs(
                src, str(tmp_path / f"{pkg}_{side}.pkdb"), names)
    for side in ("lq", "gt"):
        for name in ("data.bin", "index.json", "meta_info.txt"):
            with open(os.path.join(stores["t", side], name), "rb") as f, \
                    open(os.path.join(stores["j", side], name), "rb") as g:
                assert f.read() == g.read(), (side, name)
    back = tfc.PackedBackend([stores["j", "gt"]], ["gt"])
    assert back.keys("gt") == ["00", "01", "02", "03"]
    assert back.shape("01", "gt") == (40, 48, 3)
    assert tfc.paths_from_meta_info(stores["t", "gt"]) == \
        jfc.paths_from_meta_info(stores["t", "gt"])
    kw = dict(lq_folder=stores["t", "lq"], gt_folder=stores["t", "gt"],
              gt_size=16, seed=4, backend="packed")
    packed = tsd.PairedImageDataset(tsd.PairedImageConfig(**kw))
    j_packed = jsd.PairedImageDataset(jsd.PairedImageConfig(**kw))
    disk = tsd.PairedImageDataset(tsd.PairedImageConfig(
        lq_folder=lr, gt_folder=hr, gt_size=16, seed=4))
    for i in range(len(packed)):
        a, b, c = packed[i], j_packed[i], disk[i]
        _same_samples(a, b)
        np.testing.assert_array_equal(a["gt"], c["gt"])
        np.testing.assert_array_equal(a["lq"], c["lq"])
    for bad in ("lmdb", "s3"):
        with pytest.raises(ValueError):
            tfc.FileClient(bad)
    with pytest.raises(ValueError):
        tfc.PackedBackend([stores["t", "gt"]], ["a", "b"])
    assert tfc.FileClient("disk").get_text(os.path.join(
        stores["t", "gt"], "meta_info.txt")).startswith("00.png (40,48,3) 1")


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_batch_iterator_matches_jax(tmp_path, shuffle, drop_last):
    lr, hr = _write_pairs(str(tmp_path), n=5)
    kw = dict(lq_folder=lr, gt_folder=hr, gt_size=16, seed=5)
    t = tsd.batch_iterator(tsd.PairedImageDataset(tsd.PairedImageConfig(**kw)),
                           2, np.random.default_rng(6), shuffle, drop_last)
    j = jsd.batch_iterator(jsd.PairedImageDataset(jsd.PairedImageConfig(**kw)),
                           2, np.random.default_rng(6), shuffle, drop_last)
    got, want = list(t), list(j)
    assert len(got) == len(want) == (2 if drop_last else 3)
    for a, b in zip(got, want):
        _same_samples(a, b)


def test_scandir_matches_jax(tmp_path):
    for rel in ("a.png", "b.txt", ".hidden.png", "sub/c.png", "sub/d/e.png"):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"x")
    for kw in ({}, {"suffix": ".png"}, {"recursive": True},
               {"recursive": True, "suffix": (".png",), "full_path": True}):
        assert list(tfc.scandir(str(tmp_path), **kw)) == \
            list(jfc.scandir(str(tmp_path), **kw)), kw
    with pytest.raises(TypeError):
        tfc.scandir(str(tmp_path), suffix=3)


@pytest.mark.parametrize("scale,antialias", [(4, True), (0.25, True),
                                             (0.25, False), (1 / 3, True),
                                             (2.5, True)])
def test_imresize_matches_jax(scale, antialias):
    """MATLAB bicubic on a batch of ragged images (37 x 29): x4 up (the
    trainer's LR), x1/4 down with and without antialiasing, and odd
    factors; numpy in, numpy out, and a tensor in, a tensor out."""
    x = np.random.default_rng(7).random((2, 37, 29, 3)).astype(np.float32)
    want = np.asarray(_jimresize(x, scale, antialias))
    got = tmat.imresize(x, scale, antialias)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL)
    t = tmat.imresize(torch.from_numpy(x), scale, antialias)
    assert torch.is_tensor(t)
    np.testing.assert_allclose(t.numpy(), want, atol=RESIZE_ATOL)


def test_imresize_mirrors_like_numpy_on_tiny_images():
    """Pads wider than the image (a 3 x 2 image at x1/4) mirror again,
    as ``np.pad(mode="symmetric")`` does."""
    x = np.random.default_rng(8).random((3, 2, 3)).astype(np.float32)
    for scale in (0.25, 0.5, 3):
        np.testing.assert_allclose(tmat.imresize(x, scale),
                                   np.asarray(_jimresize(x, scale, True)),
                                   atol=RESIZE_ATOL)


@pytest.mark.parametrize("mode", ["area", "bilinear", "bicubic"])
def test_interpolate_matches_jax(mode):
    x = np.random.default_rng(9).random((2, 23, 31, 3)).astype(np.float32)
    for size in ((11, 17), (40, 57)):
        np.testing.assert_allclose(
            tmat.interpolate(x, size, mode).numpy(),
            np.asarray(jmat.interpolate(x, size, mode)), atol=RESIZE_ATOL)
    with pytest.raises(ValueError):
        tmat.interpolate(x, (4, 4), "nearest")


def test_colour_conversions_match_jax():
    x = np.random.default_rng(10).random((4, 5, 3)).astype(np.float32)
    for fn, kw in (("rgb2ycbcr", {}), ("rgb2ycbcr", {"y_only": True}),
                   ("bgr2ycbcr", {}), ("bgr2ycbcr", {"y_only": True}),
                   ("ycbcr2rgb", {}), ("rgb_to_grayscale", {})):
        np.testing.assert_allclose(getattr(tmat, fn)(x, **kw).numpy(),
                                   np.asarray(getattr(jmat, fn)(x, **kw)),
                                   atol=1e-6)


def _lpips_np(params):
    return {"net": [[{k: v.numpy() for k, v in layer.items()} for layer in stage]
                    for stage in params["net"]],
            "lins": [w.numpy() for w in params["lins"]], "pnet": params["pnet"]}


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_matches_jax(net):
    """LPIPS of two batches of 64² images on the same seeded tree, each
    stage's features too, and ``lpips_image01`` on [0, 1] images."""
    p = tlp.init_lpips_params(torch.Generator().manual_seed(11), net,
                              device="cpu")
    pj = _lpips_np(p)
    rng = np.random.default_rng(12)
    a, b = (rng.random((2, 64, 64, 3)).astype(np.float32) for _ in range(2))

    @jit_reference
    def jax_side(trees, a, b):
        q = {**trees, "pnet": net}
        return (jlp.lpips_image01(q, a, b), jlp.lpips(q, a, b),
                jlp.backbone_features(q, a, net))

    want01, want, feats = jax_side({"net": pj["net"], "lins": pj["lins"]},
                                   a, b)
    got = tlp.lpips_image01(p, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, np.asarray(want01), rtol=LPIPS_REL)
    np.testing.assert_allclose(
        tlp.lpips(p, torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(want), rtol=LPIPS_REL)
    for f, g in zip(tlp.backbone_features(p, torch.from_numpy(a), net), feats):
        g = np.asarray(g)
        assert np.abs(f.numpy() - g).max() <= LPIPS_REL * np.abs(g).max()


def test_load_torch_lpips_matches_jax(tmp_path):
    """A torchvision-layout AlexNet ``features`` state dict and LPIPS
    linear heads written with ``torch.save``: both packages' loaders build
    the same tree."""
    rng = np.random.default_rng(13)
    sd, idx = {}, 0
    for si, stage in enumerate(tlp._ALEX_CFG):
        if tlp._ALEX_POOL[si]:
            idx += 1
        for cin, cout, k, _, _ in stage:
            sd[f"features.{idx}.weight"] = torch.from_numpy(
                rng.normal(size=(cout, cin, k, k)).astype(np.float32))
            sd[f"features.{idx}.bias"] = torch.from_numpy(
                rng.normal(size=(cout,)).astype(np.float32))
            idx += 2
    lins = {f"lin{i}.model.1.weight": torch.from_numpy(
        rng.random((1, c, 1, 1)).astype(np.float32))
        for i, c in enumerate(tlp.ALEX_STAGES)}
    torch.save(sd, tmp_path / "alex.pth")
    torch.save(lins, tmp_path / "lins.pth")
    got = tlp.load_torch_lpips(str(tmp_path / "alex.pth"),
                               str(tmp_path / "lins.pth"), "alex", device="cpu")
    want = jlp.load_torch_lpips(str(tmp_path / "alex.pth"),
                                str(tmp_path / "lins.pth"), "alex")
    assert got["pnet"] == want["pnet"] == "alex"
    for sg, sw in zip(got["net"], want["net"]):
        for lg, lw in zip(sg, sw):
            for k in ("kernel", "bias"):
                np.testing.assert_array_equal(lg[k].numpy(), np.asarray(lw[k]))
    for wg, ww in zip(got["lins"], want["lins"]):
        np.testing.assert_array_equal(wg.numpy(), np.asarray(ww))
