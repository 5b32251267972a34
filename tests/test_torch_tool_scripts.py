"""The metrics (``utils/metrics.py``) and the port's tool scripts
(``scripts/{roundtrip_oracle,compare_golden,check_meshes,merge_reports,
view_mesh}.py``) against the JAX package and its root scripts, on the CPU.

PSNR within 1e-4 dB, SSIM within 1e-6, the Fréchet distance within 1e-9
(the same float64 numpy); the round trip's JSON line has the JAX
script's keys and values, its PSNRs within 0.05 dB (both bakes at a 64²
atlas; the JSON rounds to 0.01 dB); the golden report, the mesh CSV and
the merged JSON and CSVs are the JAX scripts' files."""

import importlib
import io
import json
import os
import runpy
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from PIL import Image

from unitex_tpu.geometry.io.mesh_io import save_mesh
from unitex_tpu.geometry.primitives import make_icosphere, make_torus

from unitex_torch.scripts import check_meshes, compare_golden, merge_reports
from unitex_torch.scripts import roundtrip_oracle, view_mesh
from unitex_torch.utils import metrics as tmetrics
from torch_cpu_share import share_cpu

share_cpu()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jmetrics = importlib.import_module("unitex_tpu.utils.metrics")

PSNR_ATOL = 1e-4   # dB
SSIM_ATOL = 1e-6
ORACLE_DB = 0.05


@pytest.fixture(scope="module", autouse=True)
def _jitted_scores():
    """The JAX package's ``psnr`` and ``ssim`` (which its BasicSR scores
    and ``compare_golden`` call) run as one jitted program an image size
    instead of compiling each of their ops eagerly.  XLA's default
    optimization, not ``jit_reference``'s: this SSIM is the port's bit
    for bit, at level 0 it moves by about 1e-6."""
    import jax

    saved = jmetrics.psnr, jmetrics.ssim
    jmetrics.psnr, jmetrics.ssim = jax.jit(jmetrics.psnr), jax.jit(jmetrics.ssim)
    yield
    jmetrics.psnr, jmetrics.ssim = saved


def _run_root_script(name, argv, monkeypatch):
    """A root ``scripts/<name>.py`` (the JAX package's) in this process;
    returns its standard output."""
    path = os.path.join(REPO, "scripts", f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path, *argv])
    out = io.StringIO()
    with redirect_stdout(out):
        try:
            runpy.run_path(path, run_name="__main__")
        except SystemExit as e:
            assert not e.code
    return out.getvalue()


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.random((40, 36, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    assert abs(float(tmetrics.psnr(a, b)) - float(jmetrics.psnr(a, b))) <= PSNR_ATOL
    assert abs(float(tmetrics.ssim(torch.from_numpy(a), torch.from_numpy(b)))
               - float(jmetrics.ssim(a, b))) <= SSIM_ATOL
    A, B = a * 255, b * 255
    for kw in (dict(), dict(crop_border=4, test_y_channel=True, bgr=False),
               dict(crop_border=4, test_y_channel=True, bgr=True)):
        assert abs(tmetrics.calculate_psnr(A, B, **kw)
                   - jmetrics.calculate_psnr(A, B, **kw)) <= PSNR_ATOL
        assert abs(tmetrics.calculate_ssim(A, B, **kw)
                   - jmetrics.calculate_ssim(A, B, **kw)) <= SSIM_ATOL
    assert tmetrics.calculate_psnr(A, A) == jmetrics.calculate_psnr(A, A) == float("inf")
    f1 = rng.normal(size=(50, 6))
    f2 = rng.normal(size=(70, 6)) * 1.3 + 0.2
    for got, want in zip(tmetrics.activation_statistics(torch.from_numpy(f1)),
                         jmetrics.activation_statistics(f1)):
        np.testing.assert_array_equal(got, want)
    stats = [*jmetrics.activation_statistics(f1), *jmetrics.activation_statistics(f2)]
    assert abs(tmetrics.frechet_distance(*stats)
               - jmetrics.frechet_distance(*stats)) <= 1e-9


def test_roundtrip_oracle_matches_the_jax_script(monkeypatch, tmp_path):
    """The sphere (``--subdiv 3``) at 64² views into a 64² atlas, the
    defaults otherwise (reproject, priority paste, k = 1)."""
    argv = ["--subdiv", "3", "--view-size", "64", "--uv-size", "64"]
    want = json.loads(_run_root_script("roundtrip_oracle", argv, monkeypatch)
                      .strip().splitlines()[-1])
    out = tmp_path / "report.json"
    got = roundtrip_oracle.main(argv + ["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == got
    assert list(got) == list(want)
    for k, v in want.items():
        if "psnr" in k:
            assert abs(got[k] - v) <= ORACLE_DB, k
        else:
            assert got[k] == v, k
    assert roundtrip_oracle.parse_args([]).device == "cuda"


def _cache(d, seed, names=("mv_rgb.png", "mv_normal.png", "processed_image.png")):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, n in enumerate(names):
        img = rng.integers(0, 256, (32 + 8 * i, 48, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(d, n))
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(os.path.join(d, "mv_alpha.png"))


def test_compare_golden_matches_the_jax_report(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        jcompare = importlib.import_module("compare_golden")
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    ours, golden = str(tmp_path / "ours"), str(tmp_path / "golden")
    _cache(ours, 1)
    _cache(golden, 1)
    # one artifact changed slightly, one of another shape
    img = np.asarray(Image.open(os.path.join(golden, "mv_rgb.png"))).copy()
    img[:5] = 255 - img[:5]
    Image.fromarray(img).save(os.path.join(golden, "mv_rgb.png"))
    Image.fromarray(np.zeros((9, 9, 3), np.uint8)).save(os.path.join(golden, "mv_alpha.png"))
    assert compare_golden.COMPARED == jcompare.COMPARED
    for a, b in ((ours, golden), (ours, ours)):
        got = compare_golden.compare_caches(a, b, device="cpu")
        want = jcompare.compare_caches(a, b)
        assert got == want
    assert got["worst_psnr"] == 120.0
    assert all(r is None or r["ssim"] in (1.0, None) for r in got["artifacts"].values())
    assert compare_golden.main([ours, ours, "--device", "cpu", "--min-psnr", "50"]) == got
    with pytest.raises(SystemExit):
        compare_golden.main([ours, golden, "--device", "cpu", "--min-psnr", "50"])
    assert compare_golden.parse_args(["a", "b"]).device == "cuda"


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    save_mesh(str(d / "a.glb"), make_icosphere(2))
    save_mesh(str(d / "b.glb"), make_torus(n_major=12, n_minor=8))
    (d / "broken.glb").write_bytes(b"not a glb at all, 32 bytes long")
    return d


def test_check_meshes_writes_the_jax_csv(meshes, monkeypatch, tmp_path):
    pattern = str(meshes / "*.glb")
    _run_root_script("check_meshes", [pattern, "--out", str(tmp_path / "j.csv")],
                     monkeypatch)
    check_meshes.main([pattern, "--out", str(tmp_path / "t.csv")])
    text = (tmp_path / "t.csv").read_text()
    assert text == (tmp_path / "j.csv").read_text()
    assert text.count("\n") == 4 and ",-1," in text


def test_merge_reports_writes_the_jax_files(meshes, monkeypatch, tmp_path):
    shards = tmp_path / "shards"
    shards.mkdir()
    (shards / "0.json").write_text(json.dumps({"a": {"status": "ok", "s": 1.5},
                                               "b": {"status": "failed"}}))
    (shards / "1.json").write_text(json.dumps({"missing": "failed",
                                               "c": {"status": "ok", "extra": 2}}))
    argv = [str(shards / "*.json"), "--mesh-root", str(meshes), "--fail-key", "status"]
    _run_root_script("merge_reports", argv + ["--out", str(tmp_path / "j")], monkeypatch)
    merge_reports.main(argv + ["--out", str(tmp_path / "t")])
    for suffix in (".json", ".csv", "_success.csv", "_fail.csv"):
        got = (tmp_path / f"t{suffix}").read_text()
        assert got == (tmp_path / f"j{suffix}").read_text(), suffix
    merged = json.loads((tmp_path / "t.json").read_text())
    assert merged["a"]["faces"] == 320 and merged["c"]["faces"] == -1


def test_view_mesh_arguments():
    """``--cpu`` renders on the CPU; the default is the card."""
    args = view_mesh.parse_args(["m.glb"])
    assert (args.mesh, args.port, args.host, args.device) == (
        "m.glb", 7860, "127.0.0.1", "cuda")
    args = view_mesh.parse_args(["x.obj", "--cpu", "--port", "0", "--host", "0.0.0.0"])
    assert (args.mesh, args.port, args.host, args.device) == ("x.obj", 0, "0.0.0.0", "cpu")
