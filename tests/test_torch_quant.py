"""int8 serving in the port against the JAX package on the same numpy
inputs: ``ops/quant.py`` (kernel quantization, W8A8 and weight-only
products, the tree transforms, the int4 pack), ``models/flux/quantize.py``,
``attach_lora`` and ``utils/param_cache.py``.  Tiny FLUX config, f32, CPU;
the float tree is made by the port's seeded init.  The forwards on the
int8 trees, and int8-QK attention, are held against JAX in
tests/test_torch_flux.py."""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from unitex_tpu.models.flux import lora as jlora
from unitex_tpu.models.flux import quantize as jfq

from unitex_torch.models.flux import lora as tlora
from unitex_torch.models.flux import model as tmodel
from unitex_torch.models.flux import quantize as tfq
from unitex_torch.models.flux.config import FluxConfig as TFluxConfig
from unitex_torch.ops import quant as tquant
from unitex_torch.utils import param_cache as tcache
from unitex_torch.utils.params import params_from_jax
from torch_cpu_share import share_cpu

share_cpu()

jquant = importlib.import_module("unitex_tpu.ops.quant")
jcache = importlib.import_module("unitex_tpu.utils.param_cache")

MATMUL_REL = 1e-5   # f32 dequant of an exact int32 product: rounding order
MODES = {"w8a8": {}, "max_memory": {"weight_only_rest": True},
         "fused": {"fuse": True}}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    """{"a/b": array} of a nested dict of tensors or arrays."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_leaves(v, path))
        else:
            out[path] = v.numpy() if torch.is_tensor(v) else np.asarray(v)
    return out


def _assert_int8_equal(got, want):
    """Equal, or at most 0.01 % of the entries one step apart (a value on a
    rounding boundary after f32 arithmetic in another order)."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-4, diff.max()


def _assert_trees_match(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for path in w:
        assert g[path].dtype == w[path].dtype, path
        assert g[path].shape == w[path].shape, path
        if w[path].dtype == np.int8:
            _assert_int8_equal(g[path], w[path])
        else:
            np.testing.assert_array_equal(g[path], w[path], err_msg=path)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def flux_tree():
    return jax.tree.map(lambda t: t.numpy(), tmodel.init_flux_params(
        torch.Generator().manual_seed(0), TFluxConfig.tiny(), device="cpu"))


@pytest.fixture(scope="module")
def jax_trees(flux_tree):
    """The JAX package's serving trees of ``flux_tree``, as numpy."""
    return {mode: _np_tree(jfq.quantize_flux_params(flux_tree, **kw))
            for mode, kw in MODES.items()}


def test_quantize_kernel_and_int8_matmul_match_jax():
    rng = np.random.default_rng(1)
    for shape in ((3, 64, 48), (96, 40)):
        w = rng.normal(size=shape).astype(np.float32)
        q, s = tquant.quantize_kernel(torch.from_numpy(w))
        jq, js = jquant.quantize_kernel(jnp.asarray(w))
        _assert_int8_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        # stored for the card's GEMM: each matrix d_in-contiguous
        assert q.stride()[-2:] == (1, shape[-2])
    x = rng.normal(size=(2, 20, 96)).astype(np.float32)
    got = tquant.int8_matmul(torch.from_numpy(x), torch.from_numpy(
        np.array(jq)), torch.from_numpy(np.array(js)))
    want = jquant.int8_matmul(jnp.asarray(x), jq, js)
    assert got.dtype == torch.float32 and got.shape == (2, 20, 40)
    assert _rel(got.numpy(), want) <= MATMUL_REL


def test_int8_matmul_sums_in_int32():
    """proj_out's d_in of 15360 takes the int32 sum to 127²·15360 ≈ 2.5e8,
    past f32's exact integers (2^24): the product must stay integer."""
    d_in = 15360
    x = torch.full((1, d_in), 1.0)
    x[0, 0] = 1.0 + 2.0 ** -6  # amax: every other entry quantizes to 125
    wq = torch.full((d_in, 8), 127, dtype=torch.int8)
    y = tquant.int8_matmul(x, wq, torch.ones(8))
    s_x = np.float32(1.0 + 2.0 ** -6) * np.float32(1.0 / 127.0)
    acc = 127 * 127 + 127 * 125 * (d_in - 1)
    assert acc > 2 ** 24
    np.testing.assert_array_equal(y.numpy(), np.full((1, 8), np.float32(acc) * s_x))


def test_weight_only_matmul_matches_jax():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(64, 24)).astype(np.float32)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    jq, js = jquant.quantize_kernel(jnp.asarray(w))
    got = tquant.int8_weight_only_matmul(
        torch.from_numpy(x), torch.from_numpy(np.array(jq)),
        torch.from_numpy(np.array(js)))
    want = jquant.int8_weight_only_matmul(jnp.asarray(x), jq, js)
    assert _rel(got.numpy(), want) <= MATMUL_REL


@pytest.mark.parametrize("mode", list(MODES))
def test_quantize_flux_params_matches_jax(flux_tree, jax_trees, mode):
    """The same leaf paths, dtypes and values as the JAX package's tree."""
    got = tfq.quantize_flux_params(params_from_jax(flux_tree, "cpu"),
                                   **MODES[mode])
    _assert_trees_match(got, jax_trees[mode])
    assert tquant.count_quantized(got) == jquant.count_quantized(jax_trees[mode])


def test_quantize_consume_drops_float_kernels(flux_tree):
    """``consume=True`` quantizes to the same tree and leaves the input
    without the kernels it quantized, so they can be freed one by one."""
    src = params_from_jax(flux_tree, "cpu")
    want = tfq.quantize_flux_params(params_from_jax(flux_tree, "cpu"))
    got = tfq.quantize_flux_params(src, consume=True)
    _assert_trees_match(got, want)
    assert "kernel" not in src["dual_blocks"]["ff"]["in"]
    assert "kernel" in src["dual_blocks"]["attn"]["to_q"]  # W8A8 skips q


@pytest.fixture(scope="module")
def adapters(flux_tree):
    """Three rank-2 adapters of unit-normal entries, numpy."""
    rng = np.random.default_rng(3)
    shapes = tlora.init_lora_params(torch.Generator().manual_seed(0),
                                    params_from_jax(flux_tree, "cpu"), rank=2,
                                    device="cpu")
    return [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                         shapes) for _ in range(3)]


def test_attach_lora_matches_jax(jax_trees, adapters):
    """Two live adapters and one of weight 0 (dropped) on the W8A8 tree,
    then a re-attach on top: the same lora_a/lora_b leaves as JAX's."""
    a, b, c = adapters
    jt = jax.tree.map(jnp.asarray, jax_trees["w8a8"])
    want = jlora.attach_lora(jt, [(a, 1.0), (b, 0.5), (c, 0.0)])
    want = _np_tree(jlora.attach_lora(want, [(c, 0.25)]))
    tt = params_from_jax(jax_trees["w8a8"], "cpu")
    got = tlora.attach_lora(tt, [(params_from_jax(a, "cpu"), 1.0),
                                 (params_from_jax(b, "cpu"), 0.5),
                                 (params_from_jax(c, "cpu"), 0.0)])
    got = tlora.attach_lora(got, [(params_from_jax(c, "cpu"), 0.25)])
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for path in w:
        np.testing.assert_allclose(g[path], w[path], rtol=1e-6, atol=0,
                                   err_msg=path)
    assert g["dual_blocks/ff/in/lora_a"].shape[-1] == 6  # ranks 2 + 2 + 2
    # untargeted leaves are shared, the base tree untouched
    assert got["x_embedder"]["kernel"] is tt["x_embedder"]["kernel"]
    assert "lora_a" not in tt["dual_blocks"]["ff"]["in"]


def test_init_lora_reads_int8_shapes(flux_tree, jax_trees):
    float_tree = params_from_jax(flux_tree, "cpu")
    for mode in ("w8a8", "max_memory"):
        lo = tlora.init_lora_params(torch.Generator().manual_seed(0),
                                    params_from_jax(jax_trees[mode], "cpu"),
                                    rank=3, device="cpu")
        ref = tlora.init_lora_params(torch.Generator().manual_seed(0),
                                     float_tree, rank=3, device="cpu")
        assert {k: v.shape for k, v in _leaves(lo).items()} == \
            {k: v.shape for k, v in _leaves(ref).items()}


def _cache_tree(jax_trees):
    """bf16, int8, f32 leaves and a list node."""
    rng = np.random.default_rng(4)
    return {
        "serving": jax_trees["w8a8"]["single_blocks"],
        "bf16": rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16),
        "stack": [np.arange(4, dtype=np.int32), {"x": np.ones(2, np.float32)}],
    }


def test_param_cache_reads_across_packages(jax_trees, tmp_path):
    """A cache written by JAX's save_params loads in the port, and one the
    port writes loads in JAX, bf16 and int8 leaves and the fingerprint
    included."""
    tree = _cache_tree(jax_trees)
    meta = {"version": 1, "source": "test"}
    jcache.save_params(str(tmp_path / "j.npz"), tree, meta=meta)
    got = tcache.load_params(str(tmp_path / "j.npz"))
    assert tcache.load_meta(str(tmp_path / "j.npz")) == meta
    assert got["bf16"].dtype == torch.bfloat16
    assert isinstance(got["stack"], list)
    np.testing.assert_array_equal(got["bf16"].float().numpy(),
                                  tree["bf16"].astype(np.float32))
    for k, v in _leaves(tree["serving"]).items():
        np.testing.assert_array_equal(_leaves(got["serving"])[k], v)
    # back through the port's writer, an int8 kernel in the GEMM layout
    got["serving"]["proj_out"]["kernel_int8"] = tquant.gemm_layout(
        got["serving"]["proj_out"]["kernel_int8"])
    tcache.save_params(str(tmp_path / "t.npz"), got, meta=meta)
    back = jcache.load_params(str(tmp_path / "t.npz"))
    assert jcache.load_meta(str(tmp_path / "t.npz")) == meta
    assert back["bf16"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back["bf16"], tree["bf16"])
    np.testing.assert_array_equal(back["stack"][0], tree["stack"][0])
    for k, v in _leaves(tree["serving"]).items():
        np.testing.assert_array_equal(_leaves(back["serving"])[k], v)


@pytest.mark.parametrize("pack_bf16_wo", [False, True])
def test_int4_pack_matches_jax(jax_trees, tmp_path, pack_bf16_wo):
    """pack_int4_tree on the single blocks of the W8A8 tree (W8A8, float
    and 1-D leaves), also with the plain float kernels packed weight-only;
    the packed tree with both kinds, written by JAX's save_params, unpacks
    in the port to JAX's unpacked values."""
    src = {"single_blocks": jax_trees["w8a8"]["single_blocks"]}
    want = _np_tree(jquant.pack_int4_tree(src, pack_bf16_wo=pack_bf16_wo))
    got = tquant.pack_int4_tree(params_from_jax(src, "cpu"),
                                pack_bf16_wo=pack_bf16_wo)
    w = _leaves(want)
    w = {k: v.view(np.uint16) if v.dtype == ml_dtypes.bfloat16 else v
         for k, v in w.items()}
    g = {k: v.view(np.uint16) if v.dtype == ml_dtypes.bfloat16 else v
         for k, v in ((k, tcache._to_numpy(v)[0]) for k, v in
                      _leaves_t(got).items())}
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if not pack_bf16_wo:
        return
    jcache.save_params(str(tmp_path / "p.npz"), want)
    unpacked = tquant.unpack_int4_tree(tcache.load_params(str(tmp_path / "p.npz")))
    _assert_trees_match(unpacked, _np_tree(jquant.unpack_int4_tree(
        jax.tree.map(jnp.asarray, want))))


def _leaves_t(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves_t(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_int4_pack_keeps_unknown_siblings():
    """Every sibling of a packed int8 kernel other than its scale passes
    through the pack and the unpack (the JAX package keeps only the
    bias)."""
    q, s = tquant.quantize_kernel(torch.randn(128, 16))
    node = {"kernel_int8": q, "scale": s, "bias": torch.zeros(16),
            "lora_a": torch.ones(128, 2)}
    packed = tquant.pack_int4_tree({"blocks": node})["blocks"]
    assert sorted(packed) == ["bias", "kernel_int4", "lora_a", "scale4"]
    back = tquant.unpack_int4_tree({"blocks": packed})["blocks"]
    assert sorted(back) == ["bias", "kernel_int8", "lora_a", "scale"]
    assert back["lora_a"] is node["lora_a"]
