"""Attention in the port (unitex_torch/ops/attention.py) against the JAX
package's: the plain ``attention_reference`` (out and lse) against JAX
``attention_reference`` and against the Pallas ``_flash_forward`` run in
interpret mode, at S = 512 and at a ragged S = 200 (and at D = 64, the SD3
transformer's head width, at S = 256 and 200); the plain backward
against JAX's chunked ``_flash_core_bwd_xla`` on the same residuals, at
D = 128 and 64, and at D = 64 against the Pallas backward (B2a/B2b) in
interpret mode; the
CPU autograd of ``attention`` against ``jax.vjp``; the int8-QK path
(``quant_rows`` and B3's plain version) against ``flash_attention_qk8`` in
interpret mode; plus the wrappers' checks.  The CUDA kernels themselves
run only on the card (tests/test_torch_kernels.py, marked ``cuda``)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from unitex_tpu.ops import attention as jattn
from unitex_torch.ops import attention as tattn
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

OUT_ATOL = 2e-5   # f32 softmax(QK^T)V of unit-normal inputs, reduction order
LSE_ATOL = 1e-5   # f32 logsumexp, reduction order
GRAD_ATOL = 2e-4  # f32 flash backward, as tests/test_attention.py holds it
VJP_REL = 1e-5    # f32 autograd against jax.vjp: max|Δ| / max|g|


def _inputs(B, S, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("S", [512, 200])
def test_reference_matches_jax_reference(S):
    q, k, v = _inputs(1, S, 2, 128, S)
    out, lse = tattn.attention_reference(*map(torch.from_numpy, (q, k, v)))
    ref = jattn.attention_reference(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OUT_ATOL)
    logits = np.einsum("bqhd,bkhd->bhqk", q, k).astype(np.float64) / math.sqrt(128)
    lse_ref = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    np.testing.assert_allclose(lse.numpy(), lse_ref.reshape(2, S), atol=LSE_ATOL)


@pytest.mark.parametrize("S,block", [(512, 256), (200, 200)])
def test_reference_matches_interpret_flash(S, block):
    """Against the Pallas kernel the port replaces, lse included."""
    _check_interpret_flash(S, block, 128)


@pytest.mark.parametrize("S,block", [(256, 128), (200, 200)])
def test_d64_reference_matches_interpret_flash(S, block):
    """At the SD3 transformer's head width D = 64 (B1's second
    instantiation), against the same Pallas kernel, which is generic in
    D."""
    _check_interpret_flash(S, block, 64)


def _check_interpret_flash(S, block, D):
    B, H = 1, 2
    q, k, v = _inputs(B, S, H, D, 7 + S)
    out, lse = tattn.attention_reference(*map(torch.from_numpy, (q, k, v)))

    def bhsd(x):
        return jnp.moveaxis(jnp.asarray(x), 2, 1).reshape(B * H, S, D)

    with pltpu.force_tpu_interpret_mode():
        jo, jl = jattn._flash_forward(bhsd(q), bhsd(k), bhsd(v),
                                      1.0 / math.sqrt(D), block, block)
    jo = np.moveaxis(np.asarray(jo).reshape(B, H, S, D), 1, 2)
    np.testing.assert_allclose(out.numpy(), jo, atol=OUT_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=LSE_ATOL)


@pytest.mark.parametrize("D", [128, 64])
@pytest.mark.parametrize("S,bk", [(512, 256), (384, 128)])
def test_backward_reference_matches_xla_backward(S, bk, D):
    """The plain backward against the JAX package's chunked recompute on
    the same residuals (q, k, v, out, lse) and cotangent, f32, at FLUX's
    D = 128 and the SD3 transformer's D = 64 (B2a/B2b's two
    instantiations)."""
    B, H = 1, 2
    q, k, v = _inputs(B, S, H, D, 11 + S)
    g = np.random.default_rng(S).normal(size=(B, S, H, D)).astype(np.float32)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = tattn.attention_reference(tq, tk, tv)
    got = tattn.attention_backward_reference(tq, tk, tv, out, lse, tg)

    def bhsd(x):
        return jnp.moveaxis(jnp.asarray(x), 2, 1).reshape(B * H, S, D)

    residuals = (bhsd(q), bhsd(k), bhsd(v), bhsd(out.numpy()),
                 jnp.asarray(lse.numpy()))
    want = jattn._flash_core_bwd_xla(1.0 / math.sqrt(D), bk, bk, residuals,
                                     bhsd(g))
    for x, w in zip(got, want):
        w = np.moveaxis(np.asarray(w).reshape(B, H, S, D), 1, 2)
        np.testing.assert_allclose(x.numpy(), w, atol=GRAD_ATOL)


def test_d64_backward_reference_matches_interpret_pallas_backward():
    """At D = 64 against the Pallas kernels B2a/B2b replace
    (``_flash_backward_pallas``, interpret mode, blocks of 128 at S = 256:
    two query and two key blocks), on the residuals of the plain forward,
    f32: within the XLA backward's limit."""
    B, S, H, D = 1, 256, 2, 64
    q, k, v = _inputs(B, S, H, D, 31)
    g = np.random.default_rng(32).normal(size=(B, S, H, D)).astype(np.float32)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = tattn.attention_reference(tq, tk, tv)
    got = tattn.attention_backward_reference(tq, tk, tv, out, lse, tg)

    def bhsd(x):
        return jnp.moveaxis(jnp.asarray(x), 2, 1).reshape(B * H, S, D)

    with pltpu.force_tpu_interpret_mode():
        want = jattn._flash_backward_pallas(
            bhsd(q), bhsd(k), bhsd(v), bhsd(out.numpy()),
            jnp.asarray(lse.numpy()), bhsd(g), 1.0 / math.sqrt(D), 128, 128)
    for x, w in zip(got, want):
        w = np.moveaxis(np.asarray(w).reshape(B, H, S, D), 1, 2)
        np.testing.assert_allclose(x.numpy(), w, atol=GRAD_ATOL)


@pytest.mark.parametrize("fault", ["dropped_scale", "missing_drow"])
def test_backward_limit_catches_faults(fault):
    """The card's limit for B2a/B2b (each gradient within 2 % of max|ref|,
    chip_smoke.py and tests/test_torch_kernels.py) is far from a faulty
    backward, on unit-normal bf16 inputs at a ragged S = 1000: a dropped ·s
    (x11.3 on dq and dk) or a missing − Drow (caught through dq: dk moves
    less, by ~2 % at S >= 4096)."""
    B, S, H, D = 1, 1000, 2, 128
    q, k, v, g = (torch.from_numpy(x).bfloat16().float()
                  for x in _inputs(B, S, H, D, 15) + _inputs(B, S, H, D, 16)[:1])
    out, lse = tattn.attention_reference(q, k, v)
    ref = tattn.attention_backward_reference(q, k, v, out, lse, g)
    if fault == "dropped_scale":
        bad = (ref[0] * math.sqrt(D), ref[1] * math.sqrt(D), ref[2])
    else:
        bad = tattn._backward_plain(q, k, v, g, lse, torch.zeros((B * H, S)))
    rel = [float((b - r).abs().max() / r.abs().max()) for b, r in zip(bad, ref)]
    print(f"{fault}: max|d| / max|ref| of dq, dk, dv = {rel}")
    assert max(rel) > 5 * 2e-2


def test_cpu_autograd_matches_jax_vjp():
    q, k, v = _inputs(1, 96, 2, 64, 13)
    g = np.random.default_rng(14).normal(size=q.shape).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tattn.attention(tq, tk, tv).backward(torch.from_numpy(g))
    # the JAX vjp as one jitted program (eagerly, one compile an op)
    grads = jit_reference(lambda q, k, v, g: jax.vjp(jattn.attention_reference,
                                               q, k, v)[1](g))(
        *map(jnp.asarray, (q, k, v, g)))
    for t, w in zip((tq, tk, tv), grads):
        w = np.asarray(w)
        assert np.abs(t.grad.numpy() - w).max() <= VJP_REL * np.abs(w).max()


def test_bf16_reference_rounds_like_jax():
    """bf16 inputs: logits cast to f32 after the product, probabilities
    back to bf16 before P·V, as the JAX reference does (bf16 tolerance)."""
    q, k, v = _inputs(1, 128, 2, 128, 3)
    tq = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    jq = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    out, _ = tattn.attention_reference(*tq)
    ref = jit_reference(jattn.attention_reference)(*jq)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=2e-2)


def test_cpu_tensor_takes_plain_version():
    q, k, v = map(torch.from_numpy, _inputs(1, 96, 3, 64, 5))
    before = (tattn.launches, tattn.launches_bwd_dkv, tattn.launches_bwd_dq)
    out, lse = tattn.flash_attention(q, k, v)
    ref, ref_lse = tattn.attention_reference(q, k, v)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    torch.testing.assert_close(tattn.attention(q, k, v), ref, rtol=0, atol=0)
    g = torch.ones_like(q)
    grads = tattn.flash_attention_backward(q, k, v, out, lse, g)
    refs = tattn.attention_backward_reference(q, k, v, out, lse, g)
    drow = tattn._row_dot(g, out)
    parts = (tattn.flash_attention_bwd_dq(q, k, v, g, lse, drow),
             *tattn.flash_attention_bwd_dkv(q, k, v, g, lse, drow))
    for x, y, z in zip(grads, refs, parts):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        torch.testing.assert_close(z, y, rtol=0, atol=0)
    assert (tattn.launches, tattn.launches_bwd_dkv, tattn.launches_bwd_dq) == before


def test_b1_takes_both_head_widths():
    """The kernels' check takes D = 128 and 64 where the wrapper names
    both (B1, B2a and B2b are instantiated for both) and nothing else; its
    default (B3) takes 128 only."""
    for D in (128, 64):
        x = torch.zeros((1, 64, 2, D), dtype=torch.bfloat16)
        tattn._check(x, x, x, head_dims=(128, 64))
    x = torch.zeros((1, 64, 2, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D in"):
        tattn._check(x, x, x, head_dims=(128, 64))


def test_d64_flash_function_backward_is_the_plain_one_on_the_cpu():
    """``FlashAttention`` at D = 64 on a CPU tensor: its backward (B2a/B2b's
    plain version from the saved lse) gives torch autograd's gradients
    through the reference, and launches nothing."""
    q, k, v = _inputs(1, 40, 2, 64, 3)
    g = torch.from_numpy(_inputs(1, 40, 2, 64, 4)[0])
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = (tattn.launches_bwd_dkv_d64, tattn.launches_bwd_dq_d64)
    tattn.FlashAttention.apply(tq, tk, tv).backward(g)
    rq, rk, rv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tattn.attention_reference(rq, rk, rv)[0].backward(g)
    for got, want in ((tq, rq), (tk, rk), (tv, rv)):
        torch.testing.assert_close(got.grad, want.grad, rtol=0, atol=GRAD_ATOL)
    assert (tattn.launches_bwd_dkv_d64, tattn.launches_bwd_dq_d64) == before


@pytest.mark.parametrize("case", ["d64", "f32", "shape", "stride"])
def test_kernel_argument_checks(case):
    x = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16)
    args = {
        "d64": (x[..., :64],) * 3,
        "f32": (x.float(),) * 3,
        "shape": (x, x, x[:, :32]),
        "stride": (x.transpose(1, 3).contiguous().transpose(1, 3),) * 3,
    }[case]
    with pytest.raises((ValueError, TypeError)):
        tattn._check(*args)


def test_quant_rows_matches_jax():
    """Per-row int8 quantization of q/k: the JAX package's ``_quant_rows``
    on the [B·H, S, D] layout, its scales taken from the sublane-replicated
    [B·H, 8, S] form."""
    B, S, H, D = 1, 96, 2, 128
    x = _inputs(B, S, H, D, 17)[0]
    xq, s = tattn.quant_rows(torch.from_numpy(x))
    jq, js = jattn._quant_rows(jnp.moveaxis(jnp.asarray(x), 2, 1)
                               .reshape(B * H, S, D))
    assert xq.dtype == torch.int8 and s.shape == (B, S, H)
    np.testing.assert_array_equal(
        xq.numpy(), np.moveaxis(np.asarray(jq).reshape(B, H, S, D), 1, 2))
    np.testing.assert_array_equal(
        s.numpy(), np.moveaxis(np.asarray(js)[:, 0].reshape(B, H, S), 1, 2))


def test_qk8_reference_matches_interpret_flash():
    """``attention(qk8=True)`` on the CPU (``quant_rows`` + B3's plain
    version) against the Pallas kernel it replaces, ``flash_attention_qk8``
    in interpret mode with blocks of 128 (two query and two key blocks),
    f32 inputs: within 1e-4 of max|ref| (f32 softmax, reduction order)."""
    B, S, H, D = 1, 256, 2, 128
    q, k, v = _inputs(B, S, H, D, 19)
    assert tattn.qk8_tiles(S)
    got = tattn.attention(*map(torch.from_numpy, (q, k, v)), qk8=True)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jattn.flash_attention_qk8(
            *map(jnp.asarray, (q, k, v)), block_q=128, block_k=128))
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    # and the int8 logits are not the float ones
    ref = np.asarray(jattn.attention_reference(*map(jnp.asarray, (q, k, v))))
    assert np.abs(got.numpy() - ref).max() > 1e-4 * np.abs(ref).max()


def test_qk8_untileable_takes_unquantized_path():
    """At an S whose blocks cannot tile (200), both packages return the
    unquantized attention."""
    q, k, v = _inputs(1, 200, 2, 128, 23)
    assert not tattn.qk8_tiles(200)
    got = tattn.attention(*map(torch.from_numpy, (q, k, v)), qk8=True)
    want = jattn.flash_attention_qk8(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL)
    ref, _ = tattn.attention_reference(*map(torch.from_numpy, (q, k, v)))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("S", [13824, 12800, 14336, 200, 1000])
def test_qk8_tiles_matches_jax_pick_blocks(S):
    assert tattn.qk8_tiles(S) == jattn._pick_blocks(S, 1536, 1536)[2]


def test_cpu_qk8_takes_plain_version():
    q, k, v = map(torch.from_numpy, _inputs(1, 128, 2, 64, 29))
    qq, sq = tattn.quant_rows(q)
    kq, sk = tattn.quant_rows(k)
    before = tattn.launches_qk8
    out = tattn.flash_attention_qk8(qq, kq, v, sq, sk)
    torch.testing.assert_close(
        out, tattn.attention_qk8_reference(qq, kq, v, sq, sk), rtol=0, atol=0)
    assert tattn.launches_qk8 == before


@pytest.mark.parametrize("case", ["bf16_q", "f32_v", "d64", "scales", "stride"])
def test_qk8_argument_checks(case):
    qq = torch.zeros((1, 64, 2, 128), dtype=torch.int8)
    v = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16)
    s = torch.ones((1, 64, 2))
    args = {
        "bf16_q": (v, qq, v, s, s),
        "f32_v": (qq, qq, v.float(), s, s),
        "d64": (qq[..., :64], qq[..., :64], v[..., :64], s, s),
        "scales": (qq, qq, v, s[:, :32], s),
        "stride": (qq, torch.zeros((1, 64, 2, 256), dtype=torch.int8)[..., ::2],
                   v, s, s),
    }[case]
    with pytest.raises((ValueError, TypeError)):
        tattn._check_qk8(*args)
