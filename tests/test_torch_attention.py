"""Attention in the port (unitex_torch/ops/attention.py) against the JAX
package's: the plain ``attention_reference`` (out and lse) against JAX
``attention_reference`` and against the Pallas ``_flash_forward`` run in
interpret mode, at S = 512 and at a ragged S = 200, plus the wrapper's
checks.  The CUDA kernel itself runs only on the card
(tests/test_torch_kernels.py, marked ``cuda``)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from unitex_tpu.ops import attention as jattn
from unitex_torch.models.flux.config import FluxConfig as TFluxConfig
from unitex_torch.models.flux.model import flux_forward
from unitex_torch.ops import attention as tattn

OUT_ATOL = 2e-5   # f32 softmax(QK^T)V of unit-normal inputs, reduction order
LSE_ATOL = 1e-5   # f32 logsumexp, reduction order


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
    B, H, D = 1, 2, 128
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


def test_bf16_reference_rounds_like_jax():
    """bf16 inputs: logits cast to f32 after the product, probabilities
    back to bf16 before P·V, as the JAX reference does (bf16 tolerance)."""
    q, k, v = _inputs(1, 128, 2, 128, 3)
    tq = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    jq = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    out, _ = tattn.attention_reference(*tq)
    ref = jattn.attention_reference(*jq)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=2e-2)


def test_cpu_tensor_takes_plain_version():
    q, k, v = map(torch.from_numpy, _inputs(1, 96, 3, 64, 5))
    before = tattn.launches
    out, lse = tattn.flash_attention(q, k, v)
    ref, ref_lse = tattn.attention_reference(q, k, v)
    assert tattn.launches == before
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    torch.testing.assert_close(tattn.attention(q, k, v), ref, rtol=0, atol=0)


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


def test_qk8_is_not_ported():
    """The int8-QK kernel B3 is not ported: the one refusal is in
    ``flux_forward``, and the attention entry points take no qk8 option."""
    cfg = dataclasses.replace(TFluxConfig.tiny(), attn_qk8=True)
    with pytest.raises(NotImplementedError, match="int8-QK"):
        flux_forward({}, cfg, *[None] * 6)
    x = torch.zeros((1, 8, 1, 128))
    with pytest.raises(TypeError):
        tattn.attention(x, x, x, qk8=True)

