"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.  A CUDA kernel has no CPU mode, so every test here is marked
``cuda`` and skips without a device.  The file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
"""

import pytest
import torch

from unitex_torch.ops import attention as attn

# bf16 output of a bf16 P·V against the f32 reference: 2 % of the largest
# reference value and never more than 2e-2.  Rounding out and P to bf16
# costs less than 2**-8 of it; a P·V fault such as a missed rescale moves
# out by tens of per cent.
OUT_TOL, OUT_REL = 2e-2, 2e-2
LSE_TOL = 1e-3   # f32 logsumexp of bf16 q·k products


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(S, H, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((1, S, H, 128), generator=gen, device=device).bfloat16()
            for _ in range(3)]


def _check_against_plain(q, k, v):
    before = attn.launches
    out, lse = attn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attn.launches == before + 1
    ref, ref_lse = attn.attention_reference(q.float(), k.float(), v.float())
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert lse.shape == (q.shape[0] * q.shape[2], q.shape[1])
    out_tol = min(OUT_TOL, OUT_REL * ref.abs().max().item())
    assert (out.float() - ref).abs().max().item() <= out_tol
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 130, 1000, 4096])
def test_flash_kernel_matches_plain(card, S):
    """Whole and ragged query/key tiles (the kernel takes 128 queries and
    64 keys a step)."""
    _check_against_plain(*_qkv(S, 4, S, card))


@pytest.mark.cuda
def test_flash_kernel_reads_strided_heads(card):
    """q/k/v as views into one fused [B, S, 3, H, D] projection: the kernel
    reads them through their strides, with no copy."""
    qkv = torch.randn((2, 300, 3, 4, 128), device=card).bfloat16()
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    _check_against_plain(q, k, v)


@pytest.mark.cuda
def test_cuda_tensor_never_falls_back(card):
    q, k, v = _qkv(64, 2, 0, card)
    with pytest.raises(TypeError):
        attn.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        attn.flash_attention(q[..., :64], k[..., :64], v[..., :64])
