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
# B2a/B2b against the f32 plain backward on the same bf16 inputs: each of
# dq, dk, dv within 2 % of its largest reference value.  Rounding P and dS
# to bf16 costs about 2**-9 of an element; a dropped scale (x11.3) or a
# missing - Drow moves the gradients far past 2 %.  GRAD_ABS is the floor
# for a gradient that is 0 in exact arithmetic (at S = 1 the softmax of one
# key has no gradient, so dq and dk are f32 rounding alone).
GRAD_REL, GRAD_ABS = 2e-2, 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(S, H, seed, device, B=1, D=128):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((B, S, H, D), generator=gen, device=device).bfloat16()
            for _ in range(3)]


def _check_against_plain(q, k, v):
    before = (attn.launches, attn.launches_d64)
    out, lse = attn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    d64 = q.shape[-1] == 64
    assert (attn.launches, attn.launches_d64) == (before[0] + (not d64),
                                                  before[1] + d64)
    ref, ref_lse = attn.attention_reference(q.float(), k.float(), v.float())
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert lse.shape == (q.shape[0] * q.shape[2], q.shape[1])
    out_tol = min(OUT_TOL, OUT_REL * ref.abs().max().item())
    assert (out.float() - ref).abs().max().item() <= out_tol
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 127, 129, 130, 255, 257, 1000, 4096])
def test_flash_kernel_matches_plain(card, S):
    """Whole and ragged query/key tiles on both sides of a tile edge (the
    kernel takes 128 queries and 128 keys a step), and odd (1, 257) and
    even (129 .. 4096) counts of key tiles through its two-stage ring."""
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
    """A CUDA tensor the kernel does not take raises: f32, or a head width
    other than B1's two instantiations (128, 64)."""
    q, k, v = _qkv(64, 2, 0, card)
    with pytest.raises(TypeError):
        attn.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        attn.flash_attention(q[..., :32], k[..., :32], v[..., :32])


@pytest.mark.cuda
def test_attention_refuses_siglip_heads(card):
    """SigLIP's heads of 72 (S = 729) on a CUDA bf16 tensor: ``attention``
    raises and launches nothing (SigLIP runs its own plain attention, as
    the JAX package hands that shape to its plain reference)."""
    q, k, v = _qkv(729, 16, 0, card, D=72)
    before = (attn.launches, attn.launches_d64, attn.launches_qk8)
    with pytest.raises(ValueError):
        attn.attention(q, k, v)
    torch.cuda.synchronize()
    assert (attn.launches, attn.launches_d64, attn.launches_qk8) == before


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 127, 129, 257, 385, 1000, 1178])
def test_flash_kernel_d64_matches_plain(card, S):
    """B1 at D = 64 (the SD3 transformer's heads): ragged tiles on both
    sides of a tile edge, and 1 to 10 key tiles through its three-stage
    ring; S = 1178 is SD3's latent tile (1024 + 154 tokens), 26 keys in
    its last tile."""
    _check_against_plain(*_qkv(S, 4, S, card, D=64))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [6, 8])
def test_flash_kernel_d64_at_the_sd3_shapes(card, B):
    """The TSD-SR grid's transformer calls: 8 latent tiles a call, 6 in the
    last, 24 heads, S = 1178."""
    _check_against_plain(*_qkv(1178, 24, B, card, B=B, D=64))


@pytest.mark.cuda
def test_flash_kernel_d64_reads_strided_heads(card):
    """q/k/v at D = 64 as views into one fused [B, S, 3, H, D] tensor."""
    qkv = torch.randn((2, 300, 3, 4, 64), device=card).bfloat16()
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    _check_against_plain(q, k, v)


def _bwd_counts():
    return (attn.launches_bwd_dkv, attn.launches_bwd_dq,
            attn.launches_bwd_dkv_d64, attn.launches_bwd_dq_d64)


def _check_backward_against_plain(q, k, v, g):
    out, lse = attn.flash_attention(q, k, v)
    before = _bwd_counts()
    grads = attn.flash_attention_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    d64 = q.shape[-1] == 64
    assert _bwd_counts() == (before[0] + (not d64), before[1] + (not d64),
                             before[2] + d64, before[3] + d64)
    refs = attn.attention_backward_reference(
        q.float(), k.float(), v.float(), out.float(), lse, g.float())
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        err = (got.float() - ref).abs().max().item()
        assert err <= max(GRAD_REL * ref.abs().max().item(), GRAD_ABS), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "S", [1, 63, 64, 65, 127, 128, 129, 130, 191, 255, 257, 1000, 4096])
def test_flash_backward_matches_plain(card, S):
    """Whole and ragged tiles on both sides of 64 and 128 rows: both kernels
    own 128 rows; B2a streams 64-query tiles through a three-stage ring and
    B2b 128-key tiles through a two-stage ring, so the tile counts here wrap
    each ring at both parities."""
    q, k, v = _qkv(S, 4, S, card)
    g = _qkv(S, 4, S + 1, card)[0]
    _check_backward_against_plain(q, k, v, g)


@pytest.mark.cuda
def test_flash_backward_two_batches(card):
    """B = 2: the tensor maps' batch coordinate and the [B·H, S] rows."""
    q, k, v = _qkv(300, 3, 11, card, B=2)
    g = _qkv(300, 3, 12, card, B=2)[0]
    _check_backward_against_plain(q, k, v, g)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "S", [1, 63, 64, 65, 127, 129, 191, 257, 385, 1000, 1178])
def test_flash_backward_d64_matches_plain(card, S):
    """B2a/B2b at D = 64 (the SD3 transformer's heads, the TSD-SR
    trainer): one TMA box a tile, whole and ragged tiles on both sides of
    64 and 128 rows, both rings wrapped at both parities; S = 1178 is the
    trainer's 512² crop (1024 + 154 tokens), 26 rows in its last tile."""
    q, k, v = _qkv(S, 4, S, card, D=64)
    g = _qkv(S, 4, S + 1, card, D=64)[0]
    _check_backward_against_plain(q, k, v, g)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
def test_flash_backward_d64_at_the_trainer_shape(card, B):
    """The TSD-SR trainer's backward, [1, 1178, 24, 64], and a batch of 8."""
    q, k, v = _qkv(1178, 24, 20 + B, card, B=B, D=64)
    g = _qkv(1178, 24, 30 + B, card, B=B, D=64)[0]
    _check_backward_against_plain(q, k, v, g)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [6, 12])
def test_flash_backward_at_the_tp_training_shapes(card, H):
    """B2a/B2b at the local heads of tensor-parallel FLUX training,
    [1, 13824, 24 / model, 128] at model = 4 and 2, each head against its
    plain backward (one head's f32 S x S temporaries at a time)."""
    S = 13824
    q, k, v = _qkv(S, H, 40 + H, card)
    g = _qkv(S, H, 50 + H, card)[0]
    out, lse = attn.flash_attention(q, k, v)
    grads = attn.flash_attention_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    for h in range(H):
        sl = slice(h, h + 1)
        refs = attn.attention_backward_reference(
            q[:, :, sl].float(), k[:, :, sl].float(), v[:, :, sl].float(),
            out[:, :, sl].float(), lse[h:h + 1], g[:, :, sl].float())
        for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            err = (got[:, :, sl].float() - ref).abs().max().item()
            assert err <= max(GRAD_REL * ref.abs().max().item(), GRAD_ABS), \
                (h, name, err)


@pytest.mark.cuda
def test_flash_backward_d64_reads_strided_heads(card):
    """q/k/v and dO at D = 64 as views into fused [B, S, n, H, D] tensors."""
    qkv = torch.randn((2, 300, 3, 4, 64), device=card).bfloat16()
    q, k, v = qkv.unbind(2)
    g = torch.randn((2, 300, 2, 4, 64), device=card).bfloat16()[:, :, 1]
    assert not q.is_contiguous() and not g.is_contiguous()
    _check_backward_against_plain(q, k, v, g)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 64])
def test_flash_backward_is_bit_identical_across_calls(card, D):
    """Each block owns its rows of dq, dk and dv and sums in a fixed order
    (no atomics), so two calls on the same inputs agree bit for bit."""
    q, k, v = _qkv(1000, 4, 13, card, D=D)
    g = _qkv(1000, 4, 14, card, D=D)[0]
    out, lse = attn.flash_attention(q, k, v)
    first = attn.flash_attention_backward(q, k, v, out, lse, g)
    second = attn.flash_attention_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_flash_backward_reads_strided_heads(card):
    """q/k/v and dO as views into fused [B, S, n, H, D] tensors."""
    qkv = torch.randn((2, 300, 3, 4, 128), device=card).bfloat16()
    q, k, v = qkv.unbind(2)
    g = torch.randn((2, 300, 2, 4, 128), device=card).bfloat16()[:, :, 1]
    assert not q.is_contiguous() and not g.is_contiguous()
    _check_backward_against_plain(q, k, v, g)


@pytest.mark.cuda
def test_flash_backward_refuses_what_it_does_not_take(card):
    q, k, v = _qkv(64, 2, 0, card)
    out, lse = attn.flash_attention(q, k, v)
    with pytest.raises(TypeError):
        attn.flash_attention_backward(q, k, v, out, lse, out.float())
    with pytest.raises(ValueError):
        x = q[..., :32]
        attn.flash_attention_backward(x, x, x, x, lse, x)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 64])
def test_flash_attention_function_gradients(card, D):
    """``attention`` on the card is a ``torch.autograd.Function`` whose
    backward launches B2a/B2b (at D = 64 too, their second instantiation):
    its gradients against torch autograd through the f32 plain version."""
    q, k, v = (x.requires_grad_(True) for x in _qkv(256, 3, 7, card, D=D))
    g = _qkv(256, 3, 8, card, D=D)[0]
    before = (attn.launches + attn.launches_d64, *_bwd_counts())
    attn.attention(q, k, v).backward(g)
    torch.cuda.synchronize()
    d64 = D == 64
    assert (attn.launches + attn.launches_d64, *_bwd_counts()) == (
        before[0] + 1, before[1] + (not d64), before[2] + (not d64),
        before[3] + d64, before[4] + d64)
    qf, kf, vf = (x.detach().float().requires_grad_(True) for x in (q, k, v))
    attn.attention_reference(qf, kf, vf)[0].backward(g.float())
    for got, ref in ((q.grad, qf.grad), (k.grad, kf.grad), (v.grad, vf.grad)):
        err = (got.float() - ref).abs().max().item()
        assert err <= max(GRAD_REL * ref.abs().max().item(), GRAD_ABS)


def _check_qk8_against_plain(qq, kq, v, sq, sk):
    """B3 against its f32 plain version on the same int8 inputs: the B1
    output limit (rounding P and out to bf16)."""
    before = attn.launches_qk8
    out = attn.flash_attention_qk8(qq, kq, v, sq, sk)
    torch.cuda.synchronize()
    assert attn.launches_qk8 == before + 1
    ref = attn.attention_qk8_reference(qq, kq, v.float(), sq, sk)
    assert out.dtype == torch.bfloat16 and out.shape == v.shape
    out_tol = min(OUT_TOL, OUT_REL * ref.abs().max().item())
    assert (out.float() - ref).abs().max().item() <= out_tol


def _qk8_inputs(S, H, seed, device, B=1):
    q, k, v = _qkv(S, H, seed, device, B)
    qq, sq = attn.quant_rows(q)
    kq, sk = attn.quant_rows(k)
    return qq, kq, v, sq, sk


@pytest.mark.cuda
@pytest.mark.parametrize(
    "S", [1, 63, 64, 128, 129, 130, 256, 257, 384, 385, 1000, 4096])
def test_flash_qk8_matches_plain(card, S):
    """Whole and ragged tiles on both sides of a tile edge (the kernel takes
    128 queries and 128 keys a step), and odd (1, 3) and even (2, 4, 8, 32)
    counts of key tiles, so that its three-stage ring wraps at both
    parities."""
    _check_qk8_against_plain(*_qk8_inputs(S, 4, 100 + S, card))


@pytest.mark.cuda
def test_flash_qk8_two_batches(card):
    """B = 2: the tensor maps' batch coordinate and the scales' batch
    stride."""
    _check_qk8_against_plain(*_qk8_inputs(300, 3, 15, card, B=2))


@pytest.mark.cuda
def test_flash_qk8_takes_any_row_scale(card):
    """The kernel applies the query row's scale inside the exp2 and to the
    tile's max, so a row with a negative or zero scale (which quant_rows
    never makes) takes another branch there: held to the plain version all
    the same, at a ragged S so that masked keys meet every sign."""
    qq, kq, v, sq, sk = _qk8_inputs(300, 2, 17, card)
    sq = sq.clone()
    sq[:, ::3] *= -1.0
    sq[:, 1::7] = 0.0
    _check_qk8_against_plain(qq, kq, v, sq, sk)


@pytest.mark.cuda
def test_flash_qk8_is_bit_identical_across_calls(card):
    """Each block sums its rows in a fixed order, so two calls on the same
    inputs agree bit for bit."""
    args = _qk8_inputs(1000, 4, 16, card)
    first = attn.flash_attention_qk8(*args)
    second = attn.flash_attention_qk8(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_flash_qk8_reads_strided_views(card):
    """int8 q/k, bf16 v and the f32 scales as views into fused tensors."""
    gen = torch.Generator(device=card).manual_seed(5)
    qk = torch.randint(-127, 128, (2, 300, 2, 4, 128), generator=gen,
                       device=card, dtype=torch.int8)
    scales = torch.rand((2, 300, 2, 4), generator=gen, device=card) * 0.02
    v = torch.randn((2, 300, 3, 4, 128), generator=gen, device=card).bfloat16()
    qq, kq = qk.unbind(2)
    sq, sk = scales.unbind(2)
    assert not (qq.is_contiguous() or sq.is_contiguous())
    _check_qk8_against_plain(qq, kq, v[:, :, 2], sq, sk)


@pytest.mark.cuda
def test_flash_qk8_refuses_what_it_does_not_take(card):
    q, k, v = _qkv(64, 2, 0, card)
    qq, sq = attn.quant_rows(q)
    kq, sk = attn.quant_rows(k)
    with pytest.raises(TypeError):      # bf16 where int8 belongs
        attn.flash_attention_qk8(q, kq, v, sq, sk)
    with pytest.raises(TypeError):      # f32 v
        attn.flash_attention_qk8(qq, kq, v.float(), sq, sk)
    with pytest.raises(ValueError):     # D = 64
        attn.flash_attention_qk8(qq[..., :64], kq[..., :64], v[..., :64], sq, sk)
    with pytest.raises(ValueError):     # a CPU tensor among CUDA ones
        attn.flash_attention_qk8(qq, kq.cpu(), v, sq, sk)


@pytest.mark.cuda
def test_attention_qk8_takes_b3_where_jax_quantizes(card):
    """``attention(qk8=True)`` launches B3 at an S that tiles into blocks
    of 128 and B1 at one that does not, as the JAX package quantizes only
    where its blocks tile."""
    for S, b3 in ((256, 1), (300, 0)):
        q, k, v = _qkv(S, 2, S, card)
        before = (attn.launches, attn.launches_qk8)
        out = attn.attention(q, k, v, qk8=True)
        torch.cuda.synchronize()
        assert (attn.launches - before[0], attn.launches_qk8 - before[1]) == (
            1 - b3, b3)
        if b3:
            qq, sq = attn.quant_rows(q)
            kq, sk = attn.quant_rows(k)
            ref = attn.attention_qk8_reference(qq, kq, v.float(), sq, sk)
        else:
            ref, _ = attn.attention_reference(q.float(), k.float(), v.float())
        assert (out.float() - ref).abs().max().item() <= min(
            OUT_TOL, OUT_REL * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 300])
def test_int8_matmul_on_card_matches_cpu(card, m):
    """The W8A8 product on the card (``torch._int_mm`` on the kernel stored
    d_in-contiguous; fewer than 17 rows padded with zero rows) against the
    same function on the CPU: the integer sum is exact on both, and the
    dequant is the same f32 arithmetic, so within f32 rounding."""
    from unitex_torch.ops.quant import int8_matmul, quantize_kernel

    gen = torch.Generator().manual_seed(m)
    x = torch.randn((2, m, 256), generator=gen)
    wq, ws = quantize_kernel(torch.randn((256, 48), generator=gen))
    want = int8_matmul(x, wq, ws)
    got = int8_matmul(x.to(card), wq.to(card), ws.to(card))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
