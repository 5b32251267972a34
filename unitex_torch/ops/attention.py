"""Attention for the MMDiT joint sequence: kernels B1, B2a and B2b and their
plain versions.

``flash_attention`` is the hand-written Hopper flash-attention forward
(``csrc/flash_attn_fwd.cu``, kernel B1: TMA into an mbarrier ring, wgmma,
a producer and two consumer warpgroups), the counterpart of the JAX
package's Pallas ``_flash_kernel``.  It takes q/k/v ``[B, S, H, D]`` bf16
on a CUDA device through their strides (no transpose copy; the base and
strides 16-byte aligned), any S, D = 128 (FLUX) or D = 64 (the SD3
transformer of TSD-SR: one kernel template, two instantiations), and
returns ``(out [B, S, H, D] bf16, lse [B·H, S] f32)``.

``flash_attention_backward`` is the matching backward
(``csrc/flash_attn_bwd.cu``, on the same TMA/wgmma design): kernel B2a for
dK/dV (``flash_attention_bwd_dkv``) and B2b for dQ
(``flash_attention_bwd_dq``), the counterparts of ``_flash_bwd_dkv_kernel``
and ``_flash_bwd_dq_kernel``.
``FlashAttention`` ties the two into a ``torch.autograd.Function``, so
``attention`` on a CUDA tensor is differentiable through the kernels.

``flash_attention_qk8`` is the serving variant with an int8 Q·Kᵀ
(``csrc/flash_attn_qk8.cu``, kernel B3, on B1's design with Q·Kᵀ as an
s8 wgmma), the counterpart of ``_flash_kernel_qk8``: q and k quantized per
row by :func:`quant_rows` (int8 [B, S, H, D] and f32 scales [B, S, H]),
v bf16, forward only.
``attention(q, k, v, qk8=True)`` quantizes and launches it when the JAX
package would (:func:`qk8_tiles`: S tiles into blocks of at most 1536 that
are multiples of 128), and otherwise takes the unquantized path, as
``flash_attention_qk8`` falls back to the reference there.

A tensor on the CPU takes the plain PyTorch versions of the same
functions: :func:`attention_reference` (with torch autograd),
:func:`attention_backward_reference` and :func:`attention_qk8_reference`;
a CUDA tensor launches the kernels or raises.  Unlike the JAX package,
whose ``attention`` ignores ``qk8`` off the TPU, ``qk8=True`` on a CPU
tensor runs B3's plain version: the port's CPU path always means the
plain versions of its kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from .quant import quantize_rows

KERNEL = "flash_attn_fwd"
KERNEL_BWD = "flash_attn_bwd"
KERNEL_QK8 = "flash_attn_qk8"

#: launches of each kernel since import; callers may reset them to 0
launches = 0            # B1 at D = 128
launches_d64 = 0        # B1 at D = 64
launches_bwd_dkv = 0    # B2a
launches_bwd_dq = 0     # B2b
launches_qk8 = 0        # B3

_fns: Dict[str, object] = {}  # bound ctypes functions by name
_MAP_ERROR = 100000  # return code base for a TMA tensor map (csrc/hopper.cuh)


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention: q/k/v [B, S, H, D] -> (out [B, S, H, D], lse
    [B·H, S] f32).  The logits are cast to f32 after the product and the
    probabilities back to the input dtype before P·V, as in the JAX
    package's ``attention_reference``."""
    B, S, H, _ = q.shape
    logits = _logits(q, k, scale)
    lse = torch.logsumexp(logits, dim=-1)
    return _softmax_pv(logits, v), lse.reshape(B * H, S)


def _logits(q: torch.Tensor, k: torch.Tensor,
            scale: Optional[float] = None) -> torch.Tensor:
    """f32 Q·Kᵀ·scale, [B, H, S, S]: the product in the inputs' dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale


def _softmax_pv(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(logits) in f32, rounded to v's dtype, then P·V."""
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _row_dot(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Drow = rowsum(dO ∘ O) in f32: [B, S, H, D] -> [B·H, S]."""
    B, S, H, _ = g.shape
    return torch.einsum("bshd,bshd->bhs", g.float(), out.float()).reshape(B * H, S)


def attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, g: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain flash-attention backward from the saved lse (the JAX package's
    ``_flash_core_bwd_xla`` over one key block): q/k/v/out/g [B, S, H, D],
    lse [B·H, S] -> (dq, dk, dv) in q's dtype.

        Drow = rowsum(dO ∘ O);  P = exp(Q Kᵀ·s − lse)
        dV = Pᵀ dO;  dS = P ∘ (dO Vᵀ − Drow);  dQ = dS K·s;  dK = dSᵀ Q·s

    Products take the inputs in f32 (bf16 values are exact there); P and
    dS are rounded to the input dtype before their products, as in JAX."""
    return _backward_plain(q, k, v, g, lse, _row_dot(g, out), scale)


def _backward_plain(q, k, v, g, lse, drow, scale=None):
    B, S, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dt = q.dtype
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(logits - lse.reshape(B, H, S, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = (p * (dp - drow.reshape(B, H, S, 1))).to(dt).float()
    pb = p.to(dt).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, gf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _kernel(source: str, name: str, n_ptrs: int, n_ints: int, n_strides: int):
    """The ctypes function ``name`` of ``csrc/<source>.cu``: pointers, ints,
    strides, then the scale and the stream."""
    fn = _fns.get(name)
    if fn is None:
        from ..utils.cuda_build import load

        fn = getattr(load(source), name)
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
            + [ctypes.c_longlong] * n_strides + [ctypes.c_float, ctypes.c_void_p]
        )
        _fns[name] = fn
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           head_dims: Tuple[int, ...] = (128,), **more: torch.Tensor) -> None:
    named = {"q": q, "k": k, "v": v, **more}
    shapes = {tuple(t.shape) for t in named.values()}
    if len(shapes) != 1 or q.dim() != 4:
        raise ValueError(
            "q/k/v" + "".join(f"/{n}" for n in more) + " must share one "
            f"[B, S, H, D] shape, got {[tuple(t.shape) for t in named.values()]}")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"this flash attention kernel takes D in "
                         f"{head_dims}, got {q.shape[-1]}")
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention takes bf16, {name} is {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along D")
        # TMA (B1, B2a, B2b) copies 16-byte units: the base and every
        # stride must be 16-byte aligned
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name} rows must be 16-byte aligned")


def _raise_on(rc: int, name: str) -> None:
    """Raise for a nonzero return code of a TMA kernel's entry point."""
    if rc >= _MAP_ERROR:
        raise RuntimeError(f"{name}: a TMA tensor map could not be encoded "
                           f"(CUresult {rc - _MAP_ERROR})")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _stream(device: torch.device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _on_card(q: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs); True for CUDA."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return True


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full bidirectional attention with the row logsumexp (kernel B1).

    q/k/v [B, S, H, D] with D = 128 or 64 -> (out [B, S, H, D], lse
    [B·H, S] f32)."""
    global launches, launches_d64
    if not _on_card(q):
        return attention_reference(q, k, v)
    _check(q, k, v, head_dims=(128, 64))
    B, S, H, D = q.shape
    fn = _kernel(KERNEL, "flash_attn_fwd_bf16", 5, 4, 12)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, S, H, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        1.0 / math.sqrt(D), _stream(q.device),
    )
    _raise_on(rc, "flash_attn_fwd_bf16")
    if D == 64:
        launches_d64 += 1
    else:
        launches += 1
    return out, lse


def _check_rows(q: torch.Tensor, **rows: torch.Tensor) -> None:
    B, S, H, _ = q.shape
    for name, t in rows.items():
        if (t.shape != (B * H, S) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                f"{name} must be a contiguous [B·H, S] = {(B * H, S)} f32 "
                f"tensor on {q.device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")


def flash_attention_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    lse: torch.Tensor, drow: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV of :func:`flash_attention` (kernel B2a): q/k/v and the
    output gradient g [B, S, H, D], lse and Drow = rowsum(g ∘ out) [B·H, S]
    f32 -> (dk, dv) [B, S, H, D] bf16."""
    global launches_bwd_dkv
    if not _on_card(q):
        return _backward_plain(q, k, v, g, lse, drow)[1:]
    _check(q, k, v, g=g)
    _check_rows(q, lse=lse, drow=drow)
    B, S, H, D = q.shape
    fn = _kernel(KERNEL_BWD, "flash_attn_bwd_dkv_bf16", 8, 4, 18)
    dk, dv = (torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
              for _ in range(2))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), drow.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *g.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            1.0 / math.sqrt(D), _stream(q.device))
    _raise_on(rc, "flash_attn_bwd_dkv_bf16")
    launches_bwd_dkv += 1
    return dk, dv


def flash_attention_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    lse: torch.Tensor, drow: torch.Tensor,
) -> torch.Tensor:
    """dQ of :func:`flash_attention` (kernel B2b); arguments as for
    :func:`flash_attention_bwd_dkv`.  Returns dq [B, S, H, D] bf16."""
    global launches_bwd_dq
    if not _on_card(q):
        return _backward_plain(q, k, v, g, lse, drow)[0]
    _check(q, k, v, g=g)
    _check_rows(q, lse=lse, drow=drow)
    B, S, H, D = q.shape
    fn = _kernel(KERNEL_BWD, "flash_attn_bwd_dq_bf16", 7, 4, 15)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), drow.data_ptr(), dq.data_ptr(), B, S, H, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
            *dq.stride()[:3], 1.0 / math.sqrt(D), _stream(q.device))
    _raise_on(rc, "flash_attn_bwd_dq_bf16")
    launches_bwd_dq += 1
    return dq


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, g: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`flash_attention`'s output: kernels B2a (dK, dV)
    and B2b (dQ).  q/k/v, the forward's out and lse [B·H, S] f32, and the
    output gradient g [B, S, H, D] -> (dq, dk, dv).  Drow = rowsum(g ∘ out)
    is computed in f32 by a torch op, as the JAX package computes it
    outside its kernels."""
    if not _on_card(q):
        return attention_backward_reference(q, k, v, out, lse, g)
    # the kernel wrappers check the rest; out only feeds the torch row dot
    if out.shape != q.shape or out.dtype != q.dtype or out.device != q.device:
        raise ValueError(f"out must match q's {tuple(q.shape)} {q.dtype} on "
                         f"{q.device}, got {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}")
    drow = _row_dot(g, out)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, drow)
    return flash_attention_bwd_dq(q, k, v, g, lse, drow), dk, dv


class FlashAttention(torch.autograd.Function):
    """softmax(QKᵀ/√D)·V on the card with a kernel backward: the forward
    launches B1 and saves q, k, v, out and lse; the backward launches B2a
    and B2b (the JAX package's ``_flash_core`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if q.shape[-1] != 128:
            raise NotImplementedError(
                f"the flash-attention backward (B2a/B2b) takes D = 128, got "
                f"D = {q.shape[-1]}: a backward through the SD3 transformer "
                "waits for the TSD-SR trainer, which is not ported")
        return flash_attention_backward(q, k, v, out, lse, g.contiguous())


def quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization over D, as the JAX package's
    ``_quant_rows`` (``ops/quant.quantize_rows``, the W8A8 activations'):
    x [B, S, H, D] -> (int8 [B, S, H, D], f32 scales [B, S, H])."""
    xq, s = quantize_rows(x)
    return xq, s[..., 0]


def attention_qk8_reference(
    qq: torch.Tensor, kq: torch.Tensor, v: torch.Tensor, sq: torch.Tensor,
    sk: torch.Tensor, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain int8-QK attention: qq/kq int8 and v [B, S, H, D], sq/sk f32
    [B, S, H] -> out [B, S, H, D] in v's dtype.  The logits are
    float(qq·kqᵀ) · (sq · scale) · sk in that order, the JAX kernel's; the
    integer product is exact in f32 (|Σ| ≤ 127²·D < 2^24 for D ≤ 1024)."""
    if scale is None:
        scale = 1.0 / math.sqrt(qq.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", qq.float(), kq.float())
    logits = (logits * (sq.permute(0, 2, 1)[..., None] * scale)
              * sk.permute(0, 2, 1)[:, :, None, :])
    return _softmax_pv(logits, v)


def _check_qk8(qq, kq, v, sq, sk) -> None:
    if qq.dim() != 4 or {tuple(t.shape) for t in (qq, kq, v)} != {qq.shape}:
        raise ValueError("qq/kq/v must share one [B, S, H, D] shape, got "
                         f"{[tuple(t.shape) for t in (qq, kq, v)]}")
    B, S, H, D = qq.shape
    if D != 128:
        raise ValueError(f"flash attention takes D = 128, got {D}")
    for name, t, dtype in (("qq", qq, torch.int8), ("kq", kq, torch.int8),
                           ("v", v, torch.bfloat16), ("sq", sq, torch.float32),
                           ("sk", sk, torch.float32)):
        if t.device != qq.device:
            raise ValueError(f"{name} is on {t.device}, qq on {qq.device}")
        if t.dtype != dtype:
            raise TypeError(f"int8-QK flash attention takes {dtype} {name}, "
                            f"got {t.dtype}")
    for name, t in (("sq", sq), ("sk", sk)):
        if tuple(t.shape) != (B, S, H):
            raise ValueError(f"{name} must be [B, S, H] = {(B, S, H)}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("qq", qq), ("kq", kq), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along D")
        # TMA copies 16-byte units: the base and every stride must be
        # 16-byte aligned
        if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                    for s in t.stride()[:3]):
            raise ValueError(f"{name} rows must be 16-byte aligned")


def flash_attention_qk8(
    qq: torch.Tensor, kq: torch.Tensor, v: torch.Tensor, sq: torch.Tensor,
    sk: torch.Tensor,
) -> torch.Tensor:
    """Full bidirectional attention with an int8 Q·Kᵀ (kernel B3): qq/kq
    int8 [B, S, H, D] with their f32 row scales sq/sk [B, S, H] (from
    :func:`quant_rows`), v bf16 [B, S, H, D] -> out [B, S, H, D] bf16."""
    global launches_qk8
    if not _on_card(qq):
        return attention_qk8_reference(qq, kq, v, sq, sk)
    _check_qk8(qq, kq, v, sq, sk)
    B, S, H, D = qq.shape
    fn = _kernel(KERNEL_QK8, "flash_attn_qk8_fwd", 6, 4, 18)
    out = torch.empty((B, S, H, D), dtype=v.dtype, device=v.device)
    rc = fn(qq.data_ptr(), kq.data_ptr(), v.data_ptr(), sq.data_ptr(),
            sk.data_ptr(), out.data_ptr(), B, S, H, D,
            *qq.stride()[:3], *kq.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], *sq.stride(), *sk.stride(),
            1.0 / math.sqrt(D), _stream(qq.device))
    _raise_on(rc, "flash_attn_qk8_fwd")
    launches_qk8 += 1
    return out


def _largest_divisor_leq(S: int, cap: int) -> int:
    for d in range(min(cap, S) // 128 * 128, 127, -128):
        if S % d == 0:
            return d
    return math.gcd(cap, S)


def qk8_tiles(S: int, block: int = 1536) -> bool:
    """Whether the JAX package's ``flash_attention_qk8`` quantizes at
    sequence length S: its ``_pick_blocks(S, 1536, 1536)`` finds a block
    that divides S and is a multiple of 128 (S = 13824 and 12800 do; at
    other S it returns the unquantized reference)."""
    b = block if S % block == 0 else _largest_divisor_leq(S, block)
    return not (S % b or b % 128)


def attention(q, k, v, qk8: bool = False):
    """q/k/v [B, S, H, D] -> [B, S, H, D].

    ``qk8=False``: differentiable, kernels B1/B2a/B2b on a CUDA tensor, the
    plain version under torch autograd on a CPU tensor.  ``qk8=True``
    (serving, forward only): q and k quantized by :func:`quant_rows` and
    kernel B3 (its plain version on a CPU tensor) where :func:`qk8_tiles`
    holds, the ``qk8=False`` path elsewhere."""
    if qk8 and qk8_tiles(q.shape[1]):
        qq, sq = quant_rows(q)
        kq, sk = quant_rows(k)
        return flash_attention_qk8(qq, kq, v, sq, sk)
    if not _on_card(q):
        return _softmax_pv(_logits(q, k), v)  # the plain version, no lse
    return FlashAttention.apply(q, k, v)
