"""Attention for the MMDiT joint sequence: kernels B1, B2a and B2b and their
plain versions.

``flash_attention`` is the hand-written Hopper flash-attention forward
(``csrc/flash_attn_fwd.cu``, kernel B1), the counterpart of the JAX
package's Pallas ``_flash_kernel``.  It takes q/k/v ``[B, S, H, D]`` bf16
on a CUDA device through their strides (no transpose copy), any S,
D = 128, and returns ``(out [B, S, H, D] bf16, lse [B·H, S] f32)``.

``flash_attention_backward`` is the matching backward
(``csrc/flash_attn_bwd.cu``): kernel B2a for dK/dV
(``flash_attention_bwd_dkv``) and B2b for dQ (``flash_attention_bwd_dq``),
the counterparts of ``_flash_bwd_dkv_kernel`` and ``_flash_bwd_dq_kernel``.
``FlashAttention`` ties the two into a ``torch.autograd.Function``, so
``attention`` on a CUDA tensor is differentiable through the kernels.

A tensor on the CPU takes :func:`attention_reference` (with torch
autograd) and :func:`attention_backward_reference`, the plain PyTorch
versions of the same functions; a CUDA tensor launches the kernels or
raises.  The int8-QK variant B3 is not ported: ``flux_forward`` refuses
``attn_qk8`` with ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

KERNEL = "flash_attn_fwd"
KERNEL_BWD = "flash_attn_bwd"

#: launches of each kernel since import; callers may reset them to 0
launches = 0            # B1
launches_bwd_dkv = 0    # B2a
launches_bwd_dq = 0     # B2b

_fns: Dict[str, object] = {}  # bound ctypes functions by name


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention: q/k/v [B, S, H, D] -> (out [B, S, H, D], lse
    [B·H, S] f32).  The logits are cast to f32 after the product and the
    probabilities back to the input dtype before P·V, as in the JAX
    package's ``attention_reference``."""
    B, S, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out, lse.reshape(B * H, S)


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
           **more: torch.Tensor) -> None:
    named = {"q": q, "k": k, "v": v, **more}
    shapes = {tuple(t.shape) for t in named.values()}
    if len(shapes) != 1 or q.dim() != 4:
        raise ValueError(
            "q/k/v" + "".join(f"/{n}" for n in more) + " must share one "
            f"[B, S, H, D] shape, got {[tuple(t.shape) for t in named.values()]}")
    if q.shape[-1] != 128:
        raise ValueError(f"flash attention takes D = 128, got {q.shape[-1]}")
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention takes bf16, {name} is {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along D")
        # cp.async copies 16-byte chunks: every row start must be aligned
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name} rows must be 16-byte aligned")


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

    q/k/v [B, S, H, D] -> (out [B, S, H, D], lse [B·H, S] f32)."""
    global launches
    if not _on_card(q):
        return attention_reference(q, k, v)
    _check(q, k, v)
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
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd_bf16 launch failed: CUDA error {rc}")
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
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd_dkv_bf16 launch failed: CUDA error {rc}")
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
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd_dq_bf16 launch failed: CUDA error {rc}")
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
        return flash_attention_backward(q, k, v, out, lse, g.contiguous())


def attention(q, k, v):
    """q/k/v [B, S, H, D] -> [B, S, H, D], differentiable: kernels B1/B2a/B2b
    on a CUDA tensor, the plain version under torch autograd on a CPU
    tensor."""
    if not _on_card(q):
        return attention_reference(q, k, v)[0]
    return FlashAttention.apply(q, k, v)
