"""Attention for the MMDiT joint sequence: kernel B1 and its plain version.

``flash_attention`` is the hand-written Hopper flash-attention forward
(``csrc/flash_attn_fwd.cu``), the counterpart of the JAX package's Pallas
``_flash_kernel``.  It takes q/k/v ``[B, S, H, D]`` bf16 on a CUDA device
through their strides (no transpose copy), any S, D = 128, and returns
``(out [B, S, H, D] bf16, lse [B·H, S] f32)``.  A tensor on the CPU takes
:func:`attention_reference`, the plain PyTorch version of the same
function; a CUDA tensor launches the kernel or raises.

Only the forward is ported: the backward kernels (B2a/B2b) are not, and
``flux_forward`` refuses ``attn_qk8`` (the int8-QK variant B3) with
``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

KERNEL = "flash_attn_fwd"

#: launches of the B1 kernel since import; callers may reset it to 0
launches = 0

_fn = None


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


def _kernel():
    global _fn
    if _fn is None:
        from ..utils.cuda_build import load

        fn = load(KERNEL).flash_attn_fwd_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p]
        )
        _fn = fn
    return _fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(
            f"q/k/v must share one [B, S, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] != 128:
        raise ValueError(f"flash_attention takes D = 128, got {q.shape[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention takes bf16, {name} is {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along D")
        # cp.async copies 16-byte chunks: every row start must be aligned
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name} rows must be 16-byte aligned")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full bidirectional attention with the row logsumexp.

    q/k/v [B, S, H, D] -> (out [B, S, H, D], lse [B·H, S] f32)."""
    global launches
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v)
    B, S, H, D = q.shape
    fn = _kernel()
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, S, H, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        1.0 / math.sqrt(D), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd_bf16 launch failed: CUDA error {rc}")
    launches += 1
    return out, lse


def attention(q, k, v):
    """q/k/v [B, S, H, D] -> [B, S, H, D]: kernel B1 on a CUDA tensor, the
    plain version on a CPU tensor."""
    return flash_attention(q, k, v)[0]
