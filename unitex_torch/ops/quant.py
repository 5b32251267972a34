"""int8 quantized serving (port of unitex_tpu/ops/quant.py): W8A8 with
dynamic per-row activations, weight-only int8, and the int4 transfer pack.

- weights: symmetric per-output-channel int8 (static, at load time);
- activations: symmetric per-row int8, quantized at every call;
- the int8 x int8 product accumulates in int32 (``torch._int_mm``, the
  library's GEMM, as the JAX package leaves it to XLA's ``dot_general``),
  then dequantizes by the outer product of the two scales.

Under tensor parallelism a row-parallel W8A8 product
(:func:`int8_row_matmul` with a ``group``) holds 1/n of each activation
row: the row's amax is reduced (MAX) over the group, so every rank
quantizes with the one-device scale, and the int32 partial products are
summed over the group before the dequantization, so the product equals
the one-device product bit for bit.

Parameter trees are nested dicts of tensors with the JAX package's leaf
names: a linear ``{"kernel", "bias"}`` becomes ``{"kernel_int8", "scale"}``
(W8A8) or ``{"kernel_int8_wo", "scale"}`` (weight-only).  The int8 kernel
keeps the logical [..., d_in, d_out] shape, but each [d_in, d_out] matrix
is stored transposed (d_in contiguous), the second-operand layout of the
int8 GEMM on the card; :func:`gemm_layout` restores it on a kernel that
lost it (a cache read).  Values, shapes and leaf paths equal the JAX
package's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the stacks the JAX package's predicates look for
_BLOCK_KEYS = ("dual_blocks", "single_blocks", "blocks", "final_block")
# q/k projections feed the per-head RMS-norm; the JAX package measured
# them slower in W8A8, so they stay bf16 (or weight-only int8)
_SKIP_KEYS = frozenset({"to_q", "to_k", "add_q_proj", "add_k_proj"})

Path = Tuple[str, ...]


def gemm_layout(q: torch.Tensor) -> torch.Tensor:
    """An int8 kernel [..., d_in, d_out] with each matrix stored d_in
    contiguous (a transposed view of [..., d_out, d_in] memory); returns
    ``q`` itself when it is already so."""
    if q.dim() >= 2 and q.stride(-2) == 1 and q.stride(-1) == q.shape[-2]:
        return q
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def _quantize_matrix(w: torch.Tensor, q_out: torch.Tensor) -> torch.Tensor:
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=-2), min=1e-8) / 127.0
    q_out.copy_(torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127))
    return scale


def quantize_kernel(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., d_in, d_out] -> (int8 kernel in :func:`gemm_layout`, f32 scale
    [..., d_out]).  Symmetric per output channel: scale = max|w| over d_in
    / 127.  A leading (stacked-layer) axis is quantized one layer at a
    time, so the f32 temporary is one layer's."""
    *lead, d_in, d_out = kernel.shape
    q = torch.empty((*lead, d_out, d_in), dtype=torch.int8,
                    device=kernel.device).transpose(-1, -2)
    if not lead:
        return q, _quantize_matrix(kernel, q)
    scale = torch.empty((*lead, d_out), dtype=torch.float32,
                        device=kernel.device)
    for i in range(lead[0]):
        scale[i] = _quantize_matrix(kernel[i], q[i])
    return q, scale


def int8_weight_only_matmul(
    x: torch.Tensor, kernel_int8: torch.Tensor, kernel_scale: torch.Tensor
) -> torch.Tensor:
    """x [..., d_in] @ the int8 kernel dequantized to x.dtype: int8
    storage, a float product."""
    w = kernel_int8.to(x.dtype) * kernel_scale.to(x.dtype)[..., None, :]
    return x @ w


def _row_scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-8) * (1.0 / 127.0)


def _quantize_with(xf: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row activation quantization: x [..., d] -> (int8 [..., d], f32
    s_x [..., 1]) with s_x = max(amax, 1e-8) · (1/127), round half to
    even."""
    xf = x.float()
    s_x = _row_scale(xf.abs().amax(dim=-1, keepdim=True))
    return _quantize_with(xf, s_x), s_x


def _int_mm(xq: torch.Tensor, kernel_int8: torch.Tensor) -> torch.Tensor:
    """int8 [..., d_in] @ int8 [d_in, d_out] -> int32 [..., d_out]."""
    lead = xq.shape[:-1]
    a = xq.reshape(-1, xq.shape[-1])
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        # the card's int8 GEMM takes more than 16 rows: zero rows give
        # zero products and are dropped
        a = torch.cat([a, a.new_zeros((17 - m, a.shape[1]))])
    acc = torch._int_mm(a, kernel_int8)[:m]
    return acc.reshape(*lead, acc.shape[-1])


def int8_matmul(
    x: torch.Tensor, kernel_int8: torch.Tensor, kernel_scale: torch.Tensor
) -> torch.Tensor:
    """x [..., d_in] @ int8 kernel [d_in, d_out] with dynamic per-row
    activation quantization: the int32 product of the int8 values (never
    summed in f32, which is exact only below 2^24), dequantized as
    ``acc · s_x · kernel_scale`` in f32, returned in x.dtype."""
    return int8_row_matmul([x], [kernel_int8], kernel_scale)


def int8_row_matmul(
    xs: Sequence[torch.Tensor], kernels: Sequence[torch.Tensor],
    kernel_scale: torch.Tensor, group=None,
) -> torch.Tensor:
    """The W8A8 product of one activation row split into parts: ``xs[i]``
    [..., d_i] holds columns of the row and ``kernels[i]`` [d_i, d_out]
    the matching rows of the int8 kernel; with ``group`` the rest of the
    row and of the kernel lies on the group's other ranks (row-parallel).
    The row scale is the amax over every part (MAX over ``group``), the
    int32 partial products are summed (over ``group`` too), then
    dequantized with ``kernel_scale`` [d_out], the whole kernel's: the
    one-device :func:`int8_matmul` of the whole row, bit for bit."""
    xfs = [x.float() for x in xs]
    amax = xfs[0].abs().amax(dim=-1, keepdim=True)
    for xf in xfs[1:]:
        amax = torch.maximum(amax, xf.abs().amax(dim=-1, keepdim=True))
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    s_x = _row_scale(amax)
    acc = None
    for xf, k in zip(xfs, kernels):
        part = _int_mm(_quantize_with(xf, s_x), k)
        acc = part if acc is None else acc + part
    if group is not None:
        dist.all_reduce(acc, group=group)
    return (acc.float() * s_x * kernel_scale).to(xs[0].dtype)


def _should_quantize(path: Path) -> bool:
    """W8A8: the projections inside the transformer blocks, except the
    q/k projections and the AdaLN modulations (under ``norm*``)."""
    if not _in_blocks(path) or any(k in _SKIP_KEYS for k in path):
        return False
    return not any(k.startswith("norm") for k in path)


def _in_blocks(path: Path) -> bool:
    return any(k in _BLOCK_KEYS for k in path)


def quantize_linears(
    params: Dict[str, Any],
    predicate: Optional[Callable[[Path], bool]] = None,
    weight_only_predicate: Optional[Callable[[Path], bool]] = None,
    consume: bool = False,
) -> Dict[str, Any]:
    """Replace ``{"kernel": w}`` nodes with ``{"kernel_int8", "scale"}``
    where ``predicate(path)`` holds (default: :func:`_should_quantize`),
    and with ``{"kernel_int8_wo", "scale"}`` where
    ``weight_only_predicate(path)`` holds and the kernel has at least two
    axes; ``path`` is the tuple of keys down to the node.  Other leaves are
    shared with ``params``.  ``consume=True`` drops each float kernel from
    ``params`` as soon as it is quantized, so a caller that holds no other
    reference never has both trees alive (the input tree is left without
    those kernels)."""
    predicate = predicate or _should_quantize

    def walk(node, path):
        if not isinstance(node, dict):
            return node
        if "kernel" in node:
            new = quantize_node(path, node, predicate, weight_only_predicate,
                                consume)
            if new is not node:
                return new
        return {k: walk(v, path + (k,)) for k, v in node.items()}

    return walk(params, ())


def quantize_node(
    path: Path, node: Dict[str, Any],
    predicate: Optional[Callable[[Path], bool]] = None,
    weight_only_predicate: Optional[Callable[[Path], bool]] = None,
    consume: bool = False,
) -> Dict[str, Any]:
    """One ``{"kernel", "bias"?}`` node at ``path`` in the int8 form that
    :func:`quantize_linears` gives it, or ``node`` itself where neither
    predicate holds."""
    predicate = predicate or _should_quantize
    kind = None
    if predicate(path):
        kind = "kernel_int8"
    elif (weight_only_predicate is not None
          and weight_only_predicate(path) and node["kernel"].dim() >= 2):
        kind = "kernel_int8_wo"
    if kind is None:
        return node
    q, s = quantize_kernel(node["kernel"])
    if consume:
        del node["kernel"]
    new = {kind: q, "scale": s}
    if "bias" in node:
        new["bias"] = node["bias"]
    return new


def pack_int4_kernel(
    kernel: torch.Tensor,
    scale_in: Optional[torch.Tensor] = None,
    group: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., d_in, d_out] kernel -> (uint8 nibble-packed [..., d_in//2,
    d_out], bf16 group scales [..., d_in//group, d_out]).

    Symmetric per-(input group, output channel) int4: scale = max|w| over
    each ``group`` input rows / 7; two values a byte in offset binary
    (q + 8, the even row in the low nibble).  ``scale_in`` dequantizes an
    int8 kernel first.  A transfer and cache format: :func:`unpack_int4_kernel`
    turns it back into the per-channel int8 serving pair."""
    w = kernel.float()
    if scale_in is not None:
        w = w * scale_in.float()[..., None, :]
    *lead, d_in, d_out = w.shape
    if d_in % group or group % 2:
        raise ValueError(f"d_in {d_in} does not split into groups of {group}")
    g = w.reshape(*lead, d_in // group, group, d_out)
    scale = torch.clamp(g.abs().amax(dim=-2), min=1e-8) / 7.0
    q = torch.clamp(torch.round(g / scale[..., None, :]), -7, 7)
    u = (q + 8.0).to(torch.uint8).reshape(*lead, d_in, d_out)
    packed = u[..., 0::2, :] | (u[..., 1::2, :] << 4)
    return packed, scale.to(torch.bfloat16)


def unpack_int4_kernel(
    packed: torch.Tensor, scale4: torch.Tensor, group: int = 64
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_int4_kernel`: (int8 kernel in
    :func:`gemm_layout`, f32 per-channel scale), on the tensors' device.
    The per-channel grid is the widest group scale times 7/127, which maps
    every int4 value to an int8 one without clipping."""
    *lead, d_half, d_out = packed.shape
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    q = torch.stack([lo, hi], dim=-2).reshape(*lead, d_half * 2, d_out)
    s4 = scale4.float()
    scale8 = s4.amax(dim=-2) * (7.0 / 127.0)
    ratio = s4 / torch.clamp(scale8[..., None, :], min=1e-20)
    ratio = torch.repeat_interleave(ratio, group, dim=-2)
    q8 = torch.clamp(torch.round(q.float() * ratio), -127, 127)
    return gemm_layout(q8.to(torch.int8)), scale8


_PACKED = (("kernel_int8", "kernel_int4"), ("kernel_int8_wo", "kernel_int4_wo"))


def pack_int4_tree(
    params: Dict[str, Any], group: int = 64, pack_bf16_wo: bool = False
) -> Dict[str, Any]:
    """Nibble-pack every int8 node ({"kernel_int8" or "kernel_int8_wo",
    "scale"}) whose d_in splits into groups; with ``pack_bf16_wo`` also
    plain 2-D/3-D float ``{"kernel": w}`` linears, as weight-only int4.
    Every other leaf, and every sibling of a packed kernel other than its
    scale, passes through."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        for src, dst in _PACKED:
            if src in node and node[src].shape[-2] % group == 0:
                p, s4 = pack_int4_kernel(node[src], node["scale"], group=group)
                new = {dst: p, "scale4": s4}
                new.update({k: walk(v) for k, v in node.items()
                            if k not in (src, "scale")})
                return new
        if (pack_bf16_wo and "kernel" in node
                and node["kernel"].dim() in (2, 3)
                and node["kernel"].shape[-2] % group == 0):
            p, s4 = pack_int4_kernel(node["kernel"], group=group)
            new = {"kernel_int4_wo": p, "scale4": s4}
            new.update({k: walk(v) for k, v in node.items() if k != "kernel"})
            return new
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


def unpack_int4_tree(
    params: Dict[str, Any], group: int = 64, consume: bool = False,
    device=None,
) -> Dict[str, Any]:
    """Inverse of :func:`pack_int4_tree`.  ``device``: move each packed
    leaf there before unpacking it; ``consume=True`` drops each packed
    leaf from ``params`` once it is unpacked, so the packed and the
    unpacked tree are never alive whole together."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        for dst, src in _PACKED:
            if src in node:
                p, s4 = node[src], node["scale4"]
                if consume:
                    del node[src], node["scale4"]
                if device is not None:
                    p, s4 = p.to(device), s4.to(device)
                q8, s8 = unpack_int4_kernel(p, s4, group=group)
                del p, s4
                new = {dst: q8, "scale": s8}
                new.update({k: walk(v) for k, v in node.items()
                            if k not in (src, "scale4")})
                return new
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


def count_quantized(params: Dict[str, Any]) -> Tuple[int, int]:
    """(int8 elements, float elements of leaves with two or more axes)."""
    n_q = n_f = 0

    def walk(node):
        nonlocal n_q, n_f
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif node.dtype == torch.int8:
            n_q += node.numel()
        elif node.dim() >= 2:
            n_f += node.numel()

    walk(params)
    return n_q, n_f
