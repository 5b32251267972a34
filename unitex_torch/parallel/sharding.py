"""Megatron tensor-parallel cuts of the FLUX and SD3 trees, and the batch
split over ``data`` (port of unitex_tpu/parallel/sharding.py).

The JAX package annotates the whole tree with NamedShardings
(``flux_param_shardings``, ``sd3_param_shardings``) and lets XLA place the
collectives; here each rank keeps only its slice of every leaf, cut by the
same layout, and the model code runs the collectives itself
(``models/flux/layers.row_linear``, ``models/flux/model._ada_ln_zero``):

* column-parallel, over the output dim (kernel and bias): attention
  ``to_q/k/v``, ``add_{q,k,v}_proj``, ``ff.in`` / ``ff_context.in``,
  ``proj_mlp`` and the AdaLN ``lin`` layers.  AdaLN is about a quarter of
  FLUX: its local modulation columns are gathered (a [B, 6·d] vector);
* row-parallel, over the input dim (the bias replicated, added once after
  the ``all_reduce``): ``to_out``, ``to_add_out``, ``ff.out`` /
  ``ff_context.out``;
* the single blocks' ``proj_out``, whose input rows interleave
  ``[attn ‖ mlp]``, is pre-split into ``kernel_attn`` / ``kernel_mlp``,
  each row-cut (as the JAX package's ``prepare_flux_params_tp_pp`` does);
  its adapter keeps one node, ``a`` holding this rank's attn rows then its
  mlp rows (``models/flux/lora._walk`` splits it), ``b`` whole;
* everything outside the block stacks (embedders, ``norm_out``, the final
  ``proj_out``) and the QK norms: replicated.

Rank ``m`` of the ``model`` axis takes the ``m``-th contiguous part, so a
column cut keeps whole heads (heads ``m·H/n … (m+1)·H/n - 1``) and the row
cut of the next projection matches it.  LoRA trees (``{"a", "b"}`` nodes)
are cut by the same rule: ``b`` of a column kernel by its columns, ``a`` of
a row kernel by its rows, the other factor replicated, so a per-block
merge yields this rank's slice of the merged kernel.  :func:`unshard_tree`
gathers the slices back into the whole tree (a checkpoint any mesh, or
one card, reads).

:func:`shard_hook` is the rule for one linear node, for the loaders and
the random init, which cut each node as it is made, so a rank holds its
slices and one full node at a time.

int8 serving nodes (``ops/quant.py``) are cut as the JAX package's
``_match_linear`` places them: ``kernel_int8`` / ``kernel_int8_wo`` like
``kernel``, the per-output-channel ``scale`` with the columns of a column
kernel and whole on every rank for a row kernel (its channels are the
whole output), the pre-split ``proj_out`` into ``kernel_int8_attn`` /
``kernel_int8_mlp``.  A node is quantized whole before it is cut
(``models/flux/quantize.quantize_hook``), so a row kernel's scale is the
one-device scale, over the whole d_in.  Every cut int8 kernel keeps the
int8 GEMM's d_in-contiguous layout (``ops/quant.gemm_layout``).  The
fused serving nodes (``qkv_fused``, ``add_qkv_fused``, ``qkvm_fused``) are
refused: the JAX package has no layout for them either.

:func:`shard_t5_params` cuts the T5 encoder in ``t5_param_shardings``'
layout: q/k/v and the feed-forward's input column-parallel, ``o`` and
``wo`` row-parallel, the rest whole.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist

from ..ops.quant import gemm_layout
from .mesh import Mesh

Path = Tuple[str, ...]

_STACKS = ("dual_blocks", "single_blocks", "blocks", "final_block")
_COL = {"to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
        "proj_mlp", "lin"}
_ROW = {"to_out", "to_add_out"}
_FF = ("ff", "ff_context")
_INT8_NODES = {"qkv_fused", "add_qkv_fused", "qkvm_fused"}
_INT8_LEAVES = ("kernel_int8", "kernel_int8_wo")
_KERNELS = ("kernel",) + _INT8_LEAVES
_T5_COL = {"q", "k", "v", "wi", "wi_0", "wi_1"}
_T5_ROW = {"o", "wo"}


def layout(path: Path) -> str:
    """The cut of the linear node at ``path``: "col", "row", "split_row"
    (the single blocks' ``proj_out``) or "rep"."""
    if not path or path[0] not in _STACKS:
        return "rep"
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if name in _COL or (name == "in" and parent in _FF):
        return "col"
    if name in _ROW or (name == "out" and parent in _FF):
        return "row"
    if name == "proj_out" and path[0] == "single_blocks":
        return "split_row"
    return "rep"


def cut(t: torch.Tensor, dim: int, part: int, n: int) -> torch.Tensor:
    """Part ``part`` of ``n`` contiguous parts of ``t`` along ``dim``; a
    copy of its own (so the full tensor can be freed), or ``t`` itself
    when ``n`` is 1."""
    if n == 1:
        return t
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {n} parts")
    k = size // n
    return t.narrow(dim, part * k, k).clone(memory_format=torch.contiguous_format)


def _cut_leaf(key: str, t: torch.Tensor, dim: int, part: int,
              n: int) -> torch.Tensor:
    """:func:`cut`, with an int8 kernel left in the GEMM's layout."""
    out = cut(t, dim, part, n)
    return gemm_layout(out) if key in _INT8_LEAVES else out


def _kernel_keys(node) -> tuple:
    return tuple(k for k in _KERNELS if k in node)


def shard_node(path: Path, node: Dict[str, Any], part: int, n: int,
               kind: str = None) -> Dict[str, Any]:
    """This part of one linear node (``kernel``/``bias``, or the int8
    ``kernel_int8``/``kernel_int8_wo`` with its ``scale``) or LoRA node
    (``a``/``b``), by :func:`layout` (or ``kind``)."""
    if path[-1] in _INT8_NODES:
        raise NotImplementedError(
            f"{path[-1]}: fused int8 serving nodes are not cut across ranks; "
            "the JAX package's flux_param_shardings has no layout for them "
            "either (quantize_flux_params(fuse=False), the default, serves "
            "with more than one rank)")
    kind = kind or layout(path)
    lora = "a" in node and "b" in node
    out = dict(node)
    if kind == "col":
        for k in ("b",) if lora else _kernel_keys(node) + ("bias", "scale"):
            if k in node:
                out[k] = _cut_leaf(k, node[k], -1, part, n)
    elif kind == "row":
        # an int8 row kernel's scale is per output channel: whole
        for k in ("a",) if lora else _kernel_keys(node):
            out[k] = _cut_leaf(k, node[k], -2, part, n)
    elif kind == "split_row":
        # the input rows are [attn (d) ‖ mlp]; d is the output width
        if lora:
            a, d = node["a"], node["b"].shape[-1]
            out["a"] = torch.cat([cut(a[..., :d, :], -2, part, n),
                                  cut(a[..., d:, :], -2, part, n)], dim=-2)
            return out
        for k in _kernel_keys(node):
            kernel = out.pop(k)
            d = kernel.shape[-1]
            out[f"{k}_attn"] = _cut_leaf(k, kernel[..., :d, :], -2, part, n)
            out[f"{k}_mlp"] = _cut_leaf(k, kernel[..., d:, :], -2, part, n)
    return out


def shard_hook(mesh: Mesh) -> Callable[[Path, Dict[str, Any]], Dict[str, Any]]:
    """:func:`shard_node` for this rank of ``mesh``'s ``model`` axis."""
    part, n = mesh.index("model"), mesh.size("model")
    return lambda path, node: shard_node(path, node, part, n)


def is_linear(node) -> bool:
    return isinstance(node, dict) and (
        any(k in node or f"{k}_attn" in node for k in _KERNELS)
        or ("a" in node and "b" in node))


def shard_tree(tree: Dict[str, Any], hook, path: Path = ()) -> Dict[str, Any]:
    """``tree`` with ``hook(path, node)`` in place of every linear node."""
    if not isinstance(tree, dict):
        return tree
    out = {k: shard_tree(v, hook, path + (k,)) for k, v in tree.items()}
    return hook(path, out) if is_linear(out) else out


def shard_flux_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's slices of a FLUX parameter tree, or of a LoRA tree of
    it, in the layout of ``flux_param_shardings``."""
    return shard_tree(params, shard_hook(mesh))


def shard_sd3_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's slices of an SD3 tree, in the layout of
    ``sd3_param_shardings`` (the same rule: the SD3 blocks use FLUX's leaf
    names)."""
    return shard_tree(params, shard_hook(mesh))


def unshard_node(path: Path, node: Dict[str, Any], group) -> Dict[str, Any]:
    """The whole linear or adapter node from the ``group`` ranks' parts
    (:func:`shard_node` undone); every rank of the group calls it."""
    kind = layout(path)
    lora = "a" in node and "b" in node
    out = dict(node)

    def whole(k, part, dim):
        t = gather(part, group, dim)
        return gemm_layout(t) if k in _INT8_LEAVES else t

    if kind == "col":
        for k in ("b",) if lora else _kernel_keys(node) + ("bias", "scale"):
            if k in node:
                out[k] = whole(k, node[k], -1)
    elif kind == "row":
        for k in ("a",) if lora else _kernel_keys(node):
            out[k] = whole(k, node[k], -2)
    elif kind == "split_row":
        if lora:
            a, n = node["a"], dist.get_world_size(group)
            k = node["b"].shape[-1] // n
            out["a"] = torch.cat([gather(a[..., :k, :], group, -2),
                                  gather(a[..., k:, :], group, -2)], dim=-2)
        for k in _KERNELS:
            if f"{k}_attn" in node:
                t = torch.cat([gather(out.pop(f"{k}_attn"), group, -2),
                               gather(out.pop(f"{k}_mlp"), group, -2)], dim=-2)
                out[k] = gemm_layout(t) if k in _INT8_LEAVES else t
    return out


def unshard_tree(tree: Dict[str, Any], group) -> Dict[str, Any]:
    """The whole FLUX, SD3 or adapter tree from the ``model`` ranks' slices
    (``group``: ``Mesh.group("model")``), on every rank of the group."""
    return shard_tree(tree, lambda path, node: unshard_node(
        path, {k: v.detach() for k, v in node.items()}, group))


def t5_layout(path: Path) -> str:
    """The cut of the T5 encoder's linear node at ``path``
    (``t5_param_shardings``): "col", "row" or "rep"."""
    if len(path) < 2 or path[0] != "blocks":
        return "rep"
    return ("col" if path[-1] in _T5_COL
            else "row" if path[-1] in _T5_ROW else "rep")


def t5_shard_hook(mesh: Mesh) -> Callable[[Path, Dict[str, Any]], Dict[str, Any]]:
    """:func:`shard_hook` for the T5 encoder's tree (``models/text.py``);
    the heads must divide the ``model`` axis."""
    part, n = mesh.index("model"), mesh.size("model")
    return lambda path, node: shard_node(path, node, part, n, t5_layout(path))


def shard_t5_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's slices of a T5 encoder tree, in the layout of
    ``t5_param_shardings``: the embedding, the relative-position bias and
    the norms stay whole (``models/text.t5_encoder_forward`` takes its
    heads' columns of the bias)."""
    return shard_tree(params, t5_shard_hook(mesh))


# ------------------------------------------------------------ activations


def gather(x: torch.Tensor, group: dist.ProcessGroup, dim: int = 0) -> torch.Tensor:
    """The group's parts of ``x``, concatenated along ``dim`` in rank
    order (``all_gather_into_tensor``)."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return torch.cat(out.reshape(n, *x.shape).unbind(0), dim=dim)


def data_shard(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the leading (batch) axis over ``data``
    (``data_sharding``); the batch must divide the axis."""
    n, i = mesh.size("data"), mesh.index("data")
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not split over data={n}")
    k = x.shape[0] // n
    return x[i * k:(i + 1) * k]


def data_parallel(fn, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``fn`` over the batch of ``x`` split across ``data``: the batch is
    padded with repeats of its first item to a multiple of the axis (as
    the JAX package pads its tile chunks), each rank runs its slice, the
    slices are gathered and the padding cut off.  Every rank returns the
    whole result."""
    nb = x.shape[0]
    pad = (-nb) % mesh.size("data")
    if pad:
        x = torch.cat([x, x[:1].expand(pad, *x.shape[1:])])
    return gather(fn(data_shard(x, mesh)), mesh.group("data"))[:nb]
