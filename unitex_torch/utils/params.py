"""Parameter trees: the bridge from the JAX package and random init.

Both packages keep parameters as nested dicts with the same leaf names:
linear kernels [d_in, d_out], transformer blocks stacked along a leading
[L, ...] axis, LoRA adapters as {"a", "b"} pairs.  ``params_from_jax``
carries a numpy (or JAX) tree across unchanged; ``init_from_spec`` makes a
random tree on the device directly in its final dtype, so a full-size
tree never exists in f32 or on the host.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

# a leaf spec: ("uniform", shape, bound) | ("zeros", shape) | ("ones", shape)
# | ("normal", shape, std)
LeafSpec = Tuple
Spec = Dict[str, Union["Spec", LeafSpec]]


def params_from_jax(tree: Any, device="cuda", dtype: torch.dtype | None = None):
    """Nested dict (or list) of numpy/JAX arrays -> the same structure of
    torch tensors on ``device``.  Floating leaves are cast to ``dtype``
    when given; integer leaves keep their type; ``None`` (an absent
    branch, such as the last Swin stage's downsample) stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device, dtype) for v in tree)
    arr = np.asarray(tree)
    t = torch.from_numpy(np.array(arr))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def tree_to(tree: Any, device):
    """A nested dict/list of tensors, each moved to ``device``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


def linear_spec(d_in: int, d_out: int, bias: bool = True, lead=()) -> Spec:
    """``linear_init`` of the JAX package: uniform(±1/sqrt(d_in)) kernel,
    zero bias; ``lead`` prepends stacked-layer axes."""
    p = {"kernel": ("uniform", (*lead, d_in, d_out), 1.0 / math.sqrt(d_in))}
    if bias:
        p["bias"] = ("zeros", (*lead, d_out))
    return p


def init_from_spec(
    spec: Spec, generator: torch.Generator, device="cuda",
    dtype: torch.dtype = torch.float32,
):
    """Materialize a spec tree on ``device`` in ``dtype``, drawing from
    ``generator`` (which must live on ``device``)."""
    if isinstance(spec, dict):
        return {k: init_from_spec(v, generator, device, dtype)
                for k, v in spec.items()}
    if isinstance(spec, list):
        return [init_from_spec(v, generator, device, dtype) for v in spec]
    kind, shape = spec[0], spec[1]
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    out = torch.empty(shape, dtype=dtype, device=device)
    if kind == "uniform":
        return out.uniform_(-spec[2], spec[2], generator=generator)
    if kind == "normal":
        return out.normal_(0.0, spec[2], generator=generator)
    raise ValueError(f"unknown leaf spec {spec!r}")


def tree_shapes(tree) -> Dict[str, tuple]:
    """Flat {"a/b/c": shape} of a nested dict/list of arrays or tensors."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")
        elif node is not None:
            out[prefix] = tuple(node.shape)

    walk(tree, "")
    return out
