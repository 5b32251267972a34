"""Disk cache for (quantized) serving parameter trees (port of
unitex_tpu/utils/param_cache.py, the same file format, so a cache written
by either package reads in the other).

Format: one uncompressed ``.npz`` holding the flattened leaves as
``a0..aN`` plus a ``__paths__`` JSON index of ``[path, dtype]`` pairs
(paths are "/"-joined keys, list items as ``#i``), and an optional
``__meta__`` JSON fingerprint.  bfloat16 leaves are stored as their uint16
bit pattern.  Writes are atomic (a temporary file, then a rename), so a
killed process never leaves a torn cache.  Trees are nested dicts (or
lists) of torch tensors; loads come back as CPU tensors.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["save_params", "load_params", "load_meta"]

_BF16_TAG = "bfloat16"


def _to_numpy(leaf) -> tuple:
    """(array as stored, dtype name of the index)."""
    if not torch.is_tensor(leaf):
        a = np.asarray(leaf)
        return a, str(a.dtype)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16_TAG
    a = t.numpy()
    return a, str(a.dtype)


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            if "/" in str(k) or str(k).startswith("#"):
                raise ValueError(f"param key {k!r} contains '/' or starts "
                                 "with '#' (the path and list encodings)")
            _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/#{i}", out)
    else:
        out[prefix] = tree


def _insert(tree: Dict[str, Any], path: str, leaf: Any) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def _listify(tree: Any) -> Any:
    """'#i'-keyed dicts back into lists."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(k.startswith("#") for k in tree):
        return [_listify(tree[f"#{i}"]) for i in range(len(tree))]
    return {k: _listify(v) for k, v in tree.items()}


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def save_params(path: str, params: Any, meta: Any = None) -> None:
    """Atomically write a nested dict/list tree of tensors (or arrays) to
    ``path``; ``meta`` (JSON-serializable) is stored beside it as the
    cache's fingerprint."""
    leaves: Dict[str, Any] = {}
    _flatten(params, "", leaves)
    payload: Dict[str, np.ndarray] = {}
    index = []
    for i, (p, leaf) in enumerate(leaves.items()):
        payload[f"a{i}"], dt = _to_numpy(leaf)
        index.append([p, dt])
    payload["__paths__"] = _json_bytes(index)
    if meta is not None:
        payload["__meta__"] = _json_bytes(meta)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_params(path: str) -> Any:
    """A tree written by :func:`save_params` (either package's), as CPU
    tensors."""
    with np.load(path) as z:
        index = json.loads(bytes(z["__paths__"]).decode())
        tree: Dict[str, Any] = {}
        for i, (p, dt) in enumerate(index):
            a = z[f"a{i}"]
            if dt == _BF16_TAG:
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            _insert(tree, p, t)
    return _listify(tree)


def load_meta(path: str) -> Any:
    """The ``meta`` stored by :func:`save_params`, or None."""
    with np.load(path) as z:
        if "__meta__" not in z.files:
            return None
        return json.loads(bytes(z["__meta__"]).decode())
