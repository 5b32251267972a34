"""Checkpoint management: periodic saves, latest-resume, total-limit pruning
(port of unitex_tpu/training/checkpoint.py).

Checkpoints live in ``<dir>/checkpoint-<step>`` and the newest ones win,
with the JAX package's cadence (``step % save_every == 0``, step > 0) and
``total_limit`` pruning of the oldest.  A checkpoint directory holds one
``state.pt``: the tree of tensors and numbers written by ``torch.save``
and read back with ``weights_only=True``.

Deferred: reading or writing the JAX package's orbax checkpoints.
``orbax`` imports JAX, which the port never imports, and the GPU machine
has neither ``orbax`` nor ``tensorstore``, whose on-disk format a reader
without JAX would have to parse.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, List, Optional

import torch

FILE = "state.pt"


def _step_dirs(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def _like(loaded: Any, template: Any, where: str = "") -> Any:
    """``loaded`` checked against ``template``'s structure and shapes, each
    tensor moved to the template tensor's device and dtype."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(template):
            raise ValueError(f"checkpoint tree differs from the template at "
                             f"{where or '/'}")
        return {k: _like(loaded[k], v, f"{where}/{k}") for k, v in template.items()}
    if torch.is_tensor(template):
        if not torch.is_tensor(loaded) or loaded.shape != template.shape:
            raise ValueError(f"checkpoint leaf {where} does not match the "
                             f"template's shape {tuple(template.shape)}")
        return loaded.to(device=template.device, dtype=template.dtype)
    return loaded


def _detached(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach() if torch.is_tensor(tree) else tree


class CheckpointManager:
    def __init__(
        self,
        root: str,
        save_every: int = 500,
        total_limit: Optional[int] = None,
    ):
        self.root = root
        self.save_every = save_every
        self.total_limit = total_limit
        os.makedirs(root, exist_ok=True)

    def latest_step(self) -> Optional[int]:
        steps = _step_dirs(self.root)
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.root, f"checkpoint-{step}")

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, step: int, tree: Any) -> str:
        """Write ``tree`` as checkpoint ``step`` (replacing one of the same
        step), then prune to ``total_limit``.  The file is written under a
        temporary name and renamed, so a checkpoint is whole or absent."""
        path = os.path.abspath(self.path(step))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        tmp = os.path.join(path, FILE + ".tmp")
        torch.save(_detached(tree), tmp)
        os.replace(tmp, os.path.join(path, FILE))
        self._prune()
        return path

    def restore_latest(self, template: Any) -> Optional[Any]:
        """Restore the newest checkpoint into the template's structure
        (devices and dtypes included), or None when the directory is empty
        (resume_from_checkpoint='latest')."""
        step = self.latest_step()
        if step is None:
            return None
        loaded = torch.load(os.path.join(self.path(step), FILE),
                            map_location="cpu", weights_only=True)
        return _like(loaded, template)

    def _prune(self) -> None:
        if self.total_limit is None:
            return
        steps = _step_dirs(self.root)
        while len(steps) > self.total_limit:
            victim = steps.pop(0)
            shutil.rmtree(self.path(victim), ignore_errors=True)
