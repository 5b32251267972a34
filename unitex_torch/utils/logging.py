"""Training metrics logging (port of unitex_tpu/utils/logging.py).

A dependency-free JSONL logger (one line per step) with an optional
TensorBoard writer when ``torch.utils.tensorboard`` can be imported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._fh = open(self.path, "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
        except ImportError:
            pass

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
