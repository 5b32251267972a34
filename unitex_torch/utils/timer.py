"""Stage timer (the reference's CPUTimer,
reference texturetools/utils/timer.py:14-31): context
manager / decorator printing perf_counter deltas, with an optional device
sync (``torch.cuda.synchronize``) so queued device work is included."""

from __future__ import annotations

import functools
import time
from typing import Dict


class CPUTimer:
    """with CPUTimer('stage'): ...  — or as a decorator.  Records the last
    duration in ``CPUTimer.records[name]`` for benchmarking."""

    records: Dict[str, float] = {}

    def __init__(self, name: str = "", sync: bool = True, verbose: bool = True):
        self.name = name
        self.sync = sync
        self.verbose = verbose

    def _sync(self):
        if self.sync:
            import torch

            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self.t0
        CPUTimer.records[self.name] = dt
        if self.verbose:
            print(f"[timer] {self.name}: {dt:.3f}s")
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with CPUTimer(self.name or fn.__name__, self.sync, self.verbose):
                return fn(*args, **kwargs)

        return wrapper
