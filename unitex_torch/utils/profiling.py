"""Device profiling (port of unitex_tpu/utils/profiling.py).

The reference has only perf_counter timers and a peak-VRAM decorator.
Here: a ``torch.profiler`` trace of a block (CPU and CUDA activities)
written as a Chrome trace, named regions inside it, device-memory
snapshots under the JAX package's key names, and a collect-until-stable
``empty_cache``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


def _cuda_ready() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def profiled(log_dir: str, name: str = "trace") -> Iterator[torch.profiler.profile]:
    """Trace the enclosed block with ``torch.profiler`` (the CPU, and CUDA
    where a card is present) and write it as a Chrome trace to
    ``<log_dir>/<name>.json`` (viewable in Perfetto).  The card is
    synchronized before the trace stops, so its queued work is inside.
    Yields the profiler (``key_averages()`` after the block)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(log_dir, f"{name}.json")
    prof = torch.profiler.profile(activities=activities)
    t0 = time.perf_counter()
    prof.start()
    try:
        yield prof
    finally:
        if _cuda_ready():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)
        print(f"[profile] {name}: {time.perf_counter() - t0:.3f}s -> {path}")


def device_memory_stats(device: Optional[torch.device] = None) -> Dict[str, int]:
    """Memory stats of a CUDA device under the JAX package's names:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (the caching allocator's
    allocated bytes, now and at peak) and ``bytes_limit`` (the card's
    total memory).  ``{}`` on the CPU or without a card."""
    if device is None:
        if not _cuda_ready():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    out = {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": torch.cuda.mem_get_info(device)[1],
    }
    return {k: int(v) for k, v in out.items() if v is not None}


def annotate(name: str):
    """A named region inside a captured trace."""
    return torch.profiler.record_function(name)


def empty_cache(max_rounds: int = 8) -> int:
    """Free device memory held only by dead Python references (the
    reference's empty_cache loop): collect cycles until the allocated
    bytes stop shrinking, then release the allocator's cached blocks.
    Returns the allocated bytes freed (0 on the CPU)."""
    import gc

    if not _cuda_ready():
        return 0

    def in_use() -> int:
        return torch.cuda.memory_allocated()

    start = prev = in_use()
    for _ in range(max_rounds):
        gc.collect()
        cur = in_use()
        if cur >= prev:
            break
        prev = cur
    torch.cuda.empty_cache()
    return start - prev


def hf_snapshot_download(repo_id: str, **kwargs) -> str:
    """Fetch a HuggingFace repo snapshot, gated on ``huggingface_hub`` and
    a network being available; returns the local path.  Offline
    deployments place checkpoints per WEIGHTS.md instead."""
    try:
        import huggingface_hub
    except ImportError as e:
        raise RuntimeError(
            "huggingface_hub unavailable; fetch weights manually (WEIGHTS.md)"
        ) from e
    return huggingface_hub.snapshot_download(repo_id, **kwargs)
