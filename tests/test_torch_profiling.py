"""``unitex_torch/utils/profiling.py`` on the CPU: ``profiled`` writes a
Chrome trace holding an ``annotate``d region and the CPU ops inside it;
without a card the memory stats are empty and ``empty_cache`` frees
nothing.  The card's side (CUDA kernel events, the allocator's numbers)
is ``chip_smoke.py`` phase 16's."""

import json
import os

import torch

from unitex_torch.utils import profiling
from torch_cpu_share import share_cpu

share_cpu()


def test_profiled_writes_a_trace_with_the_annotation(tmp_path, capsys):
    log_dir = str(tmp_path / "traces")
    with profiling.profiled(log_dir, "step") as prof:
        with profiling.annotate("ltm_train_step"):
            y = torch.randn(64, 64) @ torch.randn(64, 64)
    assert y.shape == (64, 64)
    path = os.path.join(log_dir, "step.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "ltm_train_step" in names
    assert any(e.get("cat") == "cpu_op" and "mm" in e.get("name", "")
               for e in events)
    assert "ltm_train_step" in {e.key for e in prof.key_averages()}
    assert "[profile] step: " in capsys.readouterr().out


def test_memory_stats_and_empty_cache_without_a_card():
    assert profiling.device_memory_stats() == {}
    assert profiling.device_memory_stats(torch.device("cpu")) == {}
    assert profiling.empty_cache() == 0
