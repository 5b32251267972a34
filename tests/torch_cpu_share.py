"""CPU threads for the port's tests (``tests/test_torch_*.py``).

PyTorch starts as many intra-op threads as the machine has cores.  Under
pytest-xdist every worker is a process of its own, so six workers on eight
cores would run 48 PyTorch threads beside XLA's own pools.  ``share_cpu``
gives each worker its share of the cores instead; a run in one process
keeps PyTorch's default.
"""

import os

import torch


def share_cpu() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
