"""Process meshes over ``torch.distributed`` (port of
unitex_tpu/parallel/mesh.py).

The JAX package is single-controller: one process sees every device, a
``jax.sharding.Mesh`` names a ``(data, model)`` grid of them and XLA places
the collectives.  The port is multi-controller: one process per GPU
(launched by ``torchrun``), and a :class:`Mesh` is this process's view of
the grid: the size of each axis, this rank's coordinate on it, and the
process group of the ranks that share every other coordinate (its
"row" along the axis).  The model code runs its collectives explicitly
over those groups: ``all_reduce`` after a row-parallel product
(``models/flux/layers.row_linear``), ``all_to_all_single`` for Ulysses and
``batch_isend_irecv`` for the ring (``ops/ring_attention.py``),
``all_gather`` of a batch split over ``data``.

The grid is ``(data, pipe, seq, model)``, row-major: global rank
``((d·pipe + p)·seq + s)·model + m``, so a ``(data, model)`` mesh lays its
ranks out as JAX's ``devices.reshape(data, model)`` does, and a ``(data,
pipe)`` mesh as the JAX launcher's ``reshape(data, pipe)``.  ``seq`` is
the axis the token sequence is sharded over (``models/flux/sp.py``); with
``model`` > 1 too it is the SP x TP layout.  ``pipe`` is the axis the
block stacks are staged over (``parallel/pipeline.py``,
``models/flux/pp.py``).  A world of one rank is a mesh like any other:
its collectives run (over NCCL or gloo) and copy.

NCCL serves CUDA tensors, gloo the CPU (``device="cpu"``, as the tests
ask).  Nothing falls back: a process group that cannot start raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import sys
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..utils.precision import resolve_device

AXES = ("data", "pipe", "seq", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a ``(data, pipe, seq, model)`` process grid."""

    shape: Dict[str, int]          # axis -> size
    coords: Dict[str, int]         # axis -> this rank's index on it
    groups: Dict[str, dist.ProcessGroup]  # axis -> this rank's group on it
    device: torch.device

    @property
    def rank(self) -> int:
        return dist.get_rank()

    @property
    def world_size(self) -> int:
        return dist.get_world_size()

    @property
    def is_root(self) -> bool:
        """Rank 0, which does a job's host work."""
        return self.rank == 0

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> dist.ProcessGroup:
        return self.groups[axis]


def world_size_from_env() -> int:
    """The world size ``torchrun`` announces (``WORLD_SIZE``), 1 without
    it."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def default_device(device="cuda") -> torch.device:
    """``cuda`` -> ``cuda:LOCAL_RANK`` (``torchrun``'s, 0 without it);
    any other device as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def init_distributed(device, store=None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> None:
    """Start the default process group unless one is running: NCCL for a
    CUDA device, gloo for the CPU; from ``store``/``rank``/``world_size``
    when given, else from ``torchrun``'s environment (``env://``)."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)
    else:
        dist.init_process_group(backend)


def make_mesh(
    data: int = 1,
    model: int = -1,
    seq: int = 1,
    device="cuda",
    store=None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    pipe: int = 1,
) -> Mesh:
    """A ``(data, pipe, seq, model)`` mesh over every rank of the default
    process group, started here if it is not running (see
    :func:`init_distributed`).  ``model=-1`` takes every rank the other
    axes leave, as in the JAX package; the sizes must multiply to the
    world size.  Every rank must call this with the same arguments: each
    axis' groups are created on every rank, in one order."""
    dev = default_device(device)
    init_distributed(dev, store, rank, world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    world = dist.get_world_size()
    if model == -1:
        if world % (data * pipe * seq):
            raise ValueError(f"{world} ranks not divisible by data={data} x "
                             f"pipe={pipe} x seq={seq}")
        model = world // (data * pipe * seq)
    shape = {"data": data, "pipe": pipe, "seq": seq, "model": model}
    if data * pipe * seq * model != world:
        raise ValueError(f"mesh {data}x{pipe}x{seq}x{model} (data x pipe x "
                         f"seq x model) needs {data * pipe * seq * model} "
                         f"ranks, the world has {world}")
    me = dist.get_rank()
    coords, rest = {}, me
    for axis in reversed(AXES):
        coords[axis], rest = rest % shape[axis], rest // shape[axis]

    def grid_rank(c):
        r = 0
        for axis in AXES:
            r = r * shape[axis] + c[axis]
        return r

    groups = {}
    for axis in AXES:
        others = [a for a in AXES if a != axis]
        # every row of the grid along ``axis``, in one order on every rank
        for idx in itertools.product(*(range(shape[a]) for a in others)):
            c = dict(zip(others, idx))
            ranks = [grid_rank({**c, axis: k}) for k in range(shape[axis])]
            group = dist.new_group(ranks)
            if me in ranks:
                groups[axis] = group
    return Mesh(shape, coords, groups, dev)


# a job's messages from rank 0: the key of a failed job's
_ABORT = "__job_aborted__"


class JobAborted(RuntimeError):
    """Rank 0's part of a job failed at a host-side point: raised on the
    other ranks where they wait for rank 0 (:func:`broadcast_tensors`'
    header, :func:`wait_job`)."""


def start_job(kind: str, **fields) -> None:
    """Rank 0: announce a job of ``kind`` (with ``fields``) to the other
    ranks, who read it with :func:`next_job`."""
    dist.broadcast_object_list([{"kind": kind, **fields}], src=0)


def next_job() -> dict:
    """A rank other than 0: the next job rank 0 announces
    (:func:`start_job`), as ``{"kind": ..., **fields}``."""
    msg = [None]
    dist.broadcast_object_list(msg, src=0)
    return msg[0]


def _receive(meta: list) -> dict:
    dist.broadcast_object_list(meta, src=0)
    if _ABORT in meta[0]:
        raise JobAborted(meta[0][_ABORT])
    return meta[0]


def end_job(error: Optional[BaseException] = None) -> None:
    """Rank 0: the end of one job for the other ranks, who wait for it in
    :func:`wait_job` or in their next :func:`broadcast_tensors`.  With
    ``error`` (rank 0's part failed) they raise :class:`JobAborted`
    there.  Outside a :func:`collective_section` every point where the
    other ranks wait for rank 0 is such a broadcast, so rank 0 ends a job
    that failed at a host-side point with one call.  A failure inside a
    section never gets here: it ends the process."""
    msg = {} if error is None else {
        _ABORT: f"{type(error).__name__}: {error}"}
    dist.broadcast_object_list([msg], src=0)


def wait_job() -> None:
    """A rank other than 0: wait for rank 0's :func:`end_job`; raises
    :class:`JobAborted` where rank 0's part failed."""
    _receive([None])


@contextlib.contextmanager
def collective_section():
    """Collectives that every rank of a job runs together: the tensors of
    :func:`broadcast_tensors`, a tensor-parallel denoise or SR stage.
    When this rank fails inside one, the others may be waiting in one of
    its collectives, where no message can reach them and any message
    would pair with the wrong collective.  So a failure here
    (``KeyboardInterrupt`` too) is printed and the process exits at once
    with status 1, its communicators with it; the launcher (``torchrun``)
    then ends the other ranks.  No rank waits for good, and none reads a
    later message out of step.  :class:`JobAborted` (rank 0's message,
    read at a point where every rank waits for it) passes through."""
    try:
        yield
    except JobAborted:
        raise
    except BaseException:
        rank = dist.get_rank() if dist.is_initialized() else 0
        print(f"[rank {rank}] failed inside a collective section; the "
              f"process exits", file=sys.stderr, flush=True)
        traceback.print_exc()
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(1)


def broadcast_tensors(tensors: Optional[Dict[str, torch.Tensor]],
                      mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Rank 0's dict of tensors on every rank (on ``mesh.device``): rank 0
    passes the dict, the other ranks ``None``.  Names, shapes and dtypes
    go first (``broadcast_object_list``), then each tensor, inside a
    :func:`collective_section`.  A rank other than 0 raises
    :class:`JobAborted` where rank 0 ended the job instead
    (:func:`end_job`)."""
    meta = [None]
    if mesh.is_root:
        meta = [{k: (tuple(v.shape), v.dtype) for k, v in tensors.items()}]
    meta = [_receive(meta)]
    out = {}
    with collective_section():
        for name, (shape, dtype) in meta[0].items():
            if mesh.is_root:
                t = tensors[name].to(mesh.device, dtype).contiguous()
            else:
                t = torch.empty(shape, dtype=dtype, device=mesh.device)
            dist.broadcast(t, src=0)
            out[name] = t
    return out
