"""The process group (``deepsense6g_tii_tpu/parallel/distributed.py:33-102``).

``initialize()`` is an idempotent ``torch.distributed.init_process_group``.
It takes its coordinator, process count and process index from its
arguments, then from the JAX package's variables (``DEEPSENSE_COORDINATOR``
as ``host:port``, ``DEEPSENSE_NUM_PROCESSES``, ``DEEPSENSE_PROCESS_ID``),
then from the launcher's (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``; ``python -m torch.distributed.run`` sets them).
Without them it returns False, a single-process run, unless
``require=True`` (what ``cli/train.py --multihost 1`` passes): then it
raises, so that N copies of a script started without a launcher do not
train N duplicate single-process runs.

The backend is NCCL when CUDA is available and gloo otherwise; ``backend=``
overrides it (gloo with several ranks on one card, which NCCL refuses).
With CUDA, ``torch.cuda.set_device(LOCAL_RANK)`` runs first, so each rank
holds its own card.

``barrier``, ``broadcast_str`` and ``process_info`` keep the JAX package's
names and keys.  ``all_reduce_sum`` is differentiable: its backward
all-reduces the incoming gradient (BatchNorm's global statistics,
``models/resnet.py``).  So is ``all_gather_rows``, the ranks' rows
concatenated in rank order (the rebuild step's NT-Xent over the global
batch, ``rebuild/losses.py``).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist


def _env_int(*names) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _env_coordinator() -> Optional[str]:
    if os.environ.get("DEEPSENSE_COORDINATOR"):
        return os.environ["DEEPSENSE_COORDINATOR"]
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def local_rank() -> int:
    """This process's index among those of its host (``LOCAL_RANK``,
    default 0)."""
    return _env_int("LOCAL_RANK") or 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               require: bool = False,
               backend: Optional[str] = None) -> bool:
    """Joins the process group.  Returns True when a group is (or already
    was) up, False for the single-process no-op; raises instead of that
    no-op when ``require``."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or _env_coordinator()
    if num_processes is None:
        num_processes = _env_int("DEEPSENSE_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("DEEPSENSE_PROCESS_ID", "RANK")
    if None in (coordinator_address, num_processes, process_id):
        if not require:
            return False
        raise RuntimeError(
            "multi-process training was asked for (--multihost 1), but no "
            "process group is described: start the processes with "
            "`python -m torch.distributed.run --nproc_per_node N ...`, or "
            "set DEEPSENSE_COORDINATOR (host:port), DEEPSENSE_NUM_PROCESSES "
            "and DEEPSENSE_PROCESS_ID in each")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def shutdown() -> None:
    """Leaves the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(tag: str) -> None:
    """Cross-process sync point; a no-op in single-process runs.  ``tag``
    names it for the reader (torch's barrier takes none)."""
    del tag
    if process_count() > 1:
        dist.barrier()


def broadcast_str(s: str) -> str:
    """Process 0's string on every process (a no-op single-process); pins
    run-scoped paths, such as a timestamped logdir, that each process would
    otherwise derive on its own."""
    if process_count() == 1:
        return s
    box = [s]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_rows(x: np.ndarray) -> np.ndarray:
    """Every process's host rows, concatenated in process order (the
    identity single-process).  Goes through pickled CPU tensors, which both
    backends gather: gloo gathers no CUDA tensor."""
    if process_count() == 1:
        return x
    parts: List = [None] * process_count()
    dist.all_gather_object(parts, np.ascontiguousarray(x))
    return np.concatenate(parts, 0)


def process_info() -> dict:
    """The topology, with the JAX package's keys: one device a process in a
    group; without one, this process's local devices."""
    if dist.is_initialized():
        n = dist.get_world_size()
        return {"process_index": dist.get_rank(), "process_count": n,
                "local_devices": 1, "global_devices": n,
                "backend": dist.get_backend()}
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {"process_index": 0, "process_count": 1, "local_devices": local,
            "global_devices": local}


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss reads the sum: the gradient of their total
        # with respect to this rank's term is the sum of the ranks' grads
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, differentiable."""
    return _AllReduceSum.apply(x, group)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        world = dist.get_world_size(group)
        rank = dist.get_rank(group)
        # every rank's row count, so that every rank sees the same counts
        # and all of them raise together: none is left in a collective
        counts = torch.zeros(world, dtype=torch.float32, device=x.device)
        counts[rank] = x.shape[0]
        dist.all_reduce(counts, group=group)
        if bool((counts != counts[0]).any()):
            raise ValueError(
                f"all_gather_rows: the ranks hold unequal row counts "
                f"{[int(c) for c in counts.tolist()]}")
        b = x.shape[0]
        # gloo gathers no CUDA tensor: an all-reduce of a zero buffer in
        # which each rank writes its own slot, which adds zeros (exact)
        out = x.new_zeros((world * b,) + tuple(x.shape[1:]))
        out[rank * b:(rank + 1) * b] = x
        dist.all_reduce(out, group=group)
        ctx.group, ctx.rows = group, slice(rank * b, (rank + 1) * b)
        return out

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss reads every slot: this rank's rows take the sum
        # of the ranks' gradients of its slot
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rows], None


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's (b, ...) tensors concatenated along the rows in rank
    order, (world·b, ...), differentiable: the backward sums the incoming
    gradient over the group and returns this rank's slot.  Unequal row
    counts raise ``ValueError`` on every rank.  One all-reduce of the
    counts and one of the rows (both backends, CUDA or CPU tensors)."""
    return _AllGatherRows.apply(x, group)
