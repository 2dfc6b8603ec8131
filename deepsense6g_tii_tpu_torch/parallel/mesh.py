"""The mesh that training and serving run over
(``deepsense6g_tii_tpu/parallel/mesh.py:20-87``).

JAX's 1-D ``('data',)`` mesh shards the batch over all chips of one
process, or of several processes after ``jax.distributed.initialize``,
and XLA emits the gradient all-reduce inside the jitted step.  In the port
a :class:`Mesh` is one of two things:

* a rank's share of a process group (one process per GPU): this rank's
  device, the group and its size.  Each rank holds only its own rows of
  the global batch, the contiguous block ``[r·b, (r + 1)·b)``
  (:meth:`Mesh.rows`), as JAX's process-local data concatenates in
  process order; ``train/steps.py`` all-reduces the gradients and
  ``models/resnet.py::BatchNorm`` its statistics over the group;
* within one serving process, a list of local devices, each holding a
  replica of the model (``serve.Predictor(use_mesh=True)``).

``replicate`` broadcasts parameters and buffers from rank 0 once, the way
DDP starts; it replaces the JAX package's reliance on identical seeded
initialisation in every process.  JAX's ``spans_processes``, ``_put`` and
``shard_stacked_batch`` have no counterpart: a rank never assembles a
global array, and the port has no stacked multi-step dispatch (ROADMAP.md
Queue 1 item 5).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


class Mesh:
    """``devices``: the local devices (one in a process group); ``group``:
    the process group (``None``: this process alone)."""

    def __init__(self, devices: Sequence, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if group is not None and len(self.devices) != 1:
            raise ValueError("a rank of a process group holds one device")
        self.group = group

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    def rows(self, n: int) -> slice:
        """This rank's block of a global batch of ``n`` rows."""
        if n % self.world_size:
            raise ValueError(f"a global batch of {n} rows does not split "
                             f"over {self.world_size} ranks")
        b = n // self.world_size
        return slice(self.rank * b, (self.rank + 1) * b)


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """In a process group: this rank's ``device`` (default the current CUDA
    device, else the CPU) and the group.  Otherwise the local devices, all
    CUDA devices (the first ``n_devices``) or the CPU."""
    if dist.is_initialized():
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if torch.cuda.is_available() else "cpu")
        return Mesh([device], group=dist.group.WORLD)
    if torch.cuda.is_available():
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device("cpu")]
    return Mesh(devices[:n_devices] if n_devices else devices)


@torch.no_grad()
def replicate(module: nn.Module, mesh: Optional[Mesh]) -> None:
    """Overwrites every parameter and buffer of ``module`` with rank 0's,
    in place: one broadcast of a flat buffer per dtype.  A no-op without a
    group."""
    if mesh is None or mesh.world_size == 1:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for t in (*module.parameters(), *module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src=0, group=mesh.group)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


def sync_batchnorm(model: nn.Module, mesh: Optional[Mesh]) -> None:
    """Takes the train-mode statistics of every BatchNorm of ``model``
    (the backbones', the rebuild heads') over ``mesh``'s group (local again
    without one)."""
    from ..models.resnet import BatchNorm
    group = mesh.group if mesh is not None and mesh.world_size > 1 else None
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def pad_to_multiple(n: int, m: int) -> int:
    return (m - n % m) % m


def pad_batch(batch: Dict, multiple: int) -> Dict:
    """A host batch padded to a multiple of ``multiple`` rows by repeating
    its last row, with a ``valid`` mask (1.0 real, 0.0 padded) that keeps
    the padded rows out of the loss and BatchNorm's statistics
    (``deepsense6g_tii_tpu/train/engine.py:179-195``).  Unchanged when no
    row is missing."""
    n = len(batch["image"])
    pad = pad_to_multiple(n, multiple)
    if not pad:
        return batch
    out = {k: np.concatenate([np.asarray(v)] + [np.asarray(v[-1:])] * pad)
           for k, v in batch.items()}
    out["valid"] = np.concatenate([np.ones(n, np.float32),
                                   np.zeros(pad, np.float32)])
    return out
