"""Checkpoints and the JSON run record (``deepsense6g_tii_tpu/train/
checkpoints.py``), written with ``torch.save``.

A run directory holds, under the JAX package's file stems:
  final_model.pt   — the model's state_dict every epoch
  best_model.pt    — the same on a new best validation DBA
  best_optim.pt    — AdamW's state_dict and the EMA shadow at the best
  all_finetune_on_final_{model,optim}.pt — the finetune stream
  recent.log       — the run record, bare JSON with the JAX package's keys
  scalars.jsonl    — one {"tag", "step", "value"} line per scalar
plus a TensorBoard event file (utils/tb_events.py) and args.txt.

The model's state is keyed by the port's parameter names, which are the
flax scope names that ``models/weights.py::from_jax_variables`` produces
(``encoder.image_encoder.stem.conv1.weight``, ...).  Files hold CPU
tensors only and load with ``weights_only=True``.

In a process group (parallel/distributed.py) only rank 0 writes: every
writer here returns at once on another rank, before it copies anything
off the card.  Rank 0 flushes its async writes before the barrier that
precedes a read (``train/engine.py``); every rank reads.
"""

from __future__ import annotations

import atexit
import json
import os
import queue
import threading
from typing import Any, Dict, Mapping, Optional

import torch

from ..parallel.distributed import process_index


class AsyncWriter:
    """Background checkpoint writer: ``torch.save`` and the disk write run
    on a worker thread, off the training loop.

    The caller hands over CPU tensors (``_snapshot`` copies them off the
    card synchronously, so the next step may update the live ones).  Writes
    are FIFO per process (one worker), and ``flush()`` blocks until
    everything queued has landed: call it before reading back a file
    written by this process (rollback to the best model does).  A write
    error surfaces on the next save or flush.  The worker touches no CUDA.
    """

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._err: list = []
        self._t: Optional[threading.Thread] = None

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            path, data, encode = item
            try:
                tmp = path + ".tmp"
                encode(data, tmp)
                os.replace(tmp, path)
            except BaseException as e:
                self._err.append(e)
            finally:
                self._q.task_done()

    def _submit(self, path: str, data: Any, encode) -> None:
        if self._t is None or not self._t.is_alive():
            self._t = threading.Thread(target=self._worker, daemon=True)
            self._t.start()
            atexit.register(self.flush)   # daemon thread: drain before exit
        # enqueue first, then surface an earlier write's error: this
        # checkpoint must not be dropped for an unrelated older failure
        self._q.put((path, data, encode))
        if self._err:
            raise self._err.pop(0)

    def submit(self, path: str, host_tree: Any) -> None:
        self._submit(path, host_tree, torch.save)

    def submit_json(self, path: str, record: Any) -> None:
        """Queues a small JSON file behind the pending checkpoint writes, so
        the run record on disk never names weights that have not landed."""
        self._submit(path, record, _write_json)

    def flush(self) -> None:
        self._q.join()
        if self._err:
            raise self._err.pop(0)


def _write_json(record, path: str) -> None:
    with open(path, "w") as f:
        f.write(json.dumps(record))


_ASYNC = AsyncWriter()


def flush() -> None:
    """Blocks until all pending async checkpoint writes have landed."""
    _ASYNC.flush()


def _snapshot(tree):
    """A CPU copy of a (nested) dict of tensors that shares no storage with
    the live state."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    return tree


def _write(path: str, tree: Any, async_write: bool = False) -> None:
    if process_index() != 0:
        return
    host = _snapshot(tree)
    if async_write:
        _ASYNC.submit(path, host)
        return
    tmp = path + ".tmp"
    torch.save(host, tmp)
    os.replace(tmp, path)


def _read(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def model_path(logdir: str, name: str) -> str:
    return os.path.join(logdir, f"{name}.pt")


def save_model(logdir: str, name: str, model: torch.nn.Module,
               async_write: bool = False) -> str:
    """The model's parameters and BatchNorm statistics (its state_dict)."""
    path = model_path(logdir, name)
    _write(path, model.state_dict(), async_write)
    return path


def load_model(logdir: str, name: str, model: torch.nn.Module) -> None:
    """Loads ``name`` into ``model`` in place (strict)."""
    model.load_state_dict(_read(model_path(logdir, name)), strict=True)


def save_optim(logdir: str, name: str, optimizer: torch.optim.Optimizer,
               ema: Dict[str, torch.Tensor],
               async_write: bool = False) -> str:
    """AdamW's state_dict and the EMA shadow."""
    path = model_path(logdir, name)
    _write(path, {"opt_state": optimizer.state_dict(), "ema_params": ema},
           async_write)
    return path


def load_optim(logdir: str, name: str, optimizer: torch.optim.Optimizer
               ) -> Dict[str, torch.Tensor]:
    """Loads AdamW's state into ``optimizer`` in place; returns the saved
    EMA shadow (CPU tensors) for the caller to use or drop."""
    out = _read(model_path(logdir, name))
    optimizer.load_state_dict(out["opt_state"])
    return out["ema_params"]


def write_run_record(logdir: str, record: Dict,
                     async_write: bool = False) -> None:
    """recent.log: bare ``json.dumps`` of the record.  ``async_write``
    queues it behind the pending checkpoint writes (FIFO)."""
    path = os.path.join(logdir, "recent.log")
    if process_index() != 0:
        return
    if async_write:
        _ASYNC.submit_json(path, record)
        return
    _write_json(record, path)


def read_run_record(logdir: str) -> Optional[Dict]:
    path = os.path.join(logdir, "recent.log")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_args(logdir: str, args: Dict) -> None:
    """args.txt: the CLI's arguments as indented JSON."""
    if process_index() != 0:
        return
    with open(os.path.join(logdir, "args.txt"), "w") as f:
        json.dump(args, f, indent=2)


class ScalarLogger:
    """Scalar stream: ``scalars.jsonl`` of (tag, step, value) and a
    TensorBoard event file (utils/tb_events.py).  ``tensorboard=False`` (or
    DEEPSENSE_TENSORBOARD=0) skips the event file."""

    def __init__(self, logdir: str, tensorboard: Optional[bool] = None):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")
        self._tb = None
        if tensorboard is None:
            tensorboard = os.environ.get("DEEPSENSE_TENSORBOARD", "1") != "0"
        if tensorboard:
            from ..utils.tb_events import EventFileWriter
            self._tb = EventFileWriter(logdir)

    def scalar(self, tag: str, value, step: int) -> None:
        self._f.write(json.dumps(
            {"tag": tag, "step": int(step), "value": float(value)}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.scalar(tag, float(value), int(step))

    def scalars(self, tag: str, values: Dict[str, Any], step: int) -> None:
        for k, v in values.items():
            self.scalar(f"{tag}/{k}", v, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """A ScalarLogger that writes nothing."""

    def scalar(self, tag, value, step) -> None:
        pass

    def scalars(self, tag, values, step) -> None:
        pass

    def close(self) -> None:
        pass
