"""The training engine (``deepsense6g_tii_tpu/train/engine.py:43-634``):
epoch loop, validation with per-scenario DBA, test, and the checkpoint
policy.

Per-epoch train and validation loops with top-k and per-scenario DBA,
best-model checkpoints keyed on validation DBA, the optional rollback to
the previous best (weights and AdamW; the live EMA shadow is not rolled
back), the finetune stream keyed on train DBA, EMA weights for validation
and raw weights for test, and the beam_pred.csv / confidence CSV export.

The device side is ``train/steps.py``'s train and eval steps.  The engine
moves batches and keeps each step's loss and ranks on the device; it reads
them back with one host sync per epoch (``readbacks`` counts them).  A
background thread runs the loader (numpy only, never CUDA) ``prefetch``
batches ahead; the training thread pins each collated batch (a fresh pinned
buffer per batch, so no buffer is refilled while a copy from it may still
be in flight) and copies it to the card with ``non_blocking=True`` on a
copy stream, one batch ahead of the step that uses it.  A batch crosses in
the dtypes the loader gives: ``data/cache.py::CachedBatchLoader``'s uint8
and float16 storage is upcast by the steps on the card
(``train/steps.py::upcast``), so the copy moves the compact bytes.

Over a process group (``mesh``, parallel/mesh.py; one process per GPU,
JAX ``engine.py:93-125,179-250``), every rank runs this loop on its own
shard of the training set (``data/dataset.py::shard_for_process``), and
the steps keep the ranks' weights equal.  A rank trains on one device, so
a ragged batch goes to the step as it is (exact rows: BatchNorm's
statistics and the loss see only real samples) and nothing is padded; a
mesh of several local devices (a serving mesh) is refused.  The
``valid``-masked padding of ``parallel/mesh.py::pad_batch`` waits for the
fixed-shape dispatch (ROADMAP.md Queue 1 item 5).  The once-an-epoch
readback all-gathers the train
rows, so that the best-model, rollback and finetune decisions agree on
every rank; validation and test run the full split on every rank.  Only
rank 0 logs and writes (``train/checkpoints.py``), and a barrier comes
before any read of what it wrote.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import queue
import threading
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..config import SCENARIOS, GlobalConfig
from ..parallel import distributed
from ..parallel.mesh import Mesh
from ..utils.device import resolve_device
from . import checkpoints as ckpt
from .metrics import compute_acc, compute_dba_score, flatten_multistep
from .profiling import StepTimer
from .scheduler import cyclic_cosine_decay_lr
from .state import TrainState, create_train_state
from .steps import make_eval_step, make_train_step

DEVICE_KEYS = ("image", "lidar", "radar", "gps", "beam", "beamidx",
               "rebuild_feats", "valid")


@dataclasses.dataclass
class TrainOptions:
    """The CLI surface that concerns the engine (the JAX package's
    ``TrainOptions``).

    ``steps_per_dispatch`` K > 1 runs K optimizer steps one after another:
    the trajectory the JAX package's fused K-step dispatch is pinned to.
    The dispatch saving itself (a captured multi-step program) waits for
    ROADMAP.md Queue 1 item 5.
    """

    logdir: str = "log/run"
    epochs: int = 50
    lr: float = 1e-4
    loss: str = "focal"              # 'focal' | 'ce'
    scheduler: bool = True
    ema: bool = False
    ema_decay: float = 0.999
    temp_coef: bool = True
    load_previous_best: bool = False
    finetune: bool = False
    clip_grad_norm: Optional[float] = None
    seed: int = 100
    prefetch: int = 2                # host batches decoded ahead (0 = off)
    # torch.save and the disk write on a background thread (the copy off
    # the card stays synchronous); loads flush pending writes first
    async_save: bool = True
    steps_per_dispatch: int = 1
    # gradient accumulation over K microbatches (rows [i::K]), one update
    grad_accum: int = 1
    # the JAX package's flattened K x GA scan: not in the port
    flatten_accum: bool = False


class Engine:
    """Trains ``model`` (a ``BeamFuser`` on ``device``) with ``opts``.
    ``device="cuda"`` (the default) raises without CUDA; tests pass
    ``device="cpu"``.  ``mesh`` (``parallel.mesh.make_mesh()`` after
    ``parallel.distributed.initialize``) trains over its process group."""

    def __init__(self, model, cfg: GlobalConfig, opts: TrainOptions,
                 device="cuda", mesh: Optional[Mesh] = None):
        if opts.flatten_accum:
            raise NotImplementedError(
                "flatten_accum is a TPU dispatch knob the PyTorch port does "
                "not take (ROADMAP.md, Out of scope)")
        if mesh is not None and len(mesh.devices) != 1:
            raise ValueError(
                f"the engine trains on one device a rank; a mesh of "
                f"{len(mesh.devices)} local devices is a serving mesh: "
                f"start a rank a device (--multihost 1 under "
                f"torch.distributed.run)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.opts = opts
        self.mesh = mesh
        self._world = 1 if mesh is None else mesh.world_size
        self._lead = mesh is None or mesh.rank == 0
        self.logger = (ckpt.ScalarLogger(opts.logdir) if self._lead
                       else ckpt.NullLogger())

        self.cur_epoch = 0
        self.cur_iter = 0
        self.bestval = 0.0
        self.bestval_epoch = 0
        self.train_loss: List[float] = []
        self.val_loss: List[float] = []
        self.DBA: List[float] = []
        self.DBAft: List[float] = [0.0]      # finetune stream
        self.readbacks = 0                   # host syncs for results
        self.epoch_stats: List[Dict[str, float]] = []

        self.timer = StepTimer()
        self.state: Optional[TrainState] = None
        self._copy_stream = None

    # -- state ---------------------------------------------------------------

    def init_state(self, batch=None) -> TrainState:
        """AdamW, the EMA shadow and the steps, from the model's current
        weights.  ``batch`` is accepted for the JAX package's signature (it
        needs shapes to initialise); the port's model holds its weights."""
        del batch
        o, m, dev = self.opts, self.model, self.device
        self.state = create_train_state(m, mu_dtype=self.cfg.opt_mu_dtype,
                                        mesh=self.mesh)
        kw = dict(loss_name=o.loss, temp_coef=o.temp_coef, rng_seed=o.seed,
                  device=dev)
        self.train_step = make_train_step(
            m, self.cfg, self.state, use_ema=o.ema, ema_decay=o.ema_decay,
            clip_grad_norm=o.clip_grad_norm, grad_accum=o.grad_accum, **kw)
        self.eval_step = make_eval_step(m, self.cfg, self.state,
                                        use_ema=o.ema, **kw)
        # test() predicts with the raw weights, validate() with the EMA
        # shadow when it is on
        self.test_step = make_eval_step(m, self.cfg, self.state,
                                        use_ema=False, **kw)
        return self.state

    def _lr(self) -> float:
        if not self.opts.scheduler:
            return self.opts.lr
        return cyclic_cosine_decay_lr(
            self.cur_epoch, base_lr=self.opts.lr, init_decay_epochs=15,
            min_decay_lr=2.5e-6, restart_interval=10, restart_lr=12.5e-5,
            warmup_epochs=10, warmup_start_lr=2.5e-6)

    # -- batches ---------------------------------------------------------------

    def _prefetched(self, loader: Iterable[Dict]):
        """Iterates ``loader`` on a background thread, ``opts.prefetch``
        batches ahead, and yields (host_batch, seconds the caller waited
        for it).  Worker exceptions re-raise here."""
        depth = self.opts.prefetch
        if depth <= 0:
            it = iter(loader)
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    return
                yield batch, time.perf_counter() - t0

        q: queue.Queue = queue.Queue(maxsize=depth)
        end = object()
        err: List[BaseException] = []
        abandoned = threading.Event()

        def put(item) -> bool:
            # a bounded put that notices the consumer leaving (a step
            # raised), so the worker does not block forever on a full queue
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in loader:
                    if not put(item):
                        return
            except BaseException as e:      # surfaced on the main thread
                err.append(e)
            finally:
                put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                waited = time.perf_counter() - t0
                if item is end:
                    t.join()
                    if err:
                        raise err[0]
                    return
                yield item, waited
        finally:
            abandoned.set()

    def _to_device(self, batch: Dict):
        """The numeric fields on the device.  On the card: pinned (a fresh
        buffer per batch) and copied on the copy stream; returns the
        tensors and the event that marks the copy's end."""
        dev: Dict[str, torch.Tensor] = {}
        cuda = self.device.type == "cuda"
        if cuda and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        for k in DEVICE_KEYS:
            if k not in batch:
                continue
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if cuda:
                t = t.pin_memory()
                with torch.cuda.stream(self._copy_stream):
                    t = t.to(self.device, non_blocking=True)
            dev[k] = t
        event = self._copy_stream.record_event() if cuda else None
        return dev, event

    def _staged(self, loader: Iterable[Dict]):
        """Yields (host_batch, device_batch, n, seconds waited for data),
        the copy of batch k+1 issued before batch k is yielded."""
        pending = None
        for batch, waited in self._prefetched(loader):
            dev, event = self._to_device(batch)
            n = len(batch["image"])
            if pending is not None:
                yield self._ready(*pending)
            pending = (batch, dev, event, n, waited)
        if pending is not None:
            yield self._ready(*pending)

    def _ready(self, batch, dev, event, n, waited):
        """The batch, its copy ordered before the current stream's work."""
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in dev.values():
                t.record_stream(stream)
        return batch, dev, n, waited

    def _read_back(self, tensors: List[torch.Tensor]) -> List[np.ndarray]:
        """Device results -> numpy, with one host sync for all of them."""
        self.readbacks += 1
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        host = [t.to("cpu", non_blocking=True) for t in tensors]
        torch.cuda.current_stream(self.device).synchronize()
        return [h.numpy() for h in host]

    # -- epoch loops -----------------------------------------------------------

    def train(self, loader: Iterable[Dict]) -> float:
        """One training epoch; returns its train DBA."""
        if self.state is None:
            self.init_state()
        lr = self._lr()
        losses, ranks, gt_all = [], [], []
        n_samples, n_batches, waited = 0, 0, 0.0
        readbacks = self.readbacks
        self.timer.reset()
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        for batch, dev, n, w in self._staged(loader):
            m = self.train_step(dev, lr)
            losses.append(m["loss"])
            ranks.append(m["ranks"])
            gt_all.append(np.asarray(batch["beamidx"]))
            waited += w
            n_samples += n
            n_batches += 1
            self.cur_iter += 1
            self.timer.tick()
        loss_h, pred_all = self._read_back([torch.stack(losses),
                                            torch.cat(ranks)])
        loss_epoch = float(loss_h.mean())     # each step's loss is global
        epoch_s = time.perf_counter() - t0          # includes the final sync
        stats = {"epoch": self.cur_epoch + 1, "epoch_s": epoch_s,
                 "samples": n_samples,
                 "samples_per_sec": self._world * n_samples / epoch_s,
                 "step_ms_mean": 1e3 * epoch_s / n_batches,
                 "data_wait_share": waited / epoch_s,
                 "readbacks": self.readbacks - readbacks}
        if cuda:
            stats["peak_memory_gib"] = (
                torch.cuda.max_memory_allocated(self.device) / 2 ** 30)
        self.epoch_stats.append(stats)
        for tag in ("samples_per_sec", "step_ms_mean", "data_wait_share",
                    "readbacks", "peak_memory_gib"):
            if tag in stats:
                self.logger.scalar(f"perf/{tag}", stats[tag],
                                   self.cur_epoch + 1)
        for tag, v in self.timer.stats(n_samples // n_batches).items():
            self.logger.scalar(f"perf/dispatch_{tag}", v, self.cur_epoch + 1)

        # every rank's rows, in rank order, so that the decisions below
        # agree on every rank
        pred_all = distributed.gather_rows(pred_all)
        gt_all = distributed.gather_rows(np.concatenate(gt_all, 0))
        if pred_all.ndim == 3:
            pred_all, gt_all = flatten_multistep(pred_all, gt_all)
        acc = compute_acc(pred_all, gt_all)
        dba = compute_dba_score(pred_all, gt_all)
        self.train_loss.append(loss_epoch)
        self.cur_epoch += 1
        self.logger.scalar("DBA_score_train", dba, self.cur_epoch)
        self.logger.scalars(
            "curr_acc_train",
            {f"beam{i}": a for i, a in enumerate(acc)}, self.cur_epoch)
        self.logger.scalar("curr_loss_train", loss_epoch, self.cur_epoch)
        print(f"Train top beam acc: {acc} DBA score: {dba:.4f}")

        if self.opts.finetune and dba > self.DBAft[-1]:
            self.DBAft.append(dba)
            self._save_finetune()
        return dba

    def validate(self, loader: Iterable[Dict]) -> float:
        """Validation epoch with per-scenario DBA, on the EMA weights when
        ``opts.ema``; every rank runs the full split."""
        if self.state is None:
            self.init_state()
        losses, ranks, gt_all, scen_all = [], [], [], []
        for i, (batch, dev, n, _) in enumerate(self._staged(loader)):
            m = self.eval_step(dev, i)
            losses.append(m["loss"])
            ranks.append(m["ranks"])
            gt_all.append(np.asarray(batch["beamidx"]))
            scen_all.append(np.asarray(batch["scenario"]))
        loss_h, pred_all = self._read_back([torch.stack(losses),
                                            torch.cat(ranks)])
        loss_epoch = float(loss_h.mean())
        gt_all = np.concatenate(gt_all, 0)
        scen_all = np.concatenate(scen_all, 0)
        if pred_all.ndim == 3:
            mp, mg = flatten_multistep(pred_all, gt_all)
        else:
            mp, mg = pred_all, gt_all

        for s in SCENARIOS:
            mask = scen_all == s
            if mask.sum() > 0:
                ps, gs = pred_all[mask], gt_all[mask]
                if ps.ndim == 3:
                    ps, gs = flatten_multistep(ps, gs)
                acc_s = compute_acc(ps, gs)
                dba_s = compute_dba_score(ps, gs)
                print(f"{s} curr_acc: {acc_s} DBA_score: {dba_s:.4f}")
                self.logger.scalars(
                    "curr_acc_val",
                    {f"{s}beam{i}": a for i, a in enumerate(acc_s)},
                    self.cur_epoch)
                self.logger.scalar(f"DBA_score_val/{s}", dba_s,
                                   self.cur_epoch)

        acc = compute_acc(mp, mg)
        dba = compute_dba_score(mp, mg)
        print(f"Val top beam acc: {acc} DBA score: {dba:.4f}")
        self.logger.scalar("DBA_score_val/scenario_all", dba, self.cur_epoch)
        self.logger.scalar("curr_loss_val", loss_epoch, self.cur_epoch)
        self.val_loss.append(loss_epoch)
        self.DBA.append(dba)
        return dba

    def test(self, loader: Iterable[Dict], out_dir: str = ".") -> np.ndarray:
        """Test pass on the raw weights: writes beam_pred.csv (1-indexed
        top-1/2/3) and the softmax-confidence CSV into ``out_dir`` (rank 0;
        every rank runs the full split)."""
        if self.state is None:
            self.init_state()
        ranks, conf = [], []
        for i, (batch, dev, n, _) in enumerate(self._staged(loader)):
            m = self.test_step(dev, i)
            ranks.append(m["ranks"])
            conf.append(m["confidence"])
        pred_all, conf_all = self._read_back([torch.cat(ranks),
                                              torch.cat(conf)])
        if self._lead:
            save_pred_to_csv(pred_all, target_csv=os.path.join(
                out_dir, "beam_pred.csv"))
            save_confidence_to_csv(conf_all, target_csv=os.path.join(
                out_dir, "beam_pred_confidence_seq.csv"))
        return pred_all

    # -- checkpoint policy -------------------------------------------------------

    def save(self) -> None:
        """Per-epoch checkpoints with the best-model and rollback policy.
        Every rank takes the same decisions (the metrics are global); the
        writes are rank 0's (``train/checkpoints.py``)."""
        save_best = False
        if self.DBA and self.DBA[-1] >= self.bestval:
            self.bestval = self.DBA[-1]
            self.bestval_epoch = self.cur_epoch
            save_best = True

        state, logdir, aw = self.state, self.opts.logdir, self.opts.async_save
        if aw:
            ckpt.flush()    # land the previous epoch's writes (at most one
                            # epoch of checkpoints in flight)
        ckpt.save_model(logdir, "final_model", self.model, async_write=aw)
        ckpt.write_run_record(logdir, {
            "epoch": self.cur_epoch,
            "iter": self.cur_iter,
            "bestval": self.bestval,
            "bestval_epoch": self.bestval_epoch,
            "train_loss": self.train_loss,
            "val_loss": self.val_loss,
            "DBA": self.DBA,
        }, async_write=aw)
        if save_best:
            ckpt.save_model(logdir, "best_model", self.model, async_write=aw)
            ckpt.save_optim(logdir, "best_optim", state.optimizer, state.ema,
                            async_write=aw)
            print("====== Overwrote best model ======>")
        if not save_best and self.opts.load_previous_best:
            ckpt.flush()        # read after write: land pending saves
            distributed.barrier("rollback")     # rank 0's files landed
            ckpt.load_model(logdir, "best_model", self.model)
            # the live EMA shadow is not rolled back: only the model and the
            # optimizer return to the best epoch's, as in the JAX package
            ckpt.load_optim(logdir, "best_optim", state.optimizer)
            print("====== Load the previous best model ======>")

    def _save_finetune(self) -> None:
        """The all_finetune_on_final_* stream, keyed on train DBA."""
        aw = self.opts.async_save
        ckpt.save_model(self.opts.logdir, "all_finetune_on_final_model",
                        self.model, async_write=aw)
        ckpt.save_optim(self.opts.logdir, "all_finetune_on_final_optim",
                        self.state.optimizer, self.state.ema, async_write=aw)

    def resume(self) -> bool:
        """Restores the counters and histories from the logdir's run record
        (weights are loaded separately); True if there was one."""
        rec = ckpt.read_run_record(self.opts.logdir)
        if rec is None:
            return False
        self.cur_epoch = rec["epoch"]
        self.cur_iter = rec.get("iter", 0)
        self.bestval = rec["bestval"]
        self.bestval_epoch = rec.get("bestval_epoch", 0)
        self.train_loss = rec["train_loss"]
        self.val_loss = rec["val_loss"]
        self.DBA = rec["DBA"]
        return True

    def load_weights(self, name: str = "final_model",
                     logdir: Optional[str] = None) -> None:
        """Loads a model file into the model; the EMA shadow restarts from
        the loaded weights."""
        if self.state is None:
            self.init_state()
        ckpt.flush()                # land any pending async writes
        distributed.barrier("load_weights")     # rank 0's files landed
        ckpt.load_model(logdir or self.opts.logdir, name, self.model)
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                self.state.ema[n].copy_(p.detach())


def save_pred_to_csv(y_pred: np.ndarray, top_k=(1, 2, 3),
                     target_csv: str = "beam_pred.csv") -> None:
    """1-indexed top-k beams, one row per sample, after an index column."""
    if y_pred.ndim == 3:            # multi-step: flatten rows
        y_pred = y_pred.reshape(-1, y_pred.shape[-1])
    with open(target_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index"] + [f"top-{k} beam" for k in top_k])
        for i, row in enumerate(y_pred):
            w.writerow([i] + [int(row[k - 1]) + 1 for k in top_k])


def save_confidence_to_csv(conf: np.ndarray,
                           target_csv: str = "beam_pred_confidence_seq.csv"
                           ) -> None:
    with open(target_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "0"])
        for i, v in enumerate(conf.reshape(-1)):
            w.writerow([i, float(v)])
