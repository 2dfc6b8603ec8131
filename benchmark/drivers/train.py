"""Training traffic: the program's ``Engine.train`` over its
``CachedBatchLoader`` (shuffled, full batches of ``batch`` rows from a
pool of ``pool`` synthetic samples written once per checkout through the
program's ``build_cache``), dropouts as configured, the focal loss on
soft targets, AdamW and the EMA, at a fixed learning rate.

Set-up builds the engine once and trains its first ``CHECK_STEPS`` steps,
one epoch of one batch each, through the window's own call and feed, on
rows that all differ; their losses, the first step's top beam of each
row, the first gradient (AdamW's first moment after one step, over 1 -
beta1) and each leaf's change after the last are kept for the check.  The window then runs ``Engine.train`` on the
same engine and feed until ``--seconds`` have passed (the loader stops
handing out batches at the deadline).  With ``--trace 1`` a further
``trace_steps`` steps run under the profiler after the window.  After
that the program is freed and the reference trains the same rows from
the same weights with the same dropout draws.
"""

from __future__ import annotations

import gc
import itertools
import os
import tempfile
import time

import numpy as np
import torch

from benchmark.core import compare, data, weights
from benchmark.core import trace as tr
from benchmark.core.spec import ROOT, program_config
from benchmark.reference import counts
from benchmark.reference.train import run_steps

CHECK_STEPS = 3
BETA1 = 0.9


class Feed:
    """Endless batches of the program's cached loader, one epoch after
    another, with the pool rows of each batch (``log``): the loader's own
    shuffle, replayed and checked against the labels it hands out."""

    def __init__(self, loader):
        self.loader, self.log = loader, []

    def __iter__(self):
        ld = self.loader
        while True:
            batches = iter(ld)
            first = next(batches)          # the loader counts its epoch here
            perm = np.arange(ld.n)
            if ld.shuffle:
                np.random.default_rng(ld.seed + ld.epoch).shuffle(perm)
            for b, batch in enumerate(itertools.chain([first], batches)):
                sel = perm[b * ld.batch_size:(b + 1) * ld.batch_size]
                if not np.array_equal(batch["beamidx"], ld.beamidx[sel]):
                    raise RuntimeError("the loader's order is not the one "
                                       "replayed")
                self.log.append(sel)
                yield batch


class UntilDeadline:
    """Batches from ``gen`` while the clock is before ``deadline``."""

    def __init__(self, gen, deadline: float):
        self.gen, self.deadline = gen, deadline

    def __iter__(self):
        while time.perf_counter() < self.deadline:
            yield next(self.gen)


def run_seeds(seed: int):
    """The program's dropout seed and the loader's shuffle seed of a run."""
    return tuple(int(np.random.SeedSequence([seed, k]).generate_state(1)[0])
                 for k in (1, 2))


def first_rows(p: dict, shuffle_seed: int, k: int):
    """The pool rows of a run's first ``k`` batches: the loader's shuffle,
    epoch after epoch, as ``Feed`` replays it."""
    out, epoch = [], 0
    while len(out) < k:
        epoch += 1
        perm = np.arange(p["pool"])
        np.random.default_rng(shuffle_seed + epoch).shuffle(perm)
        out += [perm[b:b + p["batch"]] for b in range(0, p["pool"], p["batch"])]
    return out[:k]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pool_cache(cfg: dict, p: dict) -> str:
    """The pool's cache directory, built through the program's
    ``build_cache`` when this checkout has none yet."""
    from deepsense6g_tii_tpu_torch.data.cache import build_cache
    path = data.pool_dir(os.path.join(ROOT, "build", "benchmark"), cfg,
                         p["data_seed"], p["pool"])
    if not data.cache_complete(path):
        build_cache(data.SynthDataset(cfg, p["data_seed"], p["pool"]), path,
                    num_workers=4)
    return path


def drive(cell, args, t_start_process: float, hooks=None) -> dict:
    from deepsense6g_tii_tpu_torch.data.cache import CachedBatchLoader
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.train.engine import Engine, TrainOptions

    hooks = hooks or {}
    cfg, p = cell.config, cell.traffic
    dev = torch.device(args.device)
    seed = args.seed
    rng_seed, shuffle_seed = run_seeds(seed)
    phases = {"imports": time.perf_counter() - t_start_process}
    path = pool_cache(cfg, p)
    phases["pool"] = time.perf_counter() - t_start_process

    model = BeamFuser(program_config(cfg), device=dev)
    w = weights.make_weights(cfg, seed, dev)
    model.load_state_dict(w, strict=True)
    phases["model"] = time.perf_counter() - t_start_process
    logs = tempfile.TemporaryDirectory(prefix="bench-train-")
    opts = TrainOptions(logdir=logs.name, epochs=1, lr=p["lr"],
                        scheduler=False, ema=True, seed=rng_seed,
                        prefetch=p["prefetch"], async_save=False)
    engine = Engine(model, program_config(cfg), opts, device=dev)
    engine.init_state()
    if "wrap_engine" in hooks:
        hooks["wrap_engine"](engine)
    loader = CachedBatchLoader(path, batch_size=p["batch"], shuffle=True,
                               seed=shuffle_seed)
    feed = Feed(loader)
    gen = iter(feed)

    # the checked steps: one epoch of one batch each, on the window's path;
    # the first step's beam ranks are kept as it hands them out
    losses, grad_norms, first = [], {}, {}
    named = list(model.named_parameters())
    step = engine.train_step

    def recording(batch, lr):
        m = step(batch, lr)
        first.setdefault("ranks", m["ranks"])
        return m

    engine.train_step = recording
    for s in range(CHECK_STEPS):
        engine.train(itertools.islice(gen, 1))
        losses.append(float(engine.train_loss[-1]))
        if s == 0:
            opt_state = engine.state.optimizer.state
            grad_norms = {
                n: ((opt_state[q]["exp_avg"] / (1 - BETA1)).double().norm()
                    .item() if q in opt_state else 0.0)
                for n, q in named}
    with torch.no_grad():
        change_norms = {n: (q.detach() - w[n]).double().norm().item()
                        for n, q in named}
    engine.train_step = step
    top1 = first["ranks"][:, 0].cpu().numpy()
    del w
    checked_rows = [np.asarray(s) for s in feed.log[:CHECK_STEPS]]
    phases["checked_steps"] = time.perf_counter() - t_start_process
    if p.get("warmup_steps", 0):
        engine.train(itertools.islice(gen, p["warmup_steps"]))

    # the window
    _sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - t_start_process
    n_before = len(feed.log)
    engine.train(UntilDeadline(gen, t0 + args.seconds))
    _sync(dev)
    window_s = time.perf_counter() - t0
    steps = len(feed.log) - n_before
    stats = dict(engine.epoch_stats[-1])
    samples = stats["samples"]
    window_loss = float(engine.train_loss[-1])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    trace = None
    if args.trace:
        k = p["trace_steps"]
        trace = tr.traced(lambda: engine.train(itertools.islice(gen, k)),
                           k, dev)
        trace.extra["batch"] = p["batch"]

    # the program's state is freed before the reference runs
    del engine, model, named, loader, feed, gen
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    logs.cleanup()
    t_check = time.perf_counter()
    ref = run_steps(cfg, weights.make_weights(cfg, seed, dev),
                    [data.rows(cfg, p["data_seed"], r) for r in checked_rows],
                    rng_seed, p["lr"], dev)
    numbers = compare.train_numbers(
        {"losses": losses, "grad_norms": grad_norms,
         "change_norms": change_norms, "top1": top1}, ref)
    flops = counts.train_flops_per_sample(cfg)
    return {
        "setup_s": setup_s,
        "end_to_end": {"train_samples_per_s": samples / window_s},
        "counters": {"setup_phases_s": phases, "samples": samples, "steps": steps,
                     "window_s": window_s,
                     "data_wait_share": stats["data_wait_share"],
                     "train_flops": flops * samples,
                     "batch": p["batch"], "check_s":
                     time.perf_counter() - t_check,
                     "losses": losses, "reference_losses": ref["losses"],
                     "worst_grad_leaves": compare.worst_leaves(
                         grad_norms, ref["grad_norms"], ref["grad_norms"]),
                     "worst_change_leaves": compare.worst_leaves(
                         change_norms, ref["change_norms"],
                         ref["change_norms"])},
        "trace": trace,
        "checks": numbers,
        "readings": {"losses": losses, "grad_norms": grad_norms,
                     "change_norms": change_norms, "top1": top1.tolist(),
                     "reference": ref},
        "attempted": steps,
        "failed": 0 if np.isfinite(window_loss) else steps,
        "memory_peak_bytes": peak,
    }
