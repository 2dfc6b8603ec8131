"""Serving traffic: the program's ``Predictor.predict`` in a closed loop with
one client.

The client sends requests back to back, each when the previous one has
returned, until ``--seconds`` have passed; the window ends when the last
request sent has returned.  Each request is timed from its send to when
``predict`` has handed back its host arrays.  Every seed gets the same
set of request sizes (``sizes_from``..``sizes_to`` rows, each once a block
of requests) in an order the seed draws: the sizes of a block are cut
into ``strata`` equal ranges and each run of ``strata`` requests takes one
size from each range, so that every stretch of the window holds the same
mix.  Each request takes its rows at a seed-drawn offset from a pool of
``pool_rows`` float32 host rows made at set-up.

Set-up makes the pool, the weights on the card (BatchNorm's running
statistics those of the reference's train-mode forward over the pool's
first ``calib_rows`` rows, as a served model's are of its data; that
forward is the benchmark's work and is left out of ``setup_s``), the
predictor with its buckets, and warms each bucket.  With ``--trace 1`` a
further ``trace_requests`` requests run back to back under the profiler
after the window.  After that the program is freed and the reference
computes, in float32, every row of a seed-drawn sample of the requests
finished in the window (the one with the most rows always among them), up
to ``check_rows`` rows.
"""

from __future__ import annotations

import gc
import itertools
import time

import numpy as np
import torch

from benchmark.core import compare, data, weights
from benchmark.core import trace as tr
from benchmark.core.spec import program_config
from benchmark.reference import counts
from benchmark.reference.model import BeamFuserReference

CHECK_BLOCK = 16


def requests(p: dict, seed: int):
    """Endless (rows, pool offset) pairs.  Each block of as many requests as
    there are sizes holds every size once, in an order the seed draws:
    every seed sends the same work, and so does every prefix up to a
    block."""
    rng = np.random.default_rng([seed, 3])
    span = np.arange(p["sizes_from"], p["sizes_to"] + 1)
    strata = p["strata"]
    if len(span) % strata:
        raise ValueError(f"{len(span)} sizes do not cut into {strata} "
                         f"strata")
    while True:
        ranges = span.reshape(strata, -1)
        ranges = np.stack([rng.permutation(r) for r in ranges], 1)
        for n in np.concatenate([rng.permutation(g) for g in ranges]):
            yield int(n), int(rng.integers(0, p["pool_rows"] - n + 1))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def drive(cell, args, t_start_process: float, hooks=None) -> dict:
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.serve import Predictor

    hooks = hooks or {}
    cfg, p = cell.config, cell.traffic
    dev = torch.device(args.device)
    seed = args.seed
    gcfg = program_config(cfg)
    phases = {"imports": time.perf_counter() - t_start_process}
    pool = data.host_pool(cfg, seed, p["pool_rows"])
    keys = ("image", "lidar", "radar", "gps")
    phases["pool"] = time.perf_counter() - t_start_process
    w = weights.make_weights(cfg, seed, dev)
    _sync(dev)
    t_calib = time.perf_counter()
    w = weights.calibrate_bn(cfg, w, {k: v[:p["calib_rows"]]
                                      for k, v in pool.items()}, dev)
    _sync(dev)
    calib_s = time.perf_counter() - t_calib
    phases["weights"] = time.perf_counter() - t_start_process
    model = BeamFuser(gcfg, device=dev)
    model.load_state_dict(w, strict=True)
    bn_stats = {k: v.cpu() for k, v in w.items() if "running_" in k}
    del w
    phases["model"] = time.perf_counter() - t_start_process
    pred = Predictor(model, gcfg, batch_buckets=tuple(p["buckets"]),
                     top_k=3, device=dev)
    if "wrap_predictor" in hooks:
        hooks["wrap_predictor"](pred)

    def rows(n, o):
        return [pool[k][o:o + n] for k in keys]

    for b in p["buckets"]:
        for _ in range(p["warmup_per_bucket"]):
            pred.predict(*rows(b, 0))
    _sync(dev)

    gen = requests(p, seed)
    t0 = time.perf_counter()
    setup_s = t0 - t_start_process - calib_s
    deadline = t0 + args.seconds
    sent, lat, outs = [], [], []
    while time.perf_counter() < deadline:
        n, o = next(gen)
        x = rows(n, o)
        t = time.perf_counter()
        idx, conf = pred.predict(*x)
        lat.append(time.perf_counter() - t)
        sent.append((n, o))
        outs.append((idx, conf))
    window_s = time.perf_counter() - t0
    n_req = len(sent)
    sizes = np.array([n for n, _ in sent])
    served_rows = int(sizes.sum())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    trace = None
    if args.trace:
        # the traced requests come after the window, drawn apart from it
        k = p["trace_requests"]
        traced = list(itertools.islice(requests(p, seed + 1), k))
        trace = tr.traced(lambda: [pred.predict(*rows(n, o))
                                   for n, o in traced], k, dev)
        trace.extra["buckets"] = [bucket_rows(p["buckets"], n)
                                  for n, _ in traced]

    del pred, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # the check: a seed-drawn sample of the finished requests
    t_check = time.perf_counter()
    rng = np.random.default_rng([seed, 4])
    longest = int(np.argmax(sizes))
    order = [longest] + [int(j) for j in rng.permutation(n_req)
                         if j != longest]
    picked, total = [], 0
    for j in order:
        if total + sizes[j] > p["check_rows"] and picked:
            break
        picked.append(j)
        total += int(sizes[j])
    ref = BeamFuserReference(cfg).to(dev).eval()
    ref.load_state_dict({**weights.make_weights(cfg, seed, dev),
                         **{k: v.to(dev) for k, v in bn_stats.items()}})
    rows_x = [np.concatenate([rows(*sent[j])[i] for j in picked])
              for i in range(len(keys))]
    logits = []
    with torch.no_grad():
        for s in range(0, total, CHECK_BLOCK):
            x = [torch.as_tensor(r[s:s + CHECK_BLOCK]).to(dev)
                 for r in rows_x]
            logits.append(ref(*x).double().cpu().numpy())
    top1 = np.concatenate([outs[j][0][:, 0] - 1 for j in picked])
    conf = np.concatenate([outs[j][1] for j in picked])
    logits = np.concatenate(logits)
    numbers = compare.serve_numbers(top1, conf, logits)
    srt = np.sort(logits, axis=1)
    std = logits.std(axis=1)
    lat_ms = np.asarray(lat) * 1e3
    return {
        "setup_s": setup_s,
        "end_to_end": {
            "serve_samples_per_s": served_rows / window_s,
            "serve_p90_ms": float(np.percentile(lat_ms, 90))},
        "counters": {
            "setup_phases_s": phases, "calibration_s": calib_s,
            "requests": n_req, "rows": served_rows, "window_s": window_s,
            "serve_p50_ms": float(np.percentile(lat_ms, 50)),
            "serve_p95_ms": float(np.percentile(lat_ms, 95)),
            "padded_rows": int(sum(bucket_rows(p["buckets"], int(n))
                                   for n in sizes)) - served_rows,
            "serve_flops": counts.forward_flops_per_sample(cfg) * served_rows,
            "checked_rows": total,
            "logit_std_median": float(np.median(std)),
            "top_margin_min": float(((srt[:, -1] - srt[:, -2]) / std).min()),
            "check_s": time.perf_counter() - t_check},
        "trace": trace,
        "checks": numbers,
        "readings": {"top1": top1.tolist(), "conf": conf.tolist(),
                     "reference_logits": logits.tolist()},
        "attempted": n_req,
        "failed": 0,
        "memory_peak_bytes": peak,
    }


def bucket_rows(buckets, n: int) -> int:
    """The rows a request of ``n`` computes: the smallest bucket that holds
    it, as ``Predictor`` pads."""
    for b in sorted(buckets):
        if n <= b:
            return b
    top = max(buckets)
    return -(-n // top) * top
