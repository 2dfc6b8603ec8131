"""Serving latency and throughput bench (the JAX package's
``tools/bench_serve.py``).

Builds a ``Predictor`` on a full-width model with random weights from a
seed (serving speed does not depend on the weights) and reports, for each
batch bucket, the p50/p90 latency of one ``predict`` call, host to host,
and the samples/s at the p50; then the pipelined throughput at the largest
bucket: 40 forwards of the model queued on inputs already on the card, one
sync at the end.

    python -m deepsense6g_tii_tpu_torch.tools.bench_serve [--arch mamba|gpt]
        [--batches 1,8,16] [--iters 30] [--device cuda]

``--device`` defaults to ``cuda`` (bf16 through the hand-written kernels)
and raises without it; ``--device cpu`` serves in f32 on the plain paths,
as the JAX tool does off the TPU.  ``--exported`` adds the serving
artifact's leg at the largest bucket (``Predictor.export_artifact`` into
``build/serve/``, loaded back by ``ExportedPredictor`` in this process):
export and load seconds, the file's size, its top-1 and confidences
against the live ``Predictor`` on the same inputs, its p50/p90 and its
pipelined samples/s.  The last line is one JSON object, with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Sequence

import numpy as np
import torch

from ..config import GlobalConfig
from ..models.fuser import BeamFuser
from ..ops._build import build_dir
from ..serve import ExportedPredictor, Predictor, serving_config
from ..utils.device import resolve_device
from . import timing

ITERS = 30              # latency requests a bucket
PIPELINED_CALLS = 40
ARTIFACT_DIR = build_dir("serve")


def run(cfg: GlobalConfig, batches: Sequence[int], iters: int = ITERS,
        device="cuda", exported: bool = False) -> dict:
    """Latency per bucket and the pipelined throughput of ``cfg``'s model
    (seed-0 weights) served on ``device``, and with ``exported`` the
    artifact's leg (:func:`exported_leg`); returns the JSON line's
    object."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    batches = sorted(batches)
    model = BeamFuser(cfg, device=dev,
                      generator=torch.Generator().manual_seed(0))
    pred = Predictor(model, cfg, batch_buckets=tuple(batches), device=dev)
    out = {"arch": "mamba" if cfg.FFM else "gpt",
           "compute_dtype": cfg.compute_dtype,
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu"}
    for b in batches:
        r = pred.latency_benchmark(batch=b, iters=iters)
        r["samples_per_sec"] = b / (r["p50_ms"] / 1e3)
        out[f"b{b}"] = r
        print(f"batch {b}: p50 {r['p50_ms']:.3f} ms  p90 {r['p90_ms']:.3f} ms"
              f"  -> {r['samples_per_sec']:.2f} samples/s", flush=True)

    # steady state at the largest bucket: a window of forwards queued on
    # inputs already on the device, one sync at the end
    b = batches[-1]
    shapes = pred._input_shapes(b)
    rng = np.random.default_rng(0)
    host = (rng.uniform(0, 255, shapes[0]).astype(np.float32),
            *(np.zeros(s, np.float32) for s in shapes[1:]))
    pred.predict(*host)                                  # warm
    on_dev = [torch.from_numpy(a).to(dev) for a in host]
    dt = pipelined(pred.model, on_dev, pred._sync)
    out["pipelined"] = {"batch": b, "calls": PIPELINED_CALLS,
                        "samples_per_sec": b * PIPELINED_CALLS / dt,
                        "ms_per_call": 1e3 * dt / PIPELINED_CALLS}
    print(f"pipelined batch {b}: {out['pipelined']['samples_per_sec']:.2f} "
          f"samples/s", flush=True)
    if exported:
        out["exported"] = exported_leg(pred, host, iters, out["arch"])
    return out


def pipelined(fn, args, sync) -> float:
    """Seconds for PIPELINED_CALLS calls of ``fn(*args)`` queued on the
    device, one sync at the end."""
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        for _ in range(PIPELINED_CALLS):
            fn(*args)
        sync()
    return time.perf_counter() - t0


def exported_leg(pred: Predictor, host, iters: int, arch: str) -> dict:
    """The serving artifact at the batch of the host arrays ``host``:
    exported and saved under ARTIFACT_DIR, loaded back, held to the live
    predictor on ``host`` (top-1 equal, largest confidence error), then its
    p50/p90 of one ``ExportedPredictor.predict`` and its pipelined
    samples/s on inputs already on the device."""
    b = host[0].shape[0]
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    path = str(ARTIFACT_DIR / f"{arch}_b{b}.pt2")
    t0 = time.perf_counter()
    pred.export_artifact(path, batch_size=b)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ep = ExportedPredictor(path, device=pred.device)
    load_s = time.perf_counter() - t0
    beams, conf = pred.predict(*host)
    beams_x, conf_x = ep.predict(*host)
    ep.predict(*host)                                     # warm
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        ep.predict(*host)          # returns host arrays: synced
        times.append((time.perf_counter() - t0) * 1e3)
    on_dev = [torch.from_numpy(a).to(pred.device) for a in host]
    dt = pipelined(ep.forward, on_dev, pred._sync)
    out = {"path": path, "batch": b,
           "artifact_mb": os.path.getsize(path) / 1e6,
           "export_s": export_s, "load_s": load_s,
           "top1_match": bool(np.array_equal(beams[:, 0], beams_x[:, 0])),
           "conf_max_abs_err": float(np.abs(conf - conf_x).max()),
           "p50_ms": float(np.percentile(times, 50)),
           "p90_ms": float(np.percentile(times, 90)),
           "samples_per_sec": b * PIPELINED_CALLS / dt}
    print(f"exported batch {b}: top1_match={out['top1_match']} conf_err="
          f"{out['conf_max_abs_err']:.2e} p50 {out['p50_ms']:.3f} ms "
          f"pipelined {out['samples_per_sec']:.2f} samples/s", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="mamba", choices=["mamba", "gpt"])
    p.add_argument("--batches", default="1,8,16")
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--exported", action="store_true",
                   help="also the serving artifact (torch.export) at the "
                        "largest bucket, against the live predictor")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    on_card = dev.type == "cuda"
    fused = int(a.arch == "mamba")
    cfg = serving_config(FFM=fused, TFM=fused,
                         add_velocity=GlobalConfig().add_velocity,
                         on_card=on_card)
    card = timing.card() if on_card else None
    if card:
        print(f"card: {card}", file=sys.stderr)
    out = run(cfg, [int(x) for x in a.batches.split(",")], a.iters, dev,
              a.exported)
    print(json.dumps({**out, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
