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
as the JAX tool does off the TPU.  ``--exported`` (the serving artifact)
waits for the port's export (ROADMAP.md Queue 1 item 8) and raises.  The
last line is one JSON object, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Sequence

import numpy as np
import torch

from ..config import GlobalConfig
from ..models.fuser import BeamFuser
from ..serve import Predictor, serving_config
from ..utils.device import resolve_device
from . import timing

ITERS = 30              # latency requests a bucket
PIPELINED_CALLS = 40


def run(cfg: GlobalConfig, batches: Sequence[int], iters: int = ITERS,
        device="cuda") -> dict:
    """Latency per bucket and the pipelined throughput of ``cfg``'s model
    (seed-0 weights) served on ``device``; returns the JSON line's
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
    with torch.inference_mode():
        pred._sync()
        t0 = time.perf_counter()
        for _ in range(PIPELINED_CALLS):
            pred.model(*on_dev)
        pred._sync()
        dt = time.perf_counter() - t0
    out["pipelined"] = {"batch": b, "calls": PIPELINED_CALLS,
                        "samples_per_sec": b * PIPELINED_CALLS / dt,
                        "ms_per_call": 1e3 * dt / PIPELINED_CALLS}
    print(f"pipelined batch {b}: {out['pipelined']['samples_per_sec']:.2f} "
          f"samples/s", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="mamba", choices=["mamba", "gpt"])
    p.add_argument("--batches", default="1,8,16")
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--exported", action="store_true",
                   help="the exported serving artifact: not in the port yet "
                        "(raises)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    if a.exported:
        raise NotImplementedError(
            "--exported: the serving artifact (torch.export with the kernels "
            "as torch.library custom ops) is ROADMAP.md Queue 1 item 8, not "
            "in the PyTorch port yet")
    dev = resolve_device(a.device)
    on_card = dev.type == "cuda"
    fused = int(a.arch == "mamba")
    cfg = serving_config(FFM=fused, TFM=fused,
                         add_velocity=GlobalConfig().add_velocity,
                         on_card=on_card)
    card = timing.card() if on_card else None
    if card:
        print(f"card: {card}", file=sys.stderr)
    out = run(cfg, [int(x) for x in a.batches.split(",")], a.iters, dev)
    print(json.dumps({**out, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
