"""End-to-end Engine benchmark (the JAX package's ``tools/bench_engine.py``):
cache -> loader -> prefetch -> pinned copy -> step.

Measures what ``Engine.train`` sustains with the loader's gather, the
prefetch thread, the pinned copy on the copy stream and the train step
together, beside the step alone on a batch already on the card: does the
input pipeline keep the card fed?  The data is ``build_synth_cache``'s
memmap cache (uint8 image and lidar, float16 or uint8 radar), read by
``CachedBatchLoader`` (compact batches, upcast on the card) or, with
``DEEPSENSE_BENCH_LOADER=classic``, ``DataLoader(CachedDataset)`` (float32).

    python -m deepsense6g_tii_tpu_torch.tools.bench_engine

Environment knobs: ``DEEPSENSE_BENCH_ARCH`` (gpt | mamba), ``_B`` (batch;
default 16 GPT, 8 Mamba on the card), ``_K`` (optimizer steps a dispatch;
the port runs them one after another), ``_GRAD_ACCUM``, ``_N`` (samples an
epoch, default 1024 on the card), ``_EPOCHS`` (timed epochs, default 2),
``_LOADER`` (fast | classic), ``_RADAR`` (float16 | uint8: the cache's
opt-in lossy radar storage), ``_RES`` (input resolution, default 256),
``_CACHE`` (the cache's directory, default under ``build/bench_engine``)
and ``DEEPSENSE_DEVICE`` (cuda, the default, raises without CUDA; cpu runs
f32 on the plain paths at B=1, N=8).

Prints ONE JSON line: ``value`` (end-to-end train samples/s a GPU),
``vs_baseline`` (against the reference GPU recipes' samples/s),
``loader_only_sps`` (the loader alone), ``batch_bytes`` and ``h2d_ms``
(one batch's copy from pinned memory, CUDA events), ``h2d_MBps``,
``transfer_bound_sps`` (the batch rate that copy allows),
``step_only_sps`` (the train step on a batch already on the card, measured
in the same run) and ``pct_of_step`` (end to end against it), and the
engine's ``data_wait_share``.  Off the card the device numbers are null.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch

from ..config import GlobalConfig
from ..data.cache import CachedBatchLoader, CachedDataset
from ..data.loader import DataLoader
from ..models.fuser import BeamFuser
from ..ops._build import build_dir
from ..train.engine import DEVICE_KEYS, Engine, TrainOptions
from ..utils.device import resolve_device
from ..utils.synth import build_synth_cache
from . import timing

# the reference GPU recipes' train samples/s (bench.py's BASELINES)
BASELINES = {"gpt": 4.98, "mamba": 2.85}
STEP_ONLY_STEPS = 10


def bench_config(arch: str, res: int, on_card: bool) -> GlobalConfig:
    """The full-width model of ``arch`` at input resolution ``res``, the
    anchors scaled with it (8x8 at 256): bf16 through the kernels on the
    card, f32 on the plain paths elsewhere."""
    fused = 0 if arch == "gpt" else 1
    return GlobalConfig(
        FFM=fused, TFM=fused, use_pallas_scan=on_card,
        use_flash_attention=on_card and arch == "gpt",
        compute_dtype="bfloat16" if on_card else "float32",
        input_resolution=res, vert_anchors=max(res // 32, 1),
        horz_anchors=max(res // 32, 1))


def run(cfg: GlobalConfig, B: int, N: int, epochs: int = 2, K: int = 1,
        grad_accum: int = 1, loader_kind: str = "fast",
        radar_dtype: str = "float16", cache_dir: str | None = None,
        device="cuda") -> dict:
    """Builds (or finds) the synthetic cache of ``N`` samples, then times
    the loader alone, one batch's copy, the step alone and ``epochs``
    engine epochs after a warm-up epoch; returns the JSON line's object."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if cache_dir is None:
        suffix = "_ru8" if radar_dtype == "uint8" else ""
        cache_dir = str(build_dir("bench_engine")
                        / f"cache_r{cfg.input_resolution}_n{N}{suffix}")
    t0 = time.perf_counter()
    build_synth_cache(cfg, N, cache_dir, radar_dtype=radar_dtype)
    print(f"cache: {cache_dir} ({N} samples, "
          f"{time.perf_counter() - t0:.1f}s)", file=sys.stderr)

    def make_loader():
        if loader_kind == "classic":
            return DataLoader(CachedDataset(cache_dir), B, shuffle=True,
                              num_workers=4, drop_last=True)
        return CachedBatchLoader(cache_dir, B, shuffle=True, drop_last=True)

    loader = make_loader()
    t0 = time.perf_counter()
    nb = sum(1 for _ in loader)
    loader_sps = nb * B / (time.perf_counter() - t0)

    one = next(iter(make_loader()))
    host = {k: one[k] for k in DEVICE_KEYS if k in one}
    batch_bytes = sum(v.nbytes for v in host.values())
    copy = timing.h2d(host, dev) if on_card else None

    with tempfile.TemporaryDirectory() as logdir:
        model = BeamFuser(cfg, device=dev,
                          generator=torch.Generator().manual_seed(0))
        opts = TrainOptions(logdir=logdir, epochs=epochs + 1, lr=1e-4,
                            scheduler=False, ema=True, steps_per_dispatch=K,
                            grad_accum=grad_accum, prefetch=2,
                            async_save=False)
        engine = Engine(model, cfg, opts, device=dev)
        engine.init_state()
        engine.train(loader)                    # warm-up epoch
        t0 = time.perf_counter()
        for _ in range(epochs):
            engine.train(loader)
        dt = time.perf_counter() - t0
        waits = [s["data_wait_share"] for s in engine.epoch_stats[1:]]

        step_sps = None
        if on_card:
            staged = {k: torch.from_numpy(v).to(dev)
                      for k, v in host.items()}
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            for _ in range(STEP_ONLY_STEPS):
                engine.train_step(staged, 1e-4)
            torch.cuda.synchronize(dev)
            step_sps = STEP_ONLY_STEPS * B / (time.perf_counter() - t1)

    # drop_last: every batch is full and every batch is trained
    sps = epochs * (N // B) * B / dt
    arch = "gpt" if cfg.FFM == 0 else "mamba"
    return {
        "metric": "engine e2e train samples/sec/gpu "
                  f"({'GPT TransFuser' if arch == 'gpt' else 'MambaFuser'}, "
                  f"bs {B}, {K} step(s)/dispatch, {loader_kind} loader, "
                  f"{N} samples/epoch)",
        "value": sps, "unit": "samples/sec/gpu",
        "vs_baseline": sps / BASELINES[arch],
        "loader_only_sps": loader_sps, "batch_bytes": batch_bytes,
        "h2d_dtypes": {k: str(v.dtype) for k, v in host.items()},
        "h2d_ms": copy["ms"] if copy else None,
        "h2d_MBps": batch_bytes / copy["ms"] / 1e3 if copy else None,
        "transfer_bound_sps": B / copy["ms"] * 1e3 if copy else None,
        "step_only_sps": step_sps,
        "pct_of_step": sps / step_sps if step_sps else None,
        "data_wait_share": waits,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu"}


def main() -> int:
    env = os.environ.get
    dev = resolve_device(env("DEEPSENSE_DEVICE", "cuda"))
    on_card = dev.type == "cuda"
    arch = env("DEEPSENSE_BENCH_ARCH", "gpt")
    if arch not in BASELINES:
        raise SystemExit(f"DEEPSENSE_BENCH_ARCH={arch!r}: gpt or mamba")
    default_b = (16 if arch == "gpt" else 8) if on_card else 1
    cfg = bench_config(arch, int(env("DEEPSENSE_BENCH_RES", "256")), on_card)
    if on_card:
        print(f"card: {timing.card()}", file=sys.stderr)
    out = run(cfg, B=int(env("DEEPSENSE_BENCH_B", default_b)),
              N=int(env("DEEPSENSE_BENCH_N", 1024 if on_card else 8)),
              epochs=int(env("DEEPSENSE_BENCH_EPOCHS", "2")),
              K=int(env("DEEPSENSE_BENCH_K", "1")),
              grad_accum=int(env("DEEPSENSE_BENCH_GRAD_ACCUM", "1")),
              loader_kind=env("DEEPSENSE_BENCH_LOADER", "fast"),
              radar_dtype=env("DEEPSENSE_BENCH_RADAR", "float16"),
              cache_dir=env("DEEPSENSE_BENCH_CACHE"), device=dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
