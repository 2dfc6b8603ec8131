"""Synthetic batches shaped like the dataset's output (NHWC, batch and time
leading), derived from the GlobalConfig, and a synthetic memmap cache.  Own
copy of ``deepsense6g_tii_tpu/utils/synth.py`` (numpy only): the same seed
gives the same arrays, and the same cache files, in both packages."""

from __future__ import annotations

import numpy as np


def make_synth_batch(cfg, B: int, seed: int = 0, with_labels: bool = True):
    """image (B, T, H, H, 3) float32 0..255; lidar (B, T, H, H, 1) 0..1;
    radar (B, T, H, H, 1|2) 0..1; gps (B, gps_len, 2); labels: soft ``beam``
    targets + integer ``beamidx`` (vector per sample when pred_len > 1)."""
    rng = np.random.default_rng(seed)
    T, H = cfg.seq_len, cfg.input_resolution
    rc = 2 if cfg.add_velocity else 1
    batch = {
        # integer-valued like decoded uint8 camera frames
        "image": rng.integers(0, 256, (B, T, H, H, 3)).astype(np.float32),
        # six-level clip-count/5 grid like real BEV maps
        "lidar": (rng.integers(0, 6, (B, T, H, H, 1)).astype(np.float32)
                  / np.float32(5.0)),
        "radar": rng.uniform(0, 1, (B, T, H, H, rc)).astype(np.float32),
        "gps": rng.normal(size=(B, cfg.gps_len, 2)).astype(np.float32),
    }
    if with_labels:
        nb, P = cfg.num_beams, cfg.pred_len
        if P > 1:
            batch["beam"] = rng.uniform(0, 1, (B, P, nb)).astype(np.float32)
            batch["beamidx"] = rng.integers(0, nb, (B, P)).astype(np.int32)
        else:
            batch["beam"] = rng.uniform(0, 1, (B, nb)).astype(np.float32)
            batch["beamidx"] = rng.integers(0, nb, (B,)).astype(np.int32)
    return batch


def build_synth_cache(cfg, n: int, cache_dir: str, seed: int = 0,
                      chunk: int = 64, radar_dtype: str = "float16") -> str:
    """Writes ``n`` synthetic samples straight into the data/cache.py memmap
    cache format (uint8 image and lidar, float16 or uint8 radar, beamidx,
    scenario and manifest), skipping the raw-tree decode.  Idempotent per
    directory.  Gives the engine benchmark (tools/bench_engine.py) a
    production-shaped on-disk dataset of arbitrary size in seconds."""
    import json
    import os

    from ..data.cache import CACHE_FORMAT_VERSION

    os.makedirs(cache_dir, exist_ok=True)
    manifest = os.path.join(cache_dir, "manifest.json")
    if os.path.exists(manifest):
        with open(manifest) as f:
            existing = json.load(f)
        want_radar = "uint8" if radar_dtype == "uint8" else "float16"
        if existing.get("format_version") == CACHE_FORMAT_VERSION \
                and existing.get("specs", {}).get("radar", {}).get(
                    "dtype") == want_radar \
                and existing.get("n") == n:
            return cache_dir
        # stale layout version / different radar storage / different size:
        # synthetic data is cheap — rebuild instead of silently serving it
        for fn in os.listdir(cache_dir):
            if fn.endswith((".npy", ".json")):
                os.remove(os.path.join(cache_dir, fn))

    keys = ("image", "lidar", "radar", "gps", "beam")
    first = make_synth_batch(cfg, 1, seed=seed)
    specs, mms, scales = {}, {}, {}
    for k in keys:
        # image rides the cache's exact-uint8 storage (data/cache.py):
        # half the f16 bytes on disk, in host copies, and over h2d;
        # lidar rides the scaled-uint8 clip-count storage (scale 5);
        # radar optionally the lossy fixed-point uint8 storage (scale 255)
        radar_u8 = k == "radar" and radar_dtype == "uint8"
        dt = np.uint8 if k in ("image", "lidar") or radar_u8 else np.float16
        scales[k] = 5.0 if k == "lidar" else (255.0 if radar_u8 else 1.0)
        shape = (n,) + first[k].shape[1:]
        specs[k] = {"shape": list(shape), "dtype": np.dtype(dt).name,
                    "scale": scales[k]}
        mms[k] = np.lib.format.open_memmap(
            os.path.join(cache_dir, f"{k}.npy"), mode="w+",
            dtype=dt, shape=shape)
    bi_shape = (n,) + first["beamidx"].shape[1:]
    beamidx = np.zeros(bi_shape, np.int32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        b = make_synth_batch(cfg, hi - lo, seed=seed + 1 + lo)
        for k in keys:
            mms[k][lo:hi] = (np.rint(b[k] * scales[k]).astype(np.uint8)
                             if scales[k] != 1.0
                             else b[k].astype(mms[k].dtype))
        beamidx[lo:hi] = b["beamidx"]
    for mm in mms.values():
        mm.flush()
    np.save(os.path.join(cache_dir, "beamidx.npy"), beamidx)
    rng = np.random.default_rng(seed)
    scen = rng.choice(["scenario31", "scenario32", "scenario33",
                       "scenario34"], size=n).tolist()
    with open(os.path.join(cache_dir, "scenario.json"), "w") as f:
        json.dump(scen, f)
    with open(manifest, "w") as f:
        json.dump({"n": n, "specs": specs, "has_labels": True,
                   "format_version": CACHE_FORMAT_VERSION}, f)
    return cache_dir
