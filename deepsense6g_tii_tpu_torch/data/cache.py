"""The pre-featurized array cache (own copy of ``deepsense6g_tii_tpu/data/
cache.py``, numpy only).

Decoding every JPEG, parsing every .ply and histogramming every cloud each
epoch binds the host (PERF.md section 5).  ``build_cache`` featurizes a
dataset once into memmaps on disk; ``CachedDataset`` serves float32 samples
by memmap slice, and ``CachedBatchLoader`` serves whole batches in the
storage dtypes (uint8 images, uint8 lidar clip counts, float16 or uint8
radar), which the train and eval steps upcast on the device
(``train/steps.py::upcast``).  The files equal the JAX package's byte for
byte for the same dataset, so a cache built by either package is read by
both.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
from typing import Dict

import numpy as np

from .features import HIST_MAX_PER_PIXEL

_MANIFEST = "manifest.json"

# Bumped whenever the on-disk layout of any modality changes (v2: exact-uint8
# image + scaled-uint8 lidar clip-count storage).  build_cache/build_synth_cache
# rebuild stale-version dirs instead of silently serving the old layout.
CACHE_FORMAT_VERSION = 2


class _QuantizeMismatch(ValueError):
    """A later sample broke the uint8 storage auto-selected from sample 0."""

    def __init__(self, key: str, msg: str):
        super().__init__(msg)
        self.key = key


def _uint8_exact(a: np.ndarray) -> bool:
    """True when ``a`` is exactly representable as uint8 (integral 0..255)."""
    return bool(a.size and a.min() >= 0 and a.max() <= 255
                and np.array_equal(a, np.trunc(a)))


def _quantize_exact(a: np.ndarray, scale: float):
    """``a`` as uint8 levels q with q/scale == a exactly, else None.

    LiDAR BEV maps are ``clip(hist, 5)/5`` (features.py:49-58) — six exact
    levels {0, 0.2, .., 1.0} — so counts = rint(a*5) reconstruct the float32
    map bit-exactly via a float32 division.  The round-trip check (not an
    integrality check: float32(0.2)*5 != 1.0) is what guarantees exactness;
    maps off the grid (e.g. the block-mean input_resolution shrink) fail it
    and keep float16 storage.
    """
    a = np.asarray(a, np.float32)
    if not a.size:
        return None
    q = np.rint(a * scale)
    if q.min() < 0 or q.max() > 255:
        return None
    if not np.array_equal(q.astype(np.float32) / np.float32(scale), a):
        return None
    return q.astype(np.uint8)


RADAR_UINT8_SCALE = 255.0


def build_cache(dataset, cache_dir: str, num_workers: int = 16,
                image_dtype: str | None = None,
                radar_dtype: str | None = None,
                lidar_dtype: str | None = None) -> str:
    """Featurizes ``dataset`` into ``cache_dir`` memmaps.  Idempotent.

    ``image_dtype``: storage dtype for the image modality — None (auto)
    stores uint8 when the first sample is exactly uint8-representable
    (camera frames, original and reference-augmented alike, are
    uint8-valued JPEG decodes), halving the biggest modality's disk,
    host-copy, and host->device bytes vs float16; value-exact either way
    (the train step upcasts on device, train/steps.py::upcast).
    Non-integral images (e.g. the block-mean input_resolution shrink)
    auto-fall back to float16.  Pass "float16" to force.

    LiDAR rides the same trick via a stored ``scale``: full-resolution BEV
    maps are clip-counts/5 on a six-level grid (features.py:49-58), stored
    as raw uint8 counts and divided back on device
    (train/steps.py::upcast) — half the float16 bytes, value-exact.

    ``radar_dtype="uint8"`` (opt-in, LOSSY): RA/RV maps are continuous
    minmax-normalized [0, 1] (features.py::radar_maps), so uint8 storage
    quantizes to round(v*255)/255 — absolute error <= 1/510 on top of the
    default float16 rounding (~2^-11 relative).  Halves the now-largest
    modality's bytes; worth it only when the input pipeline, not the chip,
    bounds training (e.g. a bandwidth-limited host link).  Default float16.

    ``lidar_dtype="float16"`` forces float16 lidar storage (disables the
    scaled-uint8 auto-selection).  In auto mode, if a later sample falls off
    the six-level grid after sample 0 committed the cache to uint8, the
    build transparently restarts with that modality forced to float16
    instead of failing.
    """
    # Validate dtype requests up front.  image/lidar uint8 storage is
    # AUTO-selected only (it requires sample-level exactness proofs); an
    # explicit "uint8" request could silently end up float16 through the
    # _QuantizeMismatch restart below, overriding the caller — reject it
    # instead.  Radar is the only modality with an opt-in (lossy) uint8.
    for name, val, allowed in (("image_dtype", image_dtype, ("float16",)),
                               ("lidar_dtype", lidar_dtype, ("float16",)),
                               ("radar_dtype", radar_dtype,
                                ("float16", "uint8"))):
        if val is not None and val not in allowed:
            raise ValueError(f"{name}={val!r} unsupported; expected None "
                             f"(auto) or one of {allowed}")
    os.makedirs(cache_dir, exist_ok=True)
    manifest_path = os.path.join(cache_dir, _MANIFEST)
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            existing = json.load(f)
        if existing.get("format_version") == CACHE_FORMAT_VERSION:
            # Lossy-vs-exact radar storage changes the values served — never
            # silently swap one for the other under an existing manifest.
            want_radar = "uint8" if radar_dtype == "uint8" else "float16"
            have_radar = existing.get("specs", {}).get(
                "radar", {}).get("dtype", "float16")
            if "radar" in existing.get("specs", {}) \
                    and have_radar != want_radar:
                raise ValueError(
                    f"cache at {cache_dir} was built with radar dtype "
                    f"{have_radar!r} but radar_dtype={radar_dtype!r} was "
                    "requested; delete the cache dir or pass the matching "
                    "radar_dtype")
            return cache_dir
        # stale on-disk layout from an older framework revision: rebuild
        for fn in os.listdir(cache_dir):
            if fn.endswith((".npy", ".json")):
                os.remove(os.path.join(cache_dir, fn))

    n = len(dataset)
    first = dataset[0]
    specs = {}
    mms = {}
    scales = {}
    for k in ("image", "lidar", "radar", "gps", "beam"):
        if k in first:
            dt = np.float16
            scale = 1.0
            if k == "image" and image_dtype is None \
                    and _uint8_exact(np.asarray(first[k])):
                dt = np.uint8
            elif k == "image" and image_dtype is not None:
                dt = np.dtype(image_dtype)
            elif k == "lidar" and lidar_dtype is None and _quantize_exact(
                    first[k], HIST_MAX_PER_PIXEL) is not None:
                dt = np.uint8
                scale = float(HIST_MAX_PER_PIXEL)
            elif k == "lidar" and lidar_dtype is not None:
                dt = np.dtype(lidar_dtype)
            elif k == "radar" and radar_dtype == "uint8":
                dt = np.uint8
                scale = RADAR_UINT8_SCALE
            shape = (n,) + np.asarray(first[k]).shape
            specs[k] = {"shape": list(shape), "dtype": np.dtype(dt).name,
                        "scale": scale}
            scales[k] = scale
            mms[k] = np.lib.format.open_memmap(
                os.path.join(cache_dir, f"{k}.npy"), mode="w+",
                dtype=dt, shape=shape)
    has_labels = "beamidx" in first
    # (n,) for single-step labels, (n, pred_len) for the 30to5 variant
    # (data2_seq_30to5.py:160-172 emits pred_len beam indices per sample)
    beamidx = (np.zeros((n,) + np.asarray(first["beamidx"]).shape, np.int32)
               if has_labels else None)
    scenarios = [""] * n

    def work(i):
        s = dataset[i]
        for k, mm in mms.items():
            v = np.asarray(s[k])
            if k == "radar" and mm.dtype == np.uint8:
                # opt-in lossy fixed-point storage of the [0, 1] maps
                mm[i] = np.rint(np.clip(v, 0.0, 1.0)
                                * scales[k]).astype(np.uint8)
                continue
            if mm.dtype == np.uint8 and scales[k] != 1.0:
                q = _quantize_exact(v, scales[k])
                if q is None:
                    raise _QuantizeMismatch(
                        k,
                        f"sample {i}'s {k} is not exactly uint8-quantizable "
                        f"at scale {scales[k]} but the cache auto-selected "
                        "uint8 from sample 0")
                mm[i] = q
                continue
            if mm.dtype == np.uint8 and not _uint8_exact(v):
                raise _QuantizeMismatch(
                    k,
                    f"sample {i}'s {k} is not uint8-exact but the cache "
                    "auto-selected uint8 from sample 0")
            mm[i] = v.astype(mm.dtype)
        if has_labels:
            beamidx[i] = s["beamidx"]
        scenarios[i] = s.get("scenario", "")

    try:
        with cf.ThreadPoolExecutor(num_workers) as pool:
            list(pool.map(work, range(n)))
    except _QuantizeMismatch as e:
        # a later sample broke the uint8 storage auto-selected from sample
        # 0: transparently restart with that modality forced to float16
        # (only auto-selected modalities can land here — explicit overrides
        # never take the uint8 branch)
        mms.clear()          # drop memmap refs before unlinking their files
        for fn in os.listdir(cache_dir):
            if fn.endswith((".npy", ".json")):
                os.remove(os.path.join(cache_dir, fn))
        return build_cache(
            dataset, cache_dir, num_workers=num_workers,
            image_dtype=("float16" if e.key == "image" else image_dtype),
            radar_dtype=radar_dtype,
            lidar_dtype=("float16" if e.key == "lidar" else lidar_dtype))
    for mm in mms.values():
        mm.flush()

    if has_labels:
        np.save(os.path.join(cache_dir, "beamidx.npy"), beamidx)
    with open(os.path.join(cache_dir, "scenario.json"), "w") as f:
        json.dump(scenarios, f)
    with open(manifest_path, "w") as f:
        json.dump({"n": n, "specs": specs, "has_labels": has_labels,
                   "format_version": CACHE_FORMAT_VERSION}, f)
    return cache_dir


class CachedBatchLoader:
    """Batch iterator straight from the memmap cache — the production hot
    path for epochs after the first.

    ``DataLoader(CachedDataset(dir))`` costs three host copies per sample
    (memmap row -> float32 convert -> collate re-stack) plus a thread-pool
    round-trip; on a host with few cores that chain, not the device, bounds
    training throughput.  This loader does ONE fancy-index gather per
    modality per batch and keeps the cache's storage dtype (float16; uint8
    for uint8-exact imagery), so host memory traffic AND the host->device
    transfer are a third or less of the classic path's bytes.  The train
    and eval steps upcast to float32 on the device (train/steps.py), which
    is value-exact, so the trajectory is the host-upcast batch's (held bit
    for bit by tests/test_torch_cache.py).

    Shuffle order matches ``DataLoader(shuffle=True)`` with the same seed
    (same per-epoch permutation), so the two paths are interchangeable
    mid-run.  Reference analog: the 8-worker torch DataLoader that
    re-decodes JPEG/PLY every epoch (train2_seq.py:531-533).
    """

    def __init__(self, cache_dir: str, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 100):
        with open(os.path.join(cache_dir, _MANIFEST)) as f:
            m = json.load(f)
        self.n = m["n"]
        self.has_labels = m["has_labels"]
        self.arrays: Dict[str, np.ndarray] = {
            k: np.load(os.path.join(cache_dir, f"{k}.npy"), mmap_mode="r")
            for k in m["specs"]}
        self.scales = {k: float(s.get("scale", 1.0))
                       for k, s in m["specs"].items()}
        # Scaled-uint8 modalities ship raw over h2d only when the step
        # knows the convention (uint8 lidar == BEV counts /5, uint8 radar
        # == fixed-point /255, steps.py::upcast); anything else dequantizes
        # host-side.
        self._raw_ok = {
            k for k, s in self.scales.items()
            if s == 1.0 or (k == "lidar" and s == float(HIST_MAX_PER_PIXEL))
            or (k == "radar" and s == RADAR_UINT8_SCALE)}
        if self.has_labels:
            self.beamidx = np.load(os.path.join(cache_dir, "beamidx.npy"))
        with open(os.path.join(cache_dir, "scenario.json")) as f:
            self.scenarios = np.asarray(json.load(f))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        self.epoch += 1
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            out = {k: (v[sel] if k in self._raw_ok
                       else v[sel].astype(np.float32)
                       / np.float32(self.scales[k]))
                   for k, v in self.arrays.items()}
            out["scenario"] = self.scenarios[sel]
            if self.has_labels:
                out["beamidx"] = self.beamidx[sel]
            yield out


class CachedDataset:
    """Serves pre-featurized samples from the memmap cache (float32 out)."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, _MANIFEST)) as f:
            m = json.load(f)
        self.n = m["n"]
        self.has_labels = m["has_labels"]
        self.arrays: Dict[str, np.ndarray] = {
            k: np.load(os.path.join(cache_dir, f"{k}.npy"), mmap_mode="r")
            for k in m["specs"]}
        self.scales = {k: np.float32(s.get("scale", 1.0))
                       for k, s in m["specs"].items()}
        if self.has_labels:
            self.beamidx = np.load(os.path.join(cache_dir, "beamidx.npy"))
        with open(os.path.join(cache_dir, "scenario.json")) as f:
            self.scenarios = json.load(f)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict:
        out = {k: (np.asarray(v[i], dtype=np.float32) if self.scales[k] == 1
                   else np.asarray(v[i], np.float32) / self.scales[k])
               for k, v in self.arrays.items()}
        out["scenario"] = self.scenarios[i]
        if self.has_labels:
            bi = self.beamidx[i]
            out["beamidx"] = (np.asarray(bi, np.int32) if bi.ndim
                              else np.int32(bi))
        return out
