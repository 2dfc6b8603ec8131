"""Input-pipeline throughput benchmark (the JAX package's
``tools/bench_io.py``).

Writes a DeepSense-layout tree at realistic sizes (20k-point ascii LiDAR
clouds, 960x540 camera JPEGs, 256x256 radar maps, 5 frames a sample), then
measures samples/s through the port's data path for four readers:

- the decode path with the Python PLY parser (``DEEPSENSE_DISABLE_NATIVE``
  set), ``BeamDataset`` + ``DataLoader`` on threads;
- the same with the native C++ PLY/BEV loader (runtime/native.py);
- the memmap cache, ``DataLoader(CachedDataset)`` (float32 samples);
- ``CachedBatchLoader`` (one gather a modality a batch, storage dtypes).

On the card it also times one batch's copy from pinned memory to the card
(CUDA events) from the two cached readers: the compact storage dtypes
against float32.

    python -m deepsense6g_tii_tpu_torch.tools.bench_io [--samples 32] \\
        [--workers 8] [--batch_size 8] [--device cuda]

``--device`` defaults to ``cuda`` and raises without it; with ``--device
cpu`` the readers are timed and the copy is not measured.  The tree goes to
a temporary directory (``--root`` to keep it).  Prints a line a reader and
one JSON line.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import tempfile
import time

import numpy as np

from ..config import GlobalConfig
from ..data.cache import CachedBatchLoader, CachedDataset, build_cache
from ..data.dataset import BeamDataset
from ..data.loader import DataLoader
from ..runtime import native
from ..train.engine import DEVICE_KEYS
from ..utils import ply
from ..utils.device import resolve_device
from . import timing


def make_realistic_tree(root: str, n_samples: int, seq_len: int = 5,
                        seed: int = 0, points: int = 20000,
                        frame=(540, 960)) -> str:
    """A scenario32 tree under ``root`` (the JAX tool's layout and sizes);
    returns the index CSV's name."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    s = "scenario32"
    base = os.path.join(root, s, "unit1")
    for sub in ("camera_data", "lidar_data", "radar_data_ang",
                "radar_data_vel", "GPS_data"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    os.makedirs(os.path.join(root, s, "unit2", "GPS_data"), exist_ok=True)
    np.savetxt(os.path.join(base, "GPS_data", "gps_loc.txt"),
               [33.42, -111.93])

    header = ["index"]
    for t in range(1, seq_len + 1):
        header += [f"unit1_rgb_{t}", f"unit1_lidar_{t}", f"unit1_radar_{t}"]
    header += ["unit2_loc_1", "unit2_loc_2", "unit1_loc", "unit1_beam"]
    rows = []
    img = Image.fromarray(rng.integers(0, 255, (*frame, 3), dtype=np.uint8),
                          "RGB")
    for i in range(n_samples):
        row = [i]
        for t in range(1, seq_len + 1):
            fid = i * seq_len + t
            cam = f"./{s}/unit1/camera_data/{s}_{fid}.jpg"
            img.save(os.path.join(root, cam[2:]), quality=85)
            lid = f"./{s}/unit1/lidar_data/{fid}.ply"
            ply.write_points(os.path.join(root, lid[2:]),
                             rng.uniform(-60, 20, size=(points, 3)),
                             ascii=True)
            rad = f"./{s}/unit1/radar_data/{fid}.npy"
            for kind in ("ang", "vel"):
                np.save(os.path.join(base, f"radar_data_{kind}",
                                     f"{fid}.npy"),
                        rng.uniform(0, 1, (256, 256)).astype(np.float32))
            row += [cam, lid, rad]
        g1 = f"./{s}/unit2/GPS_data/{i}_1.txt"
        g2 = f"./{s}/unit2/GPS_data/{i}_2.txt"
        for g in (g1, g2):
            np.savetxt(os.path.join(root, g[2:]), [33.421, -111.929])
        row += [g1, g2, f"./{s}/unit1/GPS_data/gps_loc.txt", 31]
        rows.append(row)
    with open(os.path.join(root, "idx.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return "idx.csv"


def rate(loader) -> dict:
    """One pass over ``loader``: samples/s and ms a batch, and the first
    batch (kept for the copy's timing)."""
    n = batches = 0
    first = None
    t0 = time.perf_counter()
    for b in loader:
        first = b if first is None else first
        n += len(b["image"])
        batches += 1
    dt = time.perf_counter() - t0
    return {"samples_per_s": n / dt, "ms_per_batch": 1e3 * dt / batches,
            "samples": n, "s": dt}, first


def run(root: str, samples: int = 32, workers: int = 8, batch_size: int = 8,
        device="cuda", points: int = 20000, verbose: bool = True) -> dict:
    """Writes the tree under ``root`` and times the four readers (and, on
    the card, the cached batches' copies).  Returns the JSON line's
    object."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    ds = BeamDataset(root, make_realistic_tree(root, samples, points=points),
                     GlobalConfig())
    out = {"samples": samples, "batch_size": batch_size, "workers": workers,
           "tree_s": time.perf_counter() - t0,
           "native": native.available()}

    def report(label, res):
        out[label] = res
        if verbose:
            print(f"{label}: {res['samples_per_s']:.1f} samples/s, "
                  f"{res['ms_per_batch']:.1f} ms a batch of {batch_size}",
                  flush=True)

    def decode():
        return rate(DataLoader(ds, batch_size, num_workers=workers))[0]

    prev = os.environ.get("DEEPSENSE_DISABLE_NATIVE")
    os.environ["DEEPSENSE_DISABLE_NATIVE"] = "1"
    try:
        report("python_ply", decode())
    finally:
        if prev is None:
            del os.environ["DEEPSENSE_DISABLE_NATIVE"]
        else:
            os.environ["DEEPSENSE_DISABLE_NATIVE"] = prev
    native.reset_calls()
    report("native_ply", decode())
    out["native_clouds"] = native.CALLS.get("batch_ply_to_bev", 0)

    t0 = time.perf_counter()
    cache = build_cache(ds, os.path.join(root, "cache"), num_workers=workers)
    out["cache_build_s"] = time.perf_counter() - t0
    res, f32 = rate(DataLoader(CachedDataset(cache), batch_size,
                               shuffle=True, num_workers=workers))
    report("cached_dataset", res)
    res, compact = rate(CachedBatchLoader(cache, batch_size, shuffle=True))
    report("cached_batch_loader", res)
    if dev.type == "cuda":
        out["h2d"] = {name: timing.h2d({k: b[k] for k in DEVICE_KEYS
                                        if k in b}, dev)
                      for name, b in (("f32", f32), ("compact", compact))}
    else:
        out["h2d"] = None           # not measured off the card
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=32)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--root", default=None,
                    help="where to write the tree (default: a temporary "
                         "directory, removed after)")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    where = timing.card() if dev.type == "cuda" else "cpu"
    print(f"device: {where}")
    with tempfile.TemporaryDirectory() as tmp:
        root = a.root or tmp
        os.makedirs(root, exist_ok=True)
        out = run(root + "/", a.samples, a.workers, a.batch_size, dev)
    print(json.dumps({"device": where, **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
