"""Offline radar preprocessing: raw ADC cubes -> min-max scaled range-angle
and range-velocity maps (``deepsense6g_tii_tpu/data/preprocess/radar.py``).

The original pipeline runs the FFT chain of each file in a 100-process
pool.  Here each chunk of 64 cubes is one batched ``radar_maps`` call
(``data/features.py``) on the card; the maps are written as float32 .npy
beside the raw directory, in ``radar_data_ang/`` and ``radar_data_vel/``.

    python -m deepsense6g_tii_tpu_torch.data.preprocess.radar \\
        ROOT/scenario32/unit1/radar_data [--batch_size 64] [--device cuda]

``--device`` defaults to ``cuda`` and raises without it; ``--device cpu``
runs the same FFTs on the host.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ...utils.device import resolve_device
from .. import features as F


def _to_device(cubes, device):
    """The cubes on ``device`` in the FFTs' dtype, cast on the host so that
    no 64-bit array crosses."""
    import torch
    a = np.asarray(cubes)
    a = a.astype(np.complex64 if np.iscomplexobj(a) else np.float32,
                 copy=False)
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        resolve_device(device))


def process_file(data: np.ndarray, fft_size: int = 256, device="cuda"):
    """One raw cube (n_rx, n_samples, n_chirps) -> (ra, rv) maps in [0, 1]."""
    return process_batch(data, fft_size, device)


def process_batch(cubes: np.ndarray, fft_size: int = 256, device="cuda"):
    """(N, n_rx, n_samples, n_chirps) -> two (N, n_samples, fft_size)
    arrays, one device call, each map scaled by its own cube's min and
    max (one cube without the leading axis gives maps without it)."""
    ra, rv = F.radar_maps(_to_device(cubes, device), fft_size)
    return ra.cpu().numpy(), rv.cpu().numpy()


def process_scenario(raw_dir: str, ang_dir: Optional[str] = None,
                     vel_dir: Optional[str] = None, batch_size: int = 64,
                     device="cuda") -> List[str]:
    """Processes every .npy cube in ``raw_dir`` into the radar_data_ang /
    radar_data_vel siblings; returns the file names written."""
    parent = os.path.dirname(raw_dir.rstrip("/"))
    ang_dir = ang_dir or os.path.join(parent, "radar_data_ang")
    vel_dir = vel_dir or os.path.join(parent, "radar_data_vel")
    dev = resolve_device(device)
    os.makedirs(ang_dir, exist_ok=True)
    os.makedirs(vel_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(raw_dir) if f.endswith(".npy"))
    written = []
    for i in range(0, len(files), batch_size):
        chunk = files[i:i + batch_size]
        cubes = np.stack([np.load(os.path.join(raw_dir, f)) for f in chunk])
        ra, rv = process_batch(cubes, device=dev)
        for f, a, v in zip(chunk, ra, rv):
            np.save(os.path.join(ang_dir, f), a)
            np.save(os.path.join(vel_dir, f), v)
            written.append(f)
    return written


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("raw_dir", help=".../unit1/radar_data directory")
    p.add_argument("--ang_dir", default=None)
    p.add_argument("--vel_dir", default=None)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    n = len(process_scenario(a.raw_dir, a.ang_dir, a.vel_dir, a.batch_size,
                             a.device))
    print(f"processed {n} radar cubes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
