"""Synthetic inputs shaped like the DeepSense 6G samples the models take.

Every value is exactly representable in the dtype the program's cache
stores it in (uint8 camera frames, LiDAR clip counts over 5, float16
radar maps, GPS and soft beam targets), so the program's compact batches
and the reference's float32 rows hold the same numbers.

Sample ``i`` of a pool depends only on (``data_seed``, ``i``), so the
reference regenerates any row it needs without reading what the program
wrote.  Each sample draws its own scene statistics (a camera frame's
brightness and contrast, the LiDAR's density, the radar's level), so that
rows differ as scenes do and the models' answers depend on the row.
"""

from __future__ import annotations

import json
import os

import numpy as np

KEYS = ("image", "lidar", "radar", "gps", "beam")
SCENARIOS = ("scenario31", "scenario32", "scenario33", "scenario34")


def _sensors(rng, shape_img, shape_lidar, shape_radar):
    """Camera, LiDAR and radar arrays of leading shape (n, T) with scene
    statistics drawn per row and frame."""
    lead = shape_img[:2]
    bright = rng.uniform(40.0, 215.0, lead)[..., None, None, None]
    contrast = rng.uniform(10.0, 60.0, lead)[..., None, None, None]
    image = np.clip(np.rint(bright + contrast * rng.standard_normal(
        shape_img, dtype=np.float32)), 0, 255).astype(np.uint8)
    density = rng.uniform(0.05, 0.6, lead)[..., None, None, None]
    lidar = rng.binomial(5, np.broadcast_to(density, shape_lidar))
    level = rng.uniform(0.2, 1.0, lead)[..., None, None, None]
    radar = rng.random(shape_radar, dtype=np.float32) * level
    return (image.astype(np.float32),
            lidar.astype(np.uint8).astype(np.float32) / np.float32(5.0),
            radar.astype(np.float32))


def sample(cfg: dict, data_seed: int, i: int) -> dict:
    """One sample as float32 arrays (NHWC, time leading) and its labels."""
    rng = np.random.default_rng([data_seed, i])
    T, H = cfg["seq_len"], cfg["input_resolution"]
    rc = 2 if cfg["add_velocity"] else 1
    f16 = lambda a: a.astype(np.float16).astype(np.float32)  # noqa: E731
    image, lidar, radar = _sensors(rng, (1, T, H, H, 3), (1, T, H, H, 1),
                                   (1, T, H, H, rc))
    return {
        "image": image[0],
        "lidar": lidar[0],
        "radar": f16(radar[0]),
        "gps": f16(rng.standard_normal((cfg["gps_len"], 2),
                                       dtype=np.float32)),
        "beam": f16(rng.random(cfg["num_beams"], dtype=np.float32)),
        "beamidx": np.int32(rng.integers(0, cfg["num_beams"])),
        "scenario": SCENARIOS[i % len(SCENARIOS)],
    }


def rows(cfg: dict, data_seed: int, index) -> dict:
    """The samples ``index`` stacked: float32 arrays by key."""
    samples = [sample(cfg, data_seed, int(i)) for i in index]
    return {k: np.stack([s[k] for s in samples]) for k in KEYS + ("beamidx",)}


class SynthDataset:
    """A dataset of ``n`` synthetic samples, as the program's cache builder
    reads one."""

    def __init__(self, cfg: dict, data_seed: int, n: int):
        self.cfg, self.data_seed, self.n = cfg, data_seed, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return sample(self.cfg, self.data_seed, i)


def pool_dir(root: str, cfg: dict, data_seed: int, n: int) -> str:
    """A fixed directory for the pool's cache, named by what fills it."""
    T, H = cfg["seq_len"], cfg["input_resolution"]
    rc = 2 if cfg["add_velocity"] else 1
    return os.path.join(root, f"pool2-T{T}-H{H}-r{rc}-g{cfg['gps_len']}-"
                        f"b{cfg['num_beams']}-s{data_seed}-n{n}")


def cache_complete(path: str) -> bool:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return "n" in json.load(f)
    except (OSError, ValueError):
        return False


def host_pool(cfg: dict, seed: int, n: int) -> dict:
    """``n`` rows of float32 request inputs made from ``seed``, as a client
    would hand them to the server (image, lidar, radar, gps)."""
    rng = np.random.default_rng([seed, 7])
    T, H = cfg["seq_len"], cfg["input_resolution"]
    rc = 2 if cfg["add_velocity"] else 1
    image, lidar, radar = _sensors(rng, (n, T, H, H, 3), (n, T, H, H, 1),
                                   (n, T, H, H, rc))
    return {"image": image, "lidar": lidar, "radar": radar,
            "gps": rng.standard_normal((n, cfg["gps_len"], 2),
                                       dtype=np.float32)}
