"""Synthetic batches shaped like the dataset's output (NHWC, batch and time
leading), derived from the GlobalConfig.  Own copy of
``deepsense6g_tii_tpu/utils/synth.py:13-43`` (numpy only): the same seed
gives the same arrays in both packages."""

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
