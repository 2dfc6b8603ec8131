"""Feature functions of the data path: image normalisation on the device
(``deepsense6g_tii_tpu/data/features.py:233-242``) and the numpy versions
that ``BeamDataset`` runs on the host (own copies of
``deepsense6g_tii_tpu/data/features.py:39-60, 95-112, 147-213``): the
LiDAR BEV histogram, the radar maps, GPS normalisation and soft beam
targets.  torch is imported where it is used, so the data loader's
spawned workers, which run only the numpy functions, never import it.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np

from ..config import (DEFAULT_FOV, POS_MAX, POS_MIN, SCENARIO_ANGLE_OFFSET,
                      SCENARIO_FOV)
from ..utils import utm as _utm

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def _mean_std(device, dtype):
    """The constants on ``device``, made once (outside inference mode) so a
    request copies nothing to the card for them."""
    import torch
    with torch.inference_mode(False):
        return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
                torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def normalize_imagenet(x):
    """uint8-scale NHWC image -> ImageNet-normalised float (channel last)."""
    mean, std = _mean_std(x.device, x.dtype)
    return (x / 255.0 - mean) / std


# -- LiDAR BEV histogram ------------------------------------------------------

GRID = 256
HIST_MAX_PER_PIXEL = 5.0


def fov_for_address(address: str, custom_fov: bool
                    ) -> Tuple[float, float, float, float]:
    """Per-scenario field of view, chosen by a substring of the file path."""
    if custom_fov:
        for name, fov in SCENARIO_FOV:
            if name in address:
                return fov
    return DEFAULT_FOV


def lidar_to_bev_np(points: np.ndarray,
                    fov: Tuple[float, float, float, float] = DEFAULT_FOV
                    ) -> np.ndarray:
    """(N, >=2) points -> (1, 256, 256) BEV density map: np.histogramdd
    over linspace bins, clipped at 5 points a pixel, /5."""
    x_lo, x_hi, y_lo, y_hi = fov
    xbins = np.linspace(x_lo, x_hi, GRID + 1)
    ybins = np.linspace(y_lo, y_hi, GRID + 1)
    hist = np.histogramdd(points[..., :2], bins=(xbins, ybins))[0]
    hist[hist > HIST_MAX_PER_PIXEL] = HIST_MAX_PER_PIXEL
    return (hist / HIST_MAX_PER_PIXEL)[np.newaxis].astype(np.float32)


# -- radar FFT maps -------------------------------------------------------------

def range_angle_map_np(data: np.ndarray, fft_size: int = 256) -> np.ndarray:
    """Raw radar cube (n_rx, n_samples, n_chirps) -> (n_samples, fft_size)
    range-angle map."""
    data = np.fft.fft(data, axis=1)                 # range FFT
    data = data - np.mean(data, 2, keepdims=True)   # clutter removal
    data = np.fft.fft(data, fft_size, axis=0)       # angle FFT
    return np.abs(data).sum(axis=2).T               # sum over velocity


def range_velocity_map_np(data: np.ndarray, fft_size: int = 256
                          ) -> np.ndarray:
    """Raw radar cube (n_rx, n_samples, n_chirps) -> (n_samples, fft_size)
    range-velocity map."""
    data = np.fft.fft(data, axis=1)                 # range FFT
    data = np.fft.fft(data, fft_size, axis=2)       # velocity FFT
    return np.abs(data).sum(axis=0)                 # sum over antennas


def minmax_np(arr: np.ndarray) -> np.ndarray:
    return (arr - arr.min()) / (arr.max() - arr.min())


# -- GPS normalisation ----------------------------------------------------------

def normalize_loc_np(pos_ue: np.ndarray, pos_bs: np.ndarray,
                     scenarios: Sequence[str], angle_norm: bool
                     ) -> np.ndarray:
    """(N, 2, 2) UE [lat, lon] for the 2 GPS samples and (N, 2) BS [lat,
    lon] -> (N, 2, 2) float64: UTM offsets from the base station, min-max
    normalised, or with ``angle_norm`` the bearing in radians relative to
    the scenario's boresight (both columns of a sample hold it)."""
    n = pos_ue.shape[0]
    ue_stacked = np.vstack((pos_ue[:, 0, :], pos_ue[:, 1, :]))
    bs_stacked = np.vstack((pos_bs, pos_bs))
    pos_diff = (_utm.xy_from_latlong(ue_stacked)
                - _utm.xy_from_latlong(bs_stacked))

    if angle_norm:
        # L2 row-normalise (sklearn.preprocessing.normalize(axis=1))
        norms = np.linalg.norm(pos_diff, axis=1, keepdims=True)
        stacked = pos_diff / np.where(norms == 0, 1.0, norms)
    else:
        stacked = ((pos_diff - np.asarray(POS_MIN))
                   / (np.asarray(POS_MAX) - np.asarray(POS_MIN)))

    out = np.zeros((n, 2, 2))
    out[:, 0, :] = stacked[:n]
    out[:, 1, :] = stacked[n:]

    if angle_norm:
        # arctan, not arctan2, as the original pipeline does
        angle = np.arctan(out[..., 1] / out[..., 0]) / np.pi * 180
        offset = np.array([_scenario_offset(s) for s in scenarios])
        angle = angle - offset[:, None]
        angle[angle > 90] -= 180
        angle[angle < -90] += 180
        rad = angle / 180 * np.pi
        out[:, 0, 0] = rad[:, 0]
        out[:, 0, 1] = rad[:, 0]
        out[:, 1, 0] = rad[:, 1]
        out[:, 1, 1] = rad[:, 1]
    return out


def _scenario_offset(scenario: str) -> float:
    for name, off in SCENARIO_ANGLE_OFFSET.items():
        if name in scenario:
            return off
    return 0.0


# -- soft beam targets ----------------------------------------------------------

_NORM_CONST = 1.0 / (0.5 * math.sqrt(2.0 * math.pi))


def soft_beam_target_np(beamidx: int, num_beams: int = 64) -> np.ndarray:
    """Gaussian-smoothed target over beams: sigma 0.5, a window of +-5
    beams, x1.25."""
    x = np.arange(max(beamidx - 5, 0), min(beamidx + 5, num_beams - 1) + 1)
    y = _NORM_CONST * np.exp(-0.5 * ((x - beamidx) / 0.5) ** 2)
    beam = np.zeros((num_beams,))
    beam[x] = y * 1.25
    return beam
