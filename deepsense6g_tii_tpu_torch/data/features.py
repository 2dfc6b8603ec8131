"""Feature functions of the data path, in two forms (own copies of
``deepsense6g_tii_tpu/data/features.py``):

* the numpy versions that ``BeamDataset`` runs on the host (``:39-60,
  95-112, 147-213``): the LiDAR BEV histogram, the radar maps, GPS
  normalisation and soft beam targets;
* the tensor versions that run where their input lies, on the card for the
  offline tools (``:61-93, 114-144, 214-260``): image normalisation, the
  static-shape BEV histogram of padded points, the radar FFT maps of one
  cube or a batch (``data/preprocess/radar.py``), soft beam targets and the
  horizontal flips.

torch is imported where it is used, so the data loader's spawned workers,
which run only the numpy functions, never import it.
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


def lidar_to_bev(points, mask, fov):
    """Static-shape BEV histogram of a padded cloud: ``points`` (P, 2+),
    ``mask`` (P,) > 0 for real points, ``fov`` (x_lo, x_hi, y_lo, y_hi) ->
    (1, 256, 256) float32 on the points' device.

    The bin of a point is ``floor((x - x_lo) / (x_hi - x_lo) * GRID)`` in
    f32, in that order (another order moves points across bin edges); the
    right edge is inclusive, as in np.histogramdd.  The counts are integers
    (``bincount``), so the map is the same on every device and every run."""
    import torch
    pts = torch.as_tensor(points)
    dev = pts.device
    pts = pts.to(torch.float32)
    lo_hi = torch.as_tensor(fov, dtype=torch.float32, device=dev)
    x_lo, x_hi, y_lo, y_hi = lo_hi[0], lo_hi[1], lo_hi[2], lo_hi[3]
    x, y = pts[:, 0], pts[:, 1]
    ix = torch.floor((x - x_lo) / (x_hi - x_lo) * GRID).to(torch.int64)
    iy = torch.floor((y - y_lo) / (y_hi - y_lo) * GRID).to(torch.int64)
    ix = torch.where(x == x_hi, GRID - 1, ix)
    iy = torch.where(y == y_hi, GRID - 1, iy)
    valid = ((torch.as_tensor(mask, device=dev) > 0) & (x >= x_lo)
             & (x <= x_hi) & (y >= y_lo) & (y <= y_hi))
    # the slot GRID * GRID, and any beyond it, is dropped
    flat = torch.where(valid, ix * GRID + iy, GRID * GRID)
    counts = torch.bincount(flat, minlength=GRID * GRID + 1)
    hist = counts[:GRID * GRID].reshape(GRID, GRID).to(torch.float32)
    # a 0-d tensor divisor: CUDA turns division by a Python number into a
    # product with its reciprocal
    cap = torch.tensor(HIST_MAX_PER_PIXEL, dtype=torch.float32, device=dev)
    return (torch.minimum(hist, cap) / cap)[None]


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


def _range_fft(data):
    """The range FFT of raw cube(s) (..., n_rx, n_samples, n_chirps): real
    input as float32, complex input as complex64 (the JAX package's dtypes,
    64-bit types off)."""
    import torch
    t = torch.as_tensor(data)
    t = t.to(torch.complex64 if t.is_complex() else torch.float32)
    return torch.fft.fft(t, dim=-2)


def _angle_map(rng, fft_size):
    import torch
    rng = rng - rng.mean(-1, keepdim=True)                  # clutter removal
    ra = torch.fft.fft(rng, fft_size, dim=-3)               # angle FFT
    return ra.abs().sum(-1).transpose(-1, -2)               # sum over chirps


def _velocity_map(rng, fft_size):
    import torch
    rv = torch.fft.fft(rng, fft_size, dim=-1)               # velocity FFT
    return rv.abs().sum(-3)                                 # sum over antennas


def range_angle_map(data, fft_size: int = 256):
    """Raw cube(s) (..., n_rx, n_samples, n_chirps) -> (..., n_samples,
    fft_size) range-angle map(s); the angle FFT zero-pads or truncates the
    antennas to ``fft_size``."""
    return _angle_map(_range_fft(data), fft_size)


def range_velocity_map(data, fft_size: int = 256):
    """Raw cube(s) (..., n_rx, n_samples, n_chirps) -> (..., n_samples,
    fft_size) range-velocity map(s)."""
    return _velocity_map(_range_fft(data), fft_size)


def minmax(arr):
    """Each map of ``arr`` (..., H, W) scaled to [0, 1] by its own min and
    max (per cube, never over the batch)."""
    lo = arr.amin(dim=(-2, -1), keepdim=True)
    hi = arr.amax(dim=(-2, -1), keepdim=True)
    return (arr - lo) / (hi - lo)


def radar_maps(data, fft_size: int = 256):
    """One raw cube (n_rx, n_samples, n_chirps) or a batch (N, n_rx,
    n_samples, n_chirps) -> the min-max scaled range-angle and
    range-velocity maps, each (..., n_samples, fft_size), from one range
    FFT: a batch is one device call in place of the original pipeline's
    process pool."""
    rng = _range_fft(data)
    return (minmax(_angle_map(rng, fft_size)),
            minmax(_velocity_map(rng, fft_size)))


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


def soft_beam_target(beamidx, num_beams: int = 64):
    """Batched version of :func:`soft_beam_target_np`: integer ``beamidx``
    (...,) -> (..., num_beams) float32 on its device."""
    import torch
    idx = torch.as_tensor(beamidx)
    beams = torch.arange(num_beams, dtype=torch.float32, device=idx.device)
    d = beams - idx[..., None].to(torch.float32)
    pdf = _NORM_CONST * torch.exp(-0.5 * (d / 0.5) ** 2)
    return torch.where(d.abs() <= 5.0, pdf * 1.25, 0.0)


def flip_beam_target(beam, beamidx, num_beams: int = 64):
    """The horizontal flip's labels: the soft target reversed over beams and
    the index mirrored."""
    import torch
    return torch.flip(beam, dims=(-1,)), (num_beams - 1) - beamidx


# -- horizontal flips (input side) --------------------------------------------

def hflip_image(img):
    """NHWC (or HWC) image: the width axis reversed."""
    import torch
    return torch.flip(img, dims=(-2,))


def hflip_map(m):
    """(..., H, W) radar or LiDAR map: the last (width) axis reversed."""
    import torch
    return torch.flip(m, dims=(-1,))
