"""Bilinear upsampling with torch ``interpolate(mode='bilinear',
align_corners=False)`` semantics, on NHWC tensors
(``deepsense6g_tii_tpu/ops/resize.py:21-43``).

Kept in the same explicit separable form as the JAX package (two small
interpolation-matrix products, half-pixel centres, clamped edges) so that
parity between the two packages does not rest on ``F.interpolate``
internals.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _interp_matrix(src: int, dst: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """(dst, src) interpolation matrix, half-pixel centres, clamped.

    Cached per device and dtype, so a forward copies no matrix to the
    card once each shape has been seen.  Made outside inference mode, so a
    matrix first made under ``Predictor`` still serves a forward that
    records gradients."""
    x = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    x0 = np.floor(x).astype(np.int64)
    w1 = x - x0
    x0c = np.clip(x0, 0, src - 1)
    x1c = np.clip(x0 + 1, 0, src - 1)
    m = np.zeros((dst, src), dtype=np.float32)
    m[np.arange(dst), x0c] += 1.0 - w1
    m[np.arange(dst), x1c] += w1
    with torch.inference_mode(False):
        return torch.from_numpy(m).to(device, dtype)


def interpolate_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """NHWC -> NH'W'C with H' = H*scale (align_corners=False)."""
    if scale == 1:
        return x
    n, h, w, c = x.shape
    # a trace (torch.export) makes its own matrices, constants of the traced
    # program: cached, its tensors would serve later eager calls
    make = (_interp_matrix.__wrapped__ if torch.compiler.is_compiling()
            else _interp_matrix)
    mh = make(h, h * scale, x.device, x.dtype)
    mw = make(w, w * scale, x.device, x.dtype)
    x = torch.einsum("Hh,nhwc->nHwc", mh, x)
    return torch.einsum("Ww,nhwc->nhWc", mw, x)
