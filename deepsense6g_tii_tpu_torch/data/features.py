"""Image normalisation (``deepsense6g_tii_tpu/data/features.py:233-242``)."""

from __future__ import annotations

import functools

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def _mean_std(device: torch.device, dtype: torch.dtype):
    """The constants on ``device``, made once (outside inference mode) so a
    request copies nothing to the card for them."""
    with torch.inference_mode(False):
        return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
                torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """uint8-scale NHWC image -> ImageNet-normalised float (channel last)."""
    mean, std = _mean_std(x.device, x.dtype)
    return (x / 255.0 - mean) / std
