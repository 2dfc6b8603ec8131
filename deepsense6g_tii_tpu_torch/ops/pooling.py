"""Pooling primitives on NHWC tensors
(``deepsense6g_tii_tpu/ops/pooling.py:15-32``).

- ``adaptive_avg_pool``: torch AdaptiveAvgPool2d for divisible sizes (the
  8x8 anchor pooling) as a reshape-mean.
- ``global_avg_pool``: NHWC -> NC.
- ``max_pool_3x3s2``: the ResNet stem max-pool, kernel 3, stride 2, pad 1;
  torch pads max-pool windows with -inf, as flax's ``nn.max_pool`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_avg_pool(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    n, h, w, c = x.shape
    if h % out_h or w % out_w:
        raise ValueError(f"adaptive_avg_pool requires divisible sizes, "
                         f"got {(h, w)} -> {(out_h, out_w)}")
    kh, kw = h // out_h, w // out_w
    return x.reshape(n, out_h, kh, out_w, kw, c).mean(dim=(2, 4))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=3, stride=2,
                     padding=1)
    return y.permute(0, 2, 3, 1)
