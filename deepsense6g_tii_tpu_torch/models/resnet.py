"""ResNet backbones with stage-separable structure
(``deepsense6g_tii_tpu/models/resnet.py:23-172``).

The fusion encoder interleaves ResNet stages with cross-modal fusion, so a
backbone exposes ``stem`` and ``stage1..4`` as separately callable
submodules.  Modules take and return NHWC tensors, as the JAX package's do;
each convolution runs on an NCHW view of channels-last memory, so the
permutes are free and cuDNN picks its NHWC kernels.  Convolutions run in
the input's dtype (the configured compute dtype) with f32 weights cast at
call time; BatchNorm computes in f32 before casting back, from its running
statistics in eval mode and from the batch's in train mode (``BatchNorm``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pooling import max_pool_3x3s2
from ..parallel.distributed import all_reduce_sum

BN_EPS = 1e-5
BN_MOMENTUM = 0.9   # flax's convention: new = 0.9 * running + 0.1 * batch
RESNET18_BLOCKS: Tuple[int, ...] = (2, 2, 2, 2)
RESNET34_BLOCKS: Tuple[int, ...] = (3, 4, 6, 3)
STAGE_FEATURES: Tuple[int, ...] = (64, 128, 256, 512)
STAGE_STRIDES: Tuple[int, ...] = (1, 2, 2, 2)


class Conv2d(nn.Module):
    """Bias-free convolution on NHWC tensors; weight (out, in, kh, kw)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """Per-channel (x - mean) * scale / sqrt(var + eps) + bias over the last
    (channel) axis, in f32, output in the input dtype.

    Eval mode uses the running statistics.  Train mode follows flax's
    ``BatchNorm(use_running_average=False, use_fast_variance=True)``: it
    normalises with the batch mean and the biased variance mean(x²) −
    mean(x)² (floored at 0) over every axis but the last ((N, H, W), or
    (N, S) for the rebuild heads), computed in f32, and updates
    ``running_mean`` and ``running_var`` in place with ``momentum`` (new =
    momentum·running + (1 − momentum)·batch) and that same biased variance.
    The backbones keep the JAX package's 0.9; flax's own default, 0.99, is
    what the rebuild heads take (``rebuild/heads.py``).  The reference
    (torch ``BatchNorm2d``) folds the unbiased variance N/(N-1)·var into
    ``running_var`` instead: a relative drift of about 1/N per update
    (N = B·T·H·W, at least ~160k at full width), a deviation the JAX
    package accepts (its ``resnet.py:24-27``) and the port keeps, so that
    the port and the JAX package agree.

    ``mask`` ((N, 1, 1, 1) bool, ``bn_sample_mask``) keeps rows out of the
    train-mode statistics, as flax's ``BatchNorm(mask=...)`` does; every
    row is still normalised.  ``group`` (a process group, set by
    ``parallel/mesh.py::sync_batchnorm``) takes the statistics over every
    rank's rows, as a batch sharded over the JAX mesh does: one all-reduce
    a layer of the masked sum, the masked sum of squares and the count, in
    f32, whose backward all-reduces the gradient.  With neither, the
    statistics are the plain means above."""

    def __init__(self, channels: int, momentum: float = BN_MOMENTUM):
        super().__init__()
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.group = None

    def forward(self, x, mask=None):
        xf = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            if mask is None and self.group is None:
                mean = xf.mean(dim=axes)
                var = ((xf * xf).mean(dim=axes) - mean * mean).clamp(min=0.0)
            else:
                mean, var = _global_stats(xf, mask, self.group)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


def _global_stats(xf, mask, group):
    """The batch mean and biased variance over the rows that ``mask``
    keeps (all without one), summed over ``group``'s ranks."""
    axes = tuple(range(xf.dim() - 1))
    c = xf.shape[-1]
    if mask is not None:
        xf = torch.where(mask, xf, xf.new_zeros(()))
        count = mask.sum() * (xf[0].numel() // c)
    else:
        count = torch.full((), xf.numel() // c, device=xf.device)
    packed = torch.cat([xf.sum(dim=axes), (xf * xf).sum(dim=axes),
                        count.to(torch.float32).reshape(1)])
    if group is not None:
        packed = all_reduce_sum(packed, group)
    n = packed[2 * c]
    mean = packed[:c] / n
    return mean, (packed[c:2 * c] / n - mean * mean).clamp(min=0.0)


def bn_sample_mask(sample_mask, T: int):
    """(B,) row mask (1.0 real, 0.0 padded) -> the (B·T, 1, 1, 1) bool
    BatchNorm mask of a stream that flattens T frames a sample b-major
    (``deepsense6g_tii_tpu/models/resnet.py:31-37``)."""
    return sample_mask.bool().repeat_interleave(T)[:, None, None, None]


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, stride, 1)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, 1, 1)
        self.bn2 = BatchNorm(features)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or in_ch != features:
            self.downsample_conv = Conv2d(in_ch, features, 1, stride, 0)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x, mask=None):
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x), mask)
        y = torch.relu(self.bn1(self.conv1(x), mask))
        y = self.bn2(self.conv2(y), mask)
        return torch.relu(y + residual)


class ResNetStem(nn.Module):
    """conv7x7/2 + BN + relu + maxpool3x3/2: 256x256xC -> 64x64x64."""

    def __init__(self, in_ch: int):
        super().__init__()
        self.conv1 = Conv2d(in_ch, 64, 7, 2, 3)
        self.bn1 = BatchNorm(64)

    def forward(self, x, mask=None):
        return max_pool_3x3s2(torch.relu(self.bn1(self.conv1(x), mask)))


class ResNetStage(nn.Sequential):
    def __init__(self, in_ch: int, features: int, num_blocks: int,
                 stride: int):
        super().__init__(OrderedDict(
            (f"block{i}", BasicBlock(in_ch if i == 0 else features, features,
                                     stride if i == 0 else 1))
            for i in range(num_blocks)))

    def forward(self, x, mask=None):
        for block in self:
            x = block(x, mask)
        return x


class ResNetBackbone(nn.Module):
    """torchvision-shaped ResNet without its head; ``stem`` and
    ``stage1..4`` are separately callable."""

    def __init__(self, in_ch: int, blocks: Sequence[int] = RESNET18_BLOCKS):
        super().__init__()
        self.stem = ResNetStem(in_ch)
        widths = (64,) + STAGE_FEATURES
        for i in range(4):
            self.add_module(f"stage{i + 1}", ResNetStage(
                widths[i], STAGE_FEATURES[i], blocks[i], STAGE_STRIDES[i]))

    def forward(self, x, mask=None):
        x = self.stem(x, mask)
        for i in range(1, 5):
            x = getattr(self, f"stage{i}")(x, mask)
        return x
