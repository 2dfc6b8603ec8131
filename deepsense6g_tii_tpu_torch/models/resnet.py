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
    ``BatchNorm(use_running_average=False, momentum=0.9,
    use_fast_variance=True)``: it normalises with the batch mean and the
    biased variance mean(x²) − mean(x)² (floored at 0) over (N, H, W),
    computed in f32, and updates ``running_mean`` and ``running_var`` in
    place with momentum 0.9 and that same biased variance.  The reference
    (torch ``BatchNorm2d``) folds the unbiased variance N/(N-1)·var into
    ``running_var`` instead: a relative drift of about 1/N per update
    (N = B·T·H·W, at least ~160k at full width), a deviation the JAX
    package accepts (its ``resnet.py:24-27``) and the port keeps, so that
    the port and the JAX package agree."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        xf = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=axes)
            var = ((xf * xf).mean(dim=axes) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1.0 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1.0 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


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

    def forward(self, x):
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + residual)


class ResNetStem(nn.Module):
    """conv7x7/2 + BN + relu + maxpool3x3/2: 256x256xC -> 64x64x64."""

    def __init__(self, in_ch: int):
        super().__init__()
        self.conv1 = Conv2d(in_ch, 64, 7, 2, 3)
        self.bn1 = BatchNorm(64)

    def forward(self, x):
        return max_pool_3x3s2(torch.relu(self.bn1(self.conv1(x))))


class ResNetStage(nn.Sequential):
    def __init__(self, in_ch: int, features: int, num_blocks: int,
                 stride: int):
        super().__init__(OrderedDict(
            (f"block{i}", BasicBlock(in_ch if i == 0 else features, features,
                                     stride if i == 0 else 1))
            for i in range(num_blocks)))


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

    def forward(self, x):
        x = self.stem(x)
        for i in range(1, 5):
            x = getattr(self, f"stage{i}")(x)
        return x
