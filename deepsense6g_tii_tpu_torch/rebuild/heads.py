"""Projection and translation heads of the modality-rebuild subsystem
(``deepsense6g_tii_tpu/rebuild/heads.py``).

The reference's Conv1d(k=1) over the channels of (N, C, spatial) is a
per-position Linear over channels in the (N, spatial, C) layout, and its
BatchNorm1d(C) a BatchNorm over the last axis with statistics over (N,
spatial).  Module names follow the flax scopes (``fc1``, ``bn1``, ``fc2``,
``bn2``, ``fc3``), so ``models/weights.py::from_jax_variables`` maps a JAX
head leaf by leaf.

The heads compute in f32 whatever the features' dtype: flax's ``Dense``
with ``dtype=None`` promotes bf16 features and f32 kernels to f32.  Their
BatchNorms take flax's default momentum, 0.99 (the backbones' is 0.9).
They are ``models/resnet.py::BatchNorm``: with ``.group`` set (by
``parallel/mesh.py::sync_batchnorm``, as the data-parallel
``RebuildTrainer`` does) their train-mode statistics span the process
group's rows, the global batch's as under JAX's mesh.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.resnet import BatchNorm
from ..ops.dropout import dropout

HEAD_BN_MOMENTUM = 0.99   # flax nn.BatchNorm's default


class ProjectHead(nn.Module):
    """in_dim -> hidden -> hidden -> out_dim channels, L2-normalised over
    channels.  The first out_dim/2 channels are the *shared* embedding, the
    rest the *specific* one."""

    def __init__(self, in_dim: int = 64, hidden_dim: int = 64,
                 out_dim: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.bn1 = BatchNorm(hidden_dim, momentum=HEAD_BN_MOMENTUM)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.bn2 = BatchNorm(hidden_dim, momentum=HEAD_BN_MOMENTUM)
        self.fc3 = nn.Linear(hidden_dim, out_dim)

    def forward(self, feat):
        """(N, spatial, in_dim) -> (N, spatial, out_dim) f32, unit-norm."""
        x = torch.relu(self.bn1(self.fc1(feat.float())))
        x = torch.relu(self.bn2(self.fc2(x)))
        x = self.fc3(x)
        return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


class FeatureTrans(nn.Module):
    """Source-shared -> target-feature translator (128 -> 64 channels for
    two sources), with dropout after the second leaky ReLU in train mode."""

    def __init__(self, in_dim: int = 128, hidden: int = 128,
                 out_dim: int = 64, dropout: float = 0.5):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.bn1 = BatchNorm(hidden, momentum=HEAD_BN_MOMENTUM)
        self.fc2 = nn.Linear(hidden, hidden)
        self.bn2 = BatchNorm(hidden, momentum=HEAD_BN_MOMENTUM)
        self.fc3 = nn.Linear(hidden, out_dim)
        self.p = dropout

    def forward(self, feat, generator: Optional[torch.Generator] = None):
        """(N, spatial, in_dim) -> (N, spatial, out_dim) f32.  In train
        mode with p > 0 the dropout mask is drawn from ``generator`` (on the
        features' device)."""
        x = F.leaky_relu(self.bn1(self.fc1(feat.float())), 0.01)
        x = F.leaky_relu(self.bn2(self.fc2(x)), 0.01)
        return self.fc3(dropout(x, self.p, generator, self.training))
