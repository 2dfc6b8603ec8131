"""Losses of the modality-rebuild subsystem
(``deepsense6g_tii_tpu/rebuild/losses.py``): NT-Xent over frame-grouped
shared embeddings (temperature 0.1), the negative-MSE distance between
specific embeddings, and the translation MSE.  Plain tensor code in f32."""

from __future__ import annotations

import torch


def _unit_rows(x):
    return x / x.norm(dim=1, keepdim=True).clamp(min=1e-12)


def contrastive_loss(x1, x2, seq_len: int = 5, temperature: float = 0.1):
    """NT-Xent between two modalities' shared embeddings.

    x1, x2: (B·seq_len, spatial, C).  Sum over spatial, regroup seq_len
    consecutive frames into one row of T·C, L2-normalise, and treat (x1_i,
    x2_i) as the positive pair among the 2B samples."""
    a, b = x1.sum(dim=1), x2.sum(dim=1)
    B = a.shape[0] // seq_len
    reps = torch.cat([_unit_rows(a.reshape(B, -1)),
                      _unit_rows(b.reshape(B, -1))])       # (2B, T·C)
    sim = reps @ reps.T
    pos = torch.cat([torch.diagonal(sim, B), torch.diagonal(sim, -B)])
    mask = 1.0 - torch.eye(2 * B, dtype=sim.dtype, device=sim.device)
    denom = (mask * torch.exp(sim / temperature)).sum(dim=1)
    return (-torch.log(torch.exp(pos / temperature) / denom)).sum() / (2 * B)


def distance_loss(a, b):
    """Negative MSE: pushes modality-specific embeddings apart."""
    return -torch.mean((a - b) ** 2)


def translation_loss(pred, target):
    return torch.mean((pred - target) ** 2)
