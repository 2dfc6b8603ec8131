"""Losses of the modality-rebuild subsystem
(``deepsense6g_tii_tpu/rebuild/losses.py``): NT-Xent over frame-grouped
shared embeddings (temperature 0.1), the negative-MSE distance between
specific embeddings, and the translation MSE.  Plain tensor code in f32.

``group`` (a process group; ``rebuild/trainer.py`` over a mesh): the
inputs are this rank's rows of the global batch, and each function returns
this rank's share of the global batch's loss, so that the ranks' shares add
up to it.  NT-Xent gathers the ranks' normalised rows
(``parallel/distributed.py::all_gather_rows``), computes the global loss L
on every rank and returns L / world; the MSEs sum this rank's squares over
the global element count (the ranks hold equal row counts: the gather
raises otherwise).  Without a group, the single-process code."""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.distributed import all_gather_rows


def _unit_rows(x):
    return x / x.norm(dim=1, keepdim=True).clamp(min=1e-12)


def contrastive_loss(x1, x2, seq_len: int = 5, temperature: float = 0.1,
                     group=None):
    """NT-Xent between two modalities' shared embeddings.

    x1, x2: (B·seq_len, spatial, C).  Sum over spatial, regroup seq_len
    consecutive frames into one row of T·C, L2-normalise, and treat (x1_i,
    x2_i) as the positive pair among the 2B samples.  Over ``group`` the B
    rows are the global batch's, gathered in rank order ([a_all; b_all],
    so the positives lie at ±B as in one process), and the result is this
    rank's share, L / world."""
    a, b = x1.sum(dim=1), x2.sum(dim=1)
    B = a.shape[0] // seq_len
    ua, ub = _unit_rows(a.reshape(B, -1)), _unit_rows(b.reshape(B, -1))
    if group is not None:
        ua, ub = all_gather_rows(ua, group), all_gather_rows(ub, group)
        B = ua.shape[0]
    reps = torch.cat([ua, ub])                                # (2B, T·C)
    sim = reps @ reps.T
    pos = torch.cat([torch.diagonal(sim, B), torch.diagonal(sim, -B)])
    mask = 1.0 - torch.eye(2 * B, dtype=sim.dtype, device=sim.device)
    denom = (mask * torch.exp(sim / temperature)).sum(dim=1)
    loss = (-torch.log(torch.exp(pos / temperature) / denom)).sum() / (2 * B)
    if group is not None:
        loss = loss / dist.get_world_size(group)
    return loss


def _share_of_mean(sq, group):
    """The mean of ``sq`` alone, or over ``group`` this rank's sum over the
    global element count."""
    if group is None:
        return torch.mean(sq)
    return sq.sum() / (sq.numel() * dist.get_world_size(group))


def distance_loss(a, b, group=None):
    """Negative MSE: pushes modality-specific embeddings apart."""
    return -_share_of_mean((a - b) ** 2, group)


def translation_loss(pred, target, group=None):
    return _share_of_mean((pred - target) ** 2, group)
