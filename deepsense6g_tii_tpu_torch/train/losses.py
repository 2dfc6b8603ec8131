"""Classification losses for beam prediction, in f32
(``deepsense6g_tii_tpu/train/losses.py:18-73``): the sigmoid focal loss of
torchvision's ``sigmoid_focal_loss`` (alpha 0.25, gamma 2, mean) on soft
or integer targets, and cross entropy.  ``sample_weight`` (B,) takes
zero-weight rows out of the mean.  ``denom`` replaces the mean's own
denominator with a given one: the weight total of the global batch over
every rank and microbatch (train/steps.py), so that each share of the
batch carries its part of the global mean."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _weighted_mean(per_sample, sample_weight: Optional[torch.Tensor],
                   denom: Optional[torch.Tensor] = None):
    """Mean over the leading sample axis, optionally weighted; over
    ``denom`` (already clamped at 1) when given."""
    if denom is not None:
        if sample_weight is not None:
            per_sample = per_sample * sample_weight.to(per_sample.dtype)
        return per_sample.sum() / denom
    if sample_weight is None:
        return per_sample.mean()
    w = sample_weight.to(per_sample.dtype)
    return (per_sample * w).sum() / w.sum().clamp(min=1.0)


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25,
                       gamma: float = 2.0,
                       sample_weight: Optional[torch.Tensor] = None,
                       denom: Optional[torch.Tensor] = None):
    """Mean sigmoid focal loss over all (sample, class) entries; logits and
    targets (..., num_classes), targets may be soft."""
    logits, targets = logits.float(), targets.float()
    p = torch.sigmoid(logits)
    # numerically stable BCE with logits
    ce = (logits.clamp(min=0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return _weighted_mean(loss.mean(dim=-1), sample_weight, denom)


def focal_loss(logits, target, num_classes: int = 64, alpha: float = 0.25,
               gamma: float = 2.0,
               sample_weight: Optional[torch.Tensor] = None,
               denom: Optional[torch.Tensor] = None):
    """Integer targets are one-hotted; soft (..., C) targets used as-is."""
    if target.dim() == logits.dim() - 1:
        target = F.one_hot(target.long(), num_classes).float()
    return sigmoid_focal_loss(logits, target, alpha=alpha, gamma=gamma,
                              sample_weight=sample_weight, denom=denom)


def cross_entropy_loss(logits, target,
                       sample_weight: Optional[torch.Tensor] = None,
                       denom: Optional[torch.Tensor] = None):
    """torch ``CrossEntropyLoss(reduction='mean')`` on integer or soft
    targets, in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if target.dim() == logits.dim() - 1:
        nll = -logp.gather(-1, target.long()[..., None])[..., 0]
        return _weighted_mean(nll, sample_weight, denom)
    return _weighted_mean(-(target.float() * logp).sum(dim=-1),
                          sample_weight, denom)
