"""Cyclic cosine-decay learning-rate schedule, a pure function of the epoch
(own copy of ``deepsense6g_tii_tpu/train/scheduler.py:16-85``): warmup,
cosine decay, then fixed or geometrically growing warm restarts."""

from __future__ import annotations

import math
from typing import Optional


def cyclic_cosine_decay_lr(
    epoch: int,
    base_lr: float,
    init_decay_epochs: int,
    min_decay_lr: float,
    restart_interval: Optional[int] = None,
    restart_interval_multiplier: Optional[float] = None,
    restart_lr: Optional[float] = None,
    warmup_epochs: Optional[int] = None,
    warmup_start_lr: Optional[float] = None,
) -> float:
    """Learning rate applied during ``epoch`` (0-based)."""
    if init_decay_epochs < 1:
        raise ValueError("init_decay_epochs must be positive integer")
    if restart_interval is not None and restart_interval < 1:
        raise ValueError("restart_interval must be positive integer")
    if restart_interval_multiplier is not None and \
            restart_interval_multiplier <= 0:
        raise ValueError("restart_interval_multiplier must be positive float")
    if warmup_epochs is not None:
        if warmup_epochs < 1:
            raise ValueError("warmup_epochs must be positive integer")
        if warmup_start_lr is None:
            raise ValueError("warmup_start_lr must be set when warmup_epochs "
                             "is not None")
    warm = warmup_epochs or 0

    def calc(t, T, lr, min_lr):
        return min_lr + (lr - min_lr) * ((1 + math.cos(math.pi * t / T)) / 2)

    if warm > 0 and epoch < warm:
        return calc(epoch, warm, warmup_start_lr, base_lr)
    if epoch < init_decay_epochs + warm:
        return calc(epoch - warm, init_decay_epochs, base_lr, min_decay_lr)
    if restart_interval is None:
        return min_decay_lr
    lrs = base_lr if restart_lr is None else restart_lr
    if restart_interval_multiplier is None:
        cycle_epoch = (epoch - init_decay_epochs - warm) % restart_interval
        return calc(cycle_epoch, restart_interval, lrs, min_decay_lr)
    e = epoch - warm - init_decay_epochs
    t = 1 - (1 - restart_interval_multiplier) * e / restart_interval
    n = math.floor(math.log(t, restart_interval_multiplier))
    sn_prev = restart_interval * (1 - restart_interval_multiplier ** n) / (
        1 - restart_interval_multiplier)
    interval = restart_interval * restart_interval_multiplier ** n
    return calc(e - sn_prev, interval, lrs, min_decay_lr)


def reference_recipe_lr(epoch: int, base_lr: float = 1e-4) -> float:
    """The schedule of the reference's winning recipe: 10 warmup epochs from
    2.5e-6, 15 decay epochs to 2.5e-6, restarts every 10 from 12.5e-5."""
    return cyclic_cosine_decay_lr(
        epoch, base_lr=base_lr, init_decay_epochs=15, min_decay_lr=2.5e-6,
        restart_interval=10, restart_lr=12.5e-5, warmup_epochs=10,
        warmup_start_lr=2.5e-6)
