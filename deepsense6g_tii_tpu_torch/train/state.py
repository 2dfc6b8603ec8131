"""Train state (``deepsense6g_tii_tpu/train/state.py:20-117``): the model
(its parameters and BatchNorm running statistics), AdamW, the EMA shadow
of the parameters and the step counter.

``torch.optim.AdamW(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)`` over
every parameter is the algebra of optax ``adamw`` that the JAX package
uses: p ← p·(1 − lr·wd) − lr·m̂/(√v̂ + eps), with bias-corrected moments and
the decay on the pre-update weights, applied to all parameters (the
reference's decay/no-decay split is dead code).  The two differ only in the
order of f32 roundings.  The EMA shadow is a dict of f32 tensors keyed by
parameter name, updated as ``decay·e + (1 − decay)·p``.

Over a process group (``mesh``, parallel/mesh.py) the state starts from
rank 0's weights and statistics, broadcast once, and the backbones'
BatchNorms take their statistics over the group; the train step keeps the
ranks equal from there (train/steps.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..parallel.mesh import Mesh, replicate, sync_batchnorm


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Dict[str, torch.Tensor]   # the EMA shadow (== params without EMA)
    step: int = 0   # BatchNorm's running statistics are the model's buffers
    mesh: Optional[Mesh] = None    # the process group the steps reduce over


def make_optimizer(model: nn.Module, weight_decay: float = 0.01,
                   flatten: bool = False,
                   mu_dtype: Optional[str] = None) -> torch.optim.AdamW:
    """AdamW over every parameter of ``model``, learning rate set per step
    (:func:`set_learning_rate`).  ``flatten`` and ``mu_dtype`` are the JAX
    package's TPU memory knobs; the port does not take them."""
    if flatten or mu_dtype is not None:
        raise NotImplementedError(
            "flatten and opt_mu_dtype are TPU memory knobs of the JAX "
            "package's optimizer that the PyTorch port does not take")
    return torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def create_train_state(model: nn.Module, weight_decay: float = 0.01,
                       flatten: bool = False,
                       mu_dtype: Optional[str] = None,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """AdamW over ``model``'s parameters and an EMA shadow that starts as a
    copy of them.  With a ``mesh`` of more than one rank, the model's
    parameters and buffers are rank 0's first (so the EMA shadow, copied
    after, is too) and its BatchNorms sync over the group."""
    replicate(model, mesh)
    sync_batchnorm(model, mesh)
    opt = make_optimizer(model, weight_decay, flatten, mu_dtype)
    ema = {name: p.detach().float().clone()
           for name, p in model.named_parameters()}
    return TrainState(model=model, optimizer=opt, ema=ema, mesh=mesh)


def set_learning_rate(state: TrainState, lr: float) -> None:
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
