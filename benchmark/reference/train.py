"""The reference's training steps: the sigmoid focal loss on soft targets
(alpha 0.25, gamma 2, mean over classes and rows), the backward, and AdamW
(betas 0.9, 0.999, eps 1e-8, decoupled weight decay on every parameter,
bias-corrected moments), written out here.  The EMA shadow is not
followed: nothing compared reads it.

``half_batch`` plants a fault for the check's own test: the loss is the
mean over the first half of the rows, the rest left out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .model import BeamFuserReference, DropoutDraws


def focal_loss(logits, target, alpha: float = 0.25, gamma: float = 2.0):
    p = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, target, reduction="none")
    p_t = p * target + (1 - p) * (1 - target)
    loss = ce * (1 - p_t) ** gamma
    loss = (alpha * target + (1 - alpha) * (1 - target)) * loss
    return loss.mean(dim=-1).mean()


class AdamW:
    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.01):
        self.params = list(params)
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            p.mul_(1 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = v.sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(m, denom, value=-self.lr / bc1)


def run_steps(cfg: dict, weights: dict, batches, rng_seed: int, lr: float,
              device, quant=None, half_batch: bool = False,
              weight_decay: float = 0.01, dtype=torch.float32):
    """Trains the reference from ``weights`` on ``batches`` (dicts of
    float32 arrays: image, lidar, radar, gps, beam), step s drawing dropout
    as the program's step s does.  Returns the loss of each step, each
    leaf's norm of the first gradient, and each leaf's norm of the change
    after the last step, by parameter name, and the first step's logits.  ``dtype`` float64 serves the
    look at how far float32 rounding alone moves these readings."""
    model = BeamFuserReference(cfg, quant=quant, checkpointed=True).to(
        device, dtype)
    model.load_state_dict({k: v.to(device, dtype)
                           for k, v in weights.items()})
    model.train()
    names, params = zip(*model.named_parameters())
    start = [p.detach().clone() for p in params]
    opt = AdamW(params, lr, weight_decay=weight_decay)
    losses, g1 = [], {}
    for s, b in enumerate(batches):
        x = {k: torch.as_tensor(v).to(device, dtype) for k, v in b.items()}
        if half_batch:
            x = {k: v[:v.shape[0] // 2] for k, v in x.items()}
        for p in params:
            p.grad = None
        draws = DropoutDraws(rng_seed, s, device)
        logits = model(x["image"], x["lidar"], x["radar"], x["gps"], draws)
        loss = focal_loss(logits, x["beam"])
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if s == 0:
            g1 = {n: p.grad.double().norm().item()
                  for n, p in zip(names, params)}
            logits1 = logits.detach().double().cpu().tolist()
        losses.append(loss.item())
        opt.step()
    delta = {n: (p.detach() - p0).double().norm().item()
             for n, p, p0 in zip(names, params, start)}
    return {"losses": losses, "grad_norms": g1, "change_norms": delta,
            "logits1": logits1}
